"""The benchmark's count functions against hand counts at both
configurations' shapes, and against the bounds PERF.md's kernel table
gives at the Llama-3-8B shapes."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import counts

BENCH = Path(__file__).resolve().parents[1]
LLAMA_8B = dict(hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=8, vocab_size=128256)


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_hand_counts_qwen():
    cfg = _cfg("qwen2.5-vl-7b")
    per_layer = 3584 * 3584 * 2 + 3584 * 512 * 2 + 3584 * 18944 * 3
    assert counts.layer_params(cfg) == 28 * per_layer
    byts, ops = counts.decode_pass(cfg, 1)
    weights = 28 * per_layer + 3584 * 152064
    # INT4 codes (half a byte) + a bf16 scale and minimum per 64 rows
    assert byts == pytest.approx(weights * (0.5 + 4 / 64)
                                 + 2 * (28 * (3584 * 4 + 512 * 2 + 18944 * 2 + 3584 * 2
                                              + 3584 * 2 + 18944 + 3584)
                                        + 3584 + 152064))
    assert ops == 2 * weights


def test_hand_counts_mistral():
    cfg = _cfg("mistral-7b-v0.3")
    per_layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 4096 * 14336 * 3
    assert counts.layer_params(cfg) == 32 * per_layer
    b, o = counts.attention_step(cfg, [100, 300])
    assert b == 32 * (400 * 8 * (2 * 128 + 8) + 2 * 32 * 128 * 4)
    assert o == 32 * 4 * 400 * 32 * 128
    assert counts.decode_token_flops(cfg, 10) == (
        2 * (32 * per_layer + 4096 * 32768) + 32 * 4 * 10 * 32 * 128)
    pos = [5, 6, 7]
    assert counts.prefill_flops(cfg, pos) == 2 * 32 * per_layer * 3 + 32 * 4 * 32 * 128 * 21


def test_k1_and_k3_bytes_match_the_kernel_table_at_8b():
    # PERF.md's kernel table: K1 at the 8B, M = 1: 1.262 ms (bytes bound),
    # M = 32: 1.320; K3 at 8 lanes x 2,048 INT8 tokens: 0.332 ms
    k1_m1 = counts.bound_s(*counts.decode_pass(LLAMA_8B, 1))
    k1_m32 = counts.bound_s(*counts.decode_pass(LLAMA_8B, 32))
    k3 = counts.bound_s(*counts.attention_step(LLAMA_8B, [2048] * 8))
    assert k1_m1 * 1e3 == pytest.approx(1.262, rel=0.01)
    assert k1_m32 * 1e3 == pytest.approx(1.320, rel=0.01)
    assert k3 * 1e3 == pytest.approx(0.332, rel=0.01)


def test_k2_is_compute_bound_at_a_full_prefill_chunk():
    cfg = _cfg("qwen2.5-vl-7b")
    byts, ops = counts.prefill_pass(cfg, 256)
    assert ops / counts.BF16_FLOP_PER_S > byts / counts.HBM_BYTES_PER_S
    # PERF.md's kernel table: Qwen's 512-token prefill through K2, head
    # included (the single-stream prefill unembeds; the paged one does not),
    # ops bound 7.321 ms
    _, layers = counts.prefill_pass(cfg, 512)
    _, head = counts.gemm_work([counts.head_shape(cfg)], 512)
    assert (layers + head) / counts.BF16_FLOP_PER_S * 1e3 == pytest.approx(7.321, rel=0.01)
