"""The readers over synthetic runs worked out by hand: the image cell's two
host-clock metrics, and the device-trace readers over a slice that holds a
mixed step (32 lanes and a rider slice through K2) and a tower call."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT
from portbench import counts, harness, kit, readers

CFG = json.loads((ROOT / "portbench/configs/qwen2.5-vl-7b-vision.json").read_text())
QWEN = kit.load("portbench/kits/qwen2_5_vl.py")
IMG = {"pixel_values": None, "image_kwargs": {"grid_thw": [[1, 16, 16]]}}


def _rec(i, due, times, extras=None):
    return harness.Record(i, [1, 2, 3], len(times), due, sent=due, times=list(times),
                          tokens=[5] * len(times), finished=times[-1] if times else None,
                          extras=extras or {})


def _run(records, trace=None):
    return harness.Run(CFG, {}, 10.0, 1.0, 0.0, 10.0, records, 32, {"steps": 1},
                       trace=trace or {}, kit=QWEN)


def test_image_ttft_reads_the_requests_with_images_alone():
    recs = [_rec(0, 1.0, [1.1, 1.2]), _rec(1, 2.0, [2.5, 2.6], IMG),
            _rec(2, 3.0, [3.3], IMG), _rec(3, 4.0, [4.9], IMG),
            _rec(4, 9.5, [], IMG),  # no token by the close: its wait so far, 0.5 s
            _rec(5, 11.0, [11.5], IMG)]  # due after the close
    assert readers.image_ttft_ms(_run(recs), 50) == pytest.approx(500.0)
    assert readers.image_ttft_ms(_run(recs[:1]), 50) is None


def test_token_gaps_are_every_requests_consecutive_tokens_in_the_window():
    recs = [_rec(0, 0.0, [1.0, 1.1, 1.3, 1.35]), _rec(1, 0.5, [2.0, 2.5]),
            _rec(2, 9.0, [9.8, 10.4, 10.5])]  # the last two after the close
    gaps = sorted(readers.token_gaps(_run(recs)))
    assert gaps == pytest.approx([0.05, 0.1, 0.2, 0.5])
    assert readers.token_gap_ms(_run(recs), 100) == pytest.approx(500.0)
    assert readers.token_gap_ms(_run([_rec(0, 0.0, [1.0])]), 99) is None


#: a decode chunk of 8 steps, 3 of them mixed (rider slices of 248, 248 and
#: 100 tokens beside the 32 lanes), every lane at a 1,000-token context
CHUNK = dict(steps=8, rider_tokens=[248, 248, 100, 0, 0, 0, 0, 0],
             ctxs=[[1000] * 32] * 8, in_slice=True)
TOWER = dict(grid_thw=[[1, 72, 72]], in_slice=True)


def _trace(k1=0.0, k2=0.0, k3=0.0, busy=1.0):
    return dict(window_s=2.0, busy_s=busy, chunks=[CHUNK], prefills=[], towers=[TOWER],
                kernels={"void gemv_kernel<4>(int)": k1, "void gemm_kernel<4>(int)": k2,
                         "void paged_attention_kernel<128>(int)": k3,
                         "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n": 0.5})


def test_k2_counts_a_mixed_steps_lanes_and_rider():
    per_layer = 3584 * 3584 * 2 + 3584 * 512 * 2 + 3584 * 18944 * 3
    work = 0.0
    for rider in (248, 248, 100):
        rows = 32 + rider  # M = 280 at a full slice
        ops = 2 * rows * 28 * per_layer
        byts = counts.gemm_work(counts.layers_shapes(CFG), rows)[0]
        work += max(ops / counts.BF16_FLOP_PER_S, byts / counts.HBM_BYTES_PER_S)
    assert readers.k2_roofline(_run([], _trace(k2=0.1))) == pytest.approx(100 * work / 0.1)


def test_k1_counts_the_mixed_steps_head_and_the_others_whole():
    full = counts.bound_s(*counts.decode_pass(CFG, 32))
    head = counts.bound_s(*counts.gemm_work([(3584, 152064)], 32))
    assert readers.k1_roofline(_run([], _trace(k1=0.1))) == pytest.approx(
        100 * (5 * full + 3 * head) / 0.1)


def test_k3_counts_every_steps_lanes():
    one = counts.bound_s(*counts.attention_step(CFG, [1000] * 32))
    assert readers.k3_roofline(_run([], _trace(k3=0.1))) == pytest.approx(100 * 8 * one / 0.1)


def test_a_tower_calls_flops_by_hand():
    d, di, n = 1280, 3420, 72 * 72
    blocks = 32 * 2 * n * (4 * d * d + 3 * d * di)
    windows = 81 * 64 ** 2  # 36 x 36 merge units in 4 x 4-unit windows
    attn = 4 * d * (28 * windows + 4 * n ** 2)
    merger = 2 * (n // 4) * (5120 * 5120 + 5120 * 3584)
    assert QWEN.call_flops(CFG, TOWER) == 2 * n * 1176 * d + blocks + attn + merger
    # ragged: 5 x 7 merge units in windows of 16, 12, 4 and 3 units
    ragged = QWEN.tower_flops(CFG["vision_config"], (1, 10, 14))
    assert ragged - QWEN.tower_flops(dict(CFG["vision_config"], fullatt_block_indexes=[]),
                                     (1, 10, 14)) == 4 * 4 * d * (140 ** 2 - 6800)


def test_mfu_adds_the_tower_and_stays_under_its_bound():
    tr = _trace()
    dense = kit.load(kit.DEFAULT)
    flops = (8 * 32 * dense.decode_token_flops(CFG, 1000)
             + sum(dense.rider_flops(CFG, r) for r in CHUNK["rider_tokens"])
             + QWEN.call_flops(CFG, TOWER))
    assert readers.mfu_pct(_run([], tr)) == pytest.approx(100 * flops / counts.BF16_FLOP_PER_S)
    # busy for no less than the work's least time at the peak: at most 100 %
    tr["busy_s"] = flops / counts.BF16_FLOP_PER_S
    assert readers.mfu_pct(_run([], tr)) == pytest.approx(100.0)
