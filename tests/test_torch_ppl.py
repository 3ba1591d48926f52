"""The port's perplexity harness (pie_tpu_torch/tools/ppl.py) on a tiny
random model: tests/test_ppl.py's four tests (one window against a
cross-entropy computed by hand, several windows, INT8 close to the dense
weights, the MLX-layout round trip) on the port, and ``window_nll`` equal
to the JAX harness's (scripts/ppl.py) on the same weights."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
from pie_tpu_torch.tools import ppl as ppl_mod

from test_torch_llama import jax_to_np

TINY = dict(
    model_type="llama", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
    tie_word_embeddings=False,
)


@pytest.fixture(scope="module")
def jax_tiny():
    model = JModel(JConfig.from_dict(TINY))
    return model, model.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def tiny(jax_tiny):
    """The port's model on the JAX weights (f32, CPU)."""
    return LlamaModel(LlamaConfig.from_dict(TINY)), from_jax_params(
        jax_to_np(jax_tiny[1]), "cpu")


def test_ppl_matches_direct_crossentropy(tiny):
    """compute_ppl over one window == exp(mean nll) computed by hand."""
    from pie_tpu_torch.cache.kv_cache import make_kv_cache

    model, params = tiny
    ids = np.random.default_rng(0).integers(1, 250, size=33).astype(np.int64)
    got = ppl_mod.compute_ppl(model, params, ids, seq_len=33)
    cfg, t = model.config, len(ids)
    cache = make_kv_cache(cfg.num_hidden_layers, 1, t, cfg.num_key_value_heads,
                          cfg.resolved_head_dim, dtype=torch.bfloat16, device="cpu")
    cache = cache.advance(torch.zeros((1,), dtype=torch.int32), t)
    logits, _ = model(params, torch.from_numpy(ids)[None], cache,
                      torch.arange(t, dtype=torch.int32)[None])
    logp = torch.log_softmax(logits[0, :-1].to(torch.float64), dim=-1).numpy()
    want = float(np.exp(-logp[np.arange(t - 1), ids[1:]].mean()))
    assert got == pytest.approx(want, rel=1e-4)


def test_ppl_windows_consistent(tiny):
    """Several windows aggregate nll / count across them."""
    model, params = tiny
    ids = np.random.default_rng(1).integers(1, 250, size=64).astype(np.int64)
    full = ppl_mod.compute_ppl(model, params, ids, seq_len=16)
    assert np.isfinite(full) and full > 1.0
    # the windows' own nll sums add up to the stream's
    parts = [ppl_mod.window_nll(model, params, torch.from_numpy(ids[s:s + 16])[None],
                                torch.tensor([16])) for s in range(0, 64, 16)]
    nll = sum(float(p[0]) for p in parts) / sum(int(p[1]) for p in parts)
    assert full == pytest.approx(float(np.exp(nll)), rel=1e-6)


def test_quantized_ppl_close_and_ordered(tiny):
    """INT8 perplexity is close to the dense weights' (random tiny models
    have no redundancy, so the bound is loose: the point is the path)."""
    model, params = tiny
    ids = np.random.default_rng(2).integers(1, 250, size=128).astype(np.int64)
    p_dense = ppl_mod.compute_ppl(model, params, ids, seq_len=64)
    p_int8 = ppl_mod.compute_ppl(model, ppl_mod.quantize_variant(model, params, "int8"),
                                 ids, seq_len=64)
    assert abs(p_int8 - p_dense) / p_dense < 0.05
    with pytest.raises(ValueError):
        ppl_mod.quantize_variant(model, params, "int3")


def test_mlx_layout_roundtrip_identical_ppl(tiny):
    """INT4 through MLX's packing gives the same codes, and the same scales
    and biases over the real groups, as quantize_params (unfused), hence
    the same perplexity. (The groups that pad K to 512 differ: zero scales
    from the MLX side, a unit scale from the quantizer's constant groups;
    both multiply zero codes and zero x.)"""
    model, params = tiny
    ids = np.random.default_rng(3).integers(1, 250, size=96).astype(np.int64)
    q_direct = model.quantize_params(params, 64, 4, fuse_projections=False)
    q_mlx = ppl_mod.mlx_roundtrip_params(model, params, 64, 4)
    for name in model.LINEAR_KEYS:
        a, b = q_mlx["layers"][name], q_direct["layers"][name]
        groups = a.shape[0] // 64
        assert torch.equal(a.packed, b.packed)
        assert torch.equal(a.scales[:, :groups], b.scales[:, :groups])
        assert torch.equal(a.biases[:, :groups], b.biases[:, :groups])
    p_direct = ppl_mod.compute_ppl(model, q_direct, ids, seq_len=48)
    p_mlx = ppl_mod.compute_ppl(model, q_mlx, ids, seq_len=48)
    assert p_mlx == pytest.approx(p_direct, rel=1e-6)


def test_quantize_mlx_layout_matches_jax():
    """The port's MLX-layout quantizer gives JAX's words, scales, biases."""
    from pie_tpu.ops import quant as jq
    from pie_tpu_torch.ops import quant as tq

    w = np.random.default_rng(4).standard_normal((96, 512)).astype(np.float32)
    for bits in (4, 8):
        want = jq.quantize_mlx_layout(jnp.asarray(w), 64, bits)
        got = tq.quantize_mlx_layout(torch.from_numpy(w), 64, bits)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).view(np.int32))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("quantized", [False, True])
def test_window_nll_matches_jax(jax_tiny, tiny, quantized):
    """window_nll of the port == the JAX harness's on the same weights
    (dense f32, and INT4 g64 carried over from JAX's quantizer), over a
    padded batch of two windows."""
    spec = importlib.util.spec_from_file_location(
        "jax_ppl", pathlib.Path(__file__).parent.parent / "scripts" / "ppl.py")
    jppl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jppl)
    jm, jp = jax_tiny
    model, params = tiny
    if quantized:
        jp = jm.quantize_params(jp, group_size=64, bits=4)
        params = from_jax_params(jax_to_np(jp), "cpu")
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 250, size=(2, 40)).astype(np.int32)
    lens = np.array([40, 27], np.int32)
    want_nll, want_cnt = jppl.window_nll(jm, jp, jnp.asarray(ids), jnp.asarray(lens))
    got_nll, got_cnt = ppl_mod.window_nll(model, params, torch.from_numpy(ids),
                                          torch.from_numpy(lens))
    assert int(got_cnt) == int(want_cnt) == 39 + 26
    assert float(got_nll) == pytest.approx(float(want_nll), rel=2e-3 if quantized else 1e-5)
