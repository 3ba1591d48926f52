"""The port's quantization and quantized matmul (pie_tpu_torch.ops) against
the JAX package: round trips, carrying weights across, the plain version
against the XLA path and against the Pallas kernel in interpret mode.
The CUDA kernels are held against the plain version in
tests/test_torch_kernels.py (card only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.ops import quant as jq
from pie_tpu.ops.quant_matmul_pallas import quant_matmul_pallas, quant_matmul_stacked
from pie_tpu.ops.rope import make_inv_freq as j_inv_freq
from pie_tpu.ops.rope import rope_qkv_cs as j_rope_qkv_cs
from pie_tpu_torch.models.llama import from_jax_params
from pie_tpu_torch.ops import quant as tq
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.ops.rope import rope_qkv_cs as t_rope_qkv_cs


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_qt(qt):
    """JAX QuantizedTensor -> the dict form ``from_jax_params`` takes."""
    return dict(packed=np.asarray(qt.packed), scales=np.asarray(qt.scales),
                biases=np.asarray(qt.biases), bits=qt.bits,
                group_size=qt.group_size, shape=qt.shape)


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# -- format -------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group_size", [32, 64, 128])
def test_roundtrip_error_bound(bits, group_size):
    k, n = 512, 256
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((k, n)).astype(np.float32))
    qt = tq.quantize(w, group_size=group_size, bits=bits)
    w2 = tq.dequantize(qt, dtype=torch.float32)
    assert w2.shape == (k, n)
    grp = w.reshape(k // group_size, group_size, n)
    step = (grp.amax(1) - grp.amin(1)) / (2**bits - 1)
    err = (w - w2).abs().reshape(k // group_size, group_size, n)
    assert bool((err <= step[:, None, :] * 0.51).all())


def test_pack_unpack_identity():
    rng = np.random.default_rng(0)
    for bits in (4, 8):
        q = torch.from_numpy(rng.integers(0, 2**bits, size=(1024, 128)).astype(np.int32))
        packed = tq.pack_codes(q, bits)
        assert packed.dtype == torch.int32
        assert packed.shape == (1024 // (32 // bits), 128)
        assert torch.equal(tq.unpack_codes(packed, bits), q)


def test_degenerate_group_exact():
    qt = tq.quantize(torch.full((512, 128), 3.25), 64, 4)
    assert torch.allclose(tq.dequantize(qt, torch.float32), torch.tensor(3.25),
                          rtol=0, atol=1e-6)


def test_k_padding():
    k, n = 320, 128
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    qt = tq.quantize(w, 64, 4)
    assert qt.shape == (k, n) and qt.padded_k == 512
    x = torch.from_numpy(rng.standard_normal((4, k)).astype(np.float32))
    y = tq.quantized_matmul(x, qt)
    y_ref = x @ tq.dequantize(qt, torch.float32)
    assert _norm_err(y, y_ref) < 0.02


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group_size", [32, 64, 128])
def test_quantize_and_converter_match_jax(bits, group_size):
    """Same codes as the JAX quantizer; weights carried across from the
    JAX layout dequantize to exactly JAX's weights (stacked and not)."""
    w = np.random.default_rng(2).standard_normal((2, 640, 256)).astype(np.float32)
    qj = jax.vmap(lambda m: jq.quantize(m, group_size, bits))(jnp.asarray(w))
    want = np.asarray(jq.dequantize(qj, jnp.float32))
    qt = from_jax_params(_np_qt(qj), "cpu")
    np.testing.assert_array_equal(tq.dequantize(qt, torch.float32).numpy(), want)
    np.testing.assert_array_equal(
        tq.dequantize(qt.layer(1), torch.float32).numpy(), want[1]
    )
    own = tq.quantize(torch.from_numpy(w), group_size, bits)
    np.testing.assert_array_equal(tq.dequantize(own, torch.float32).numpy(), want)


def test_mlx_layout_conversion():
    n, k = 96, 512
    w_nk = jnp.asarray(np.random.default_rng(3).standard_normal((n, k)), jnp.float32)
    packed, scales, biases = jq.quantize_mlx_layout(w_nk, 64, 4)
    want = np.asarray(jq.dequantize(jq.from_mlx_layout(packed, scales, biases, 64, 4),
                                    jnp.float32))
    qt = tq.from_mlx_layout(
        torch.from_numpy(np.array(packed).view(np.int32)),
        torch.from_numpy(np.array(scales)), torch.from_numpy(np.array(biases)),
        64, 4,
    )
    np.testing.assert_array_equal(tq.dequantize(qt, torch.float32).numpy(), want)


# -- matmul: plain version against the JAX package ------------------------------


def _stacked_case(bits, g, hq, hkv, dh, k, seed):
    n = (hq + 2 * hkv) * dh
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((2, k, n)).astype(np.float32) * 0.05
    qj = jax.vmap(lambda m: jq.quantize(m, g, bits))(jnp.asarray(w))
    lnw = (1.0 + 0.1 * rng.standard_normal((2, k))).astype(np.float32)
    return qj, from_jax_params(_np_qt(qj), "cpu"), lnw, n


@pytest.mark.parametrize("variant", ["plain", "ln", "rope64", "rope128", "ln_rope128"])
def test_ref_matches_jax_xla(variant):
    """The port's plain version == JAX quantized_matmul(impl="xla") (same
    math, different summation order): normalized max error < 1e-4."""
    dh = 64 if variant == "rope64" else 128
    hq, hkv, k, m = 4, 2, 512, 5
    qj, qt, lnw, n = _stacked_case(4, 64, hq, hkv, dh, k, seed=4)
    x = np.random.default_rng(5).standard_normal((m, k)).astype(np.float32)
    pos = np.array([3, 9, 17, 40, 100], np.int32)
    kw_j, kw_t = {}, {}
    if "ln" in variant:
        kw_j.update(ln_w=jnp.asarray(lnw), ln_eps=1e-5)
        kw_t.update(ln_w=torch.from_numpy(lnw), ln_eps=1e-5)
    if "rope" in variant:
        inv = j_inv_freq(dh, 500000.0)
        kw_j.update(rope_cs=j_rope_qkv_cs(jnp.asarray(pos), jnp.asarray(inv), hq, hkv, dh),
                    rope_dim=dh)
        kw_t.update(rope_cs=t_rope_qkv_cs(torch.from_numpy(pos), torch.from_numpy(inv),
                                          hq, hkv, dh), rope_dim=dh)
    want = jq.quantized_matmul(jnp.asarray(x), qj, impl="xla", layer=1, **kw_j)
    got = tq.quantized_matmul(torch.from_numpy(x), qt, layer=1, **kw_t)
    assert got.shape == (m, n)
    assert _norm_err(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("m", [1, 8, 16, 32])
@pytest.mark.parametrize("group_size", [64, 128])
def test_ref_matches_pallas_decode_branch(m, group_size):
    """Decode branch of the TPU kernel (M = 1-32, the rows K1 serves; ln
    prologue + rope epilogue, stacked, interpret mode) against the port's
    plain version: normalized max error < 0.025, the JAX package's own
    kernel tolerance."""
    hq, hkv, dh, k = 4, 2, 64, 512
    qj, qt, lnw, n = _stacked_case(4, group_size, hq, hkv, dh, k, seed=6)
    x = np.random.default_rng(7).standard_normal((m, k)).astype(np.float32)
    pos = np.arange(m, dtype=np.int32) * 7 + 3
    inv = j_inv_freq(dh, 500000.0)
    want = quant_matmul_stacked(
        jnp.asarray(x), jnp.int32(1), qj, ln_w=jnp.asarray(lnw), ln_eps=1e-5,
        rope_cs=j_rope_qkv_cs(jnp.asarray(pos), jnp.asarray(inv), hq, hkv, dh),
        rope_dim=dh, interpret=True,
    )
    got = qmc.quant_matmul_ref(
        torch.from_numpy(x), qt, layer=1, ln_w=torch.from_numpy(lnw), ln_eps=1e-5,
        rope_cs=t_rope_qkv_cs(torch.from_numpy(pos), torch.from_numpy(inv), hq, hkv, dh),
        rope_dim=dh,
    )
    assert _norm_err(got.numpy(), want) < 0.025


@pytest.mark.parametrize("bits,group_size", [(4, 64), (8, 32)])
def test_ref_matches_pallas_prefill_branch(bits, group_size):
    """Prefill branch of the TPU kernel (M = 40, unstacked, interpret
    mode) against the port's plain version (< 0.025)."""
    k, n, m = 1024, 256, 40
    rng = np.random.default_rng(8)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qj = jq.quantize(jnp.asarray(w), group_size, bits)
    want = quant_matmul_pallas(jnp.asarray(x), qj, interpret=True)
    got = qmc.quant_matmul_ref(torch.from_numpy(x), from_jax_params(_np_qt(qj), "cpu"))
    assert _norm_err(got.numpy(), want) < 0.025


def test_cpu_tensors_never_launch_kernels():
    qmc.reset_counts()
    qt = tq.quantize(torch.randn(512, 128), 64, 4)
    tq.quantized_matmul(torch.randn(1, 512), qt)
    tq.quantized_matmul(torch.randn(40, 512), qt)
    assert qmc.launch_counts == {"K1": 0, "K1 ln": 0, "K2": 0, "K3": 0, "K4": 0}


def test_stacked_needs_layer():
    qt = tq.quantize(torch.randn(2, 512, 128), 64, 4)
    with pytest.raises(ValueError):
        tq.quantized_matmul(torch.randn(1, 512), qt)


_BAD_LAYOUTS = {
    "packed_dtype": lambda qt: dict(packed=qt.packed.to(torch.int64)),
    "packed_k_unpadded": lambda qt: dict(packed=qt.packed[:, :40]),
    "scales_shape": lambda qt: dict(scales=qt.scales[:, :4]),
    "biases_dtype": lambda qt: dict(biases=qt.biases.to(torch.float64)),
    "not_contiguous": lambda qt: dict(
        scales=qt.scales.t().contiguous().t(), biases=qt.biases.t().contiguous().t()
    ),
    "bits": lambda qt: dict(bits=2),
}


@pytest.mark.parametrize("bad", list(_BAD_LAYOUTS))
def test_quantized_tensor_checks_its_layout(bad):
    """The layout the kernels rely on is checked where a QuantizedTensor is
    built, so a malformed one never reaches a wrapper."""
    import dataclasses

    qt = tq.quantize(torch.randn(512, 128), 64, 4)
    with pytest.raises(ValueError):
        dataclasses.replace(qt, **_BAD_LAYOUTS[bad](qt))
    assert dataclasses.replace(qt).shape == (512, 128)  # the valid one builds
