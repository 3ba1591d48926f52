"""The arithmetic of K4 (``pie_tpu_torch/csrc/fused_mlp.cu``, the decode MLP
block in one launch), emulated step by step in plain PyTorch on the CPU and
held against the JAX package's ``fused_mlp_stacked`` (Pallas, interpret
mode) and the port's ``fused_mlp_ref`` on the same weights.

K4 itself runs only on a card (``tests/test_torch_kernels.py``). What can go
wrong in its numbers is decided by where it rounds and in what order it
sums, and that is what the emulation repeats, phase by phase, with the
tiles and K splits of ``mlp_plan``:

- each dot on the exact codes: per group of g rows, the products x . q
  summed in f32 (the tensor cores), then folded into the running sum as
  ``acc = fma(s, part, fma(b, sum(x), acc))`` in f32 (the decode branch's
  post-scale; ``sum(x)`` from 32-row chunk sums), group after group over a
  split's stages;
- the splits' f32 partials summed in split order;
- h2 = bf16(h_in + bf16(y)); each row's sum of f32(h2)^2 per 128-feature
  wo tile, the tiles summed in order; xg = bf16(h2 * inv * ln2);
- act = bf16(silu(bf16 g) * bf16 u); out = bf16(h2 + bf16(y)).

Held at 0.02 * max|ref|, the tolerance of ``tests/test_torch_fused_mlp.py``
(D 2048, DI 4096, two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.ops import fused_mlp_pallas as jf
from pie_tpu.ops.quant import quantize as jquantize
from pie_tpu_torch.models.llama import from_jax_params
from pie_tpu_torch.ops import fused_mlp as tf
from pie_tpu_torch.ops.quant import unpack_codes

from test_torch_llama import jax_to_np

D, DI, L, EPS, G = 2048, 4096, 2, 1e-5, 64
TOL = 0.02
CASES = [(4, 8, 1), (8, 3, 0)]  # (bits, M, layer)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    """Weights of both packages per bit width, inputs, and the JAX kernel's
    output for every case."""
    rng = np.random.default_rng(3)
    dense = {
        "wo": rng.standard_normal((L, D, D), np.float32) * 0.02,
        "wgu": rng.standard_normal((L, D, 2 * DI), np.float32) * 0.02,
        "wd": rng.standard_normal((L, DI, D), np.float32) * 0.02,
    }
    ln2 = np.abs(rng.standard_normal((L, D), np.float32)).astype(jnp.bfloat16)
    attn = rng.standard_normal((8, D), np.float32).astype(jnp.bfloat16)
    h = rng.standard_normal((8, D), np.float32).astype(jnp.bfloat16)
    out = {"ln2": ln2, "attn": attn, "h": h, "port": {}, "jax": {}}
    for bits in sorted({b for b, _, _ in CASES}):
        jw = {k: jax.vmap(lambda w: jquantize(w, G, bits))(jnp.asarray(w))
              for k, w in dense.items()}
        out["port"][bits] = {k: from_jax_params(jax_to_np(w), "cpu") for k, w in jw.items()}
        for b, m, layer in CASES:
            if b == bits:
                got = jf.fused_mlp_stacked(
                    jnp.asarray(attn[:m]), jnp.asarray(h[:m]), jnp.asarray(ln2[layer]),
                    jnp.int32(layer), jw["wo"], jw["wgu"], jw["wd"], eps=EPS,
                    interpret=True)
                out["jax"][(bits, m, layer)] = np.asarray(got, np.float32)
    return out


def _f32(t):
    return t.to(torch.float32)


def _bf(t):
    """Round an f32 tensor to bf16 and back."""
    return t.to(torch.bfloat16).to(torch.float32)


def _fma(a, b, c):
    """f32 fma: the product exact in f64, one rounding to f32."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def phase_dot(x, qt, layer, phase):
    """K4's y = x @ W of one phase in f32: per-group post-scaled sums over
    each split's stages, the splits' partials summed in split order.
    x [M, K] f32 holding bf16 values."""
    q = unpack_codes(qt.packed[layer], qt.bits).double()  # [K, N] exact codes
    s, b = _f32(qt.scales[layer]), _f32(qt.biases[layer])  # [K / g, N]
    g = qt.group_size
    m, k = x.shape
    xd = x.double()
    chunk = xd.reshape(m, k // 32, 32).sum(-1).to(torch.float32)  # 32-row x sums
    sx = chunk.reshape(m, k // g, g // 32).sum(-1)  # per group, f32 adds
    part = torch.einsum("mgr,grn->mgn", xd.reshape(m, k // g, g),
                        q.reshape(k // g, g, -1)).to(torch.float32)  # f32 x . q
    groups_per_stage = tf.STAGE_K // g
    total = None
    for split in range(phase.splits):
        acc = torch.zeros((m, q.shape[1]), dtype=torch.float32)
        for stage in phase.split_stages(split):
            for gi in range(stage * groups_per_stage, (stage + 1) * groups_per_stage):
                acc = _fma(s[gi], part[:, gi], _fma(b[gi], sx[:, gi:gi + 1], acc))
        total = acc if total is None else total + acc
    return total


def k4_emulate(attn, h_in, ln2_row, layer, wo, wgu, wd, plan, eps=EPS):
    """K4's output [M, d] (f32 holding bf16 values), phase by phase."""
    po, pg, pd = plan.phases
    y = phase_dot(_f32(attn), wo, layer, po)
    h2 = _bf(_f32(h_in) + _bf(y))
    m, d = h2.shape
    ss = (h2 * h2).reshape(m, d // tf.TILE_N, tf.TILE_N).sum(-1)  # per wo tile
    inv = torch.rsqrt(ss.sum(-1, keepdim=True) / d + eps)
    xg = _bf(h2 * inv * _f32(ln2_row))
    gu = phase_dot(xg, wgu, layer, pg)
    di = gu.shape[1] // 2
    g, u = _bf(gu[:, :di]), _bf(gu[:, di:])
    act = _bf(g * torch.sigmoid(g) * u)
    return _bf(h2 + _bf(phase_dot(act, wd, layer, pd)))


def _inputs(block, m, layer):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t(block["attn"][:m]), t(block["h"][:m]), t(block["ln2"][layer])


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("bits,m,layer", CASES)
def test_emulation_matches_jax_kernel_and_plain(block, bits, m, layer, sms):
    """The emulation, with the K splits mlp_plan gives an H100 (132 SMs)
    and a 16-SM card, against the JAX kernel in interpret mode and against
    fused_mlp_ref, within 0.02 of max|ref|."""
    attn, h, ln2 = _inputs(block, m, layer)
    w = block["port"][bits]
    plan = tf.mlp_plan(m, D, D, DI, bits, G, sms=sms)
    assert any(p.splits > 1 for p in plan.phases)  # the split sums are exercised
    got = k4_emulate(attn, h, ln2, layer, w["wo"], w["wgu"], w["wd"], plan)
    assert got.shape == (m, D) and torch.isfinite(got).all()
    jax_out = torch.from_numpy(block["jax"][(bits, m, layer)])
    ref = tf.fused_mlp_ref(attn, h, ln2, layer, w["wo"], w["wgu"], w["wd"], EPS).float()
    for name, want in (("jax", jax_out), ("fused_mlp_ref", ref)):
        err = float((got - want).abs().max() / want.abs().max())
        print(f"bits {bits} M {m} layer {layer} sms {sms}: vs {name} {err:.3e}")
        assert err < TOL, (name, err)


def test_split_order_moves_only_f32_rounding(block):
    """Two plans with different K splits give results a few bf16 ulps
    apart at most: the split sums differ only in f32 rounding."""
    attn, h, ln2 = _inputs(block, 8, 1)
    w = block["port"][4]
    a = k4_emulate(attn, h, ln2, 1, w["wo"], w["wgu"], w["wd"],
                   tf.mlp_plan(8, D, D, DI, 4, G, sms=132))
    b = k4_emulate(attn, h, ln2, 1, w["wo"], w["wgu"], w["wd"],
                   tf.mlp_plan(8, D, D, DI, 4, G, sms=1))
    assert tf.mlp_plan(8, D, D, DI, 4, G, sms=1).phases[1].splits == 1
    assert float((a - b).abs().max() / b.abs().max()) < 4e-3
