"""The arithmetic of K3 (``pie_tpu_torch/csrc/paged_attention.cu``, the
paged decode attention on the tensor cores), emulated step by step in plain
PyTorch on the CPU and held against the JAX package's
``paged_attention_xla`` and the port's ``paged_attention_ref``.

K3 itself runs only on a card (``tests/test_torch_kernels.py``). What can
go wrong in its numbers is decided by where it rounds, and that is what the
emulation repeats:

- scores: the unscaled bf16 q times the exact K (INT8 codes or bf16
  values) on the tensor cores, f32 products and sums; then times
  ``scale * k_scale[token]`` in f32; masked to NEG_INF;
- an online softmax per warp, over the pieces of the block's pages it
  deals to its warps in turn (warp w takes pieces w, w + W, ...), in f32:
  at D 64 / 128 a piece is a page; at D 256 (B8, its own kernel) a piece
  is a 16-token slice of a page, over four warps;
- PV on the tensor cores: the probabilities times ``v_scale[token]`` in
  f32, then rounded for the bf16 mma: as two bf16 terms ``hi = bf16(p)``
  and ``lo = bf16(p - hi)`` (K3's choice), or as one (``single``, the
  cheaper choice K3 does not take);
- the warps' (acc, m, l) merged in warp order, then the splits' in split
  order, ``w = exp(m_i - max m)``; out = bf16(acc / max(l, 1e-30)).

Measured here (the worst of all cases, printed by
``python -m tests.test_torch_k3_numerics``): with hi/lo P the emulation
lands at most 2.9e-3 from the f32 references at D 64 / 128 and 3.7e-3 at
D 256 (B8's 16-token slices) in the op-level normalized error
(limit 2e-2, so 5.4x inside it), all of it the output's bf16 rounding:
before that rounding it is 6.6e-6 from the plain version (5.1e-6 at D
256). With a single bf16 P it lands at 5.5e-3, and 3.0e-3 before the
output's rounding. K3 takes hi/lo.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pie_tpu.cache.paged import fold_for
from pie_tpu.ops import paged_attention as jpa
from pie_tpu_torch.ops import paged_attention as tpa
from pie_tpu_torch.ops.attention import NEG_INF

PAGE = 64
HKV, LAYERS = 2, 2
LENS = (1, 63, 64, 65, 130, 700)  # 700 tokens: 11 pages, several per warp and split
MAXP = 12  # every lane's table ends in -1 pads
TOL = 2e-2  # the op-level normalized tolerance of K3's card checks


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def k3_warps(d, quantized):
    """Warps that walk pages in a block of K3: at D 64 / 128 (``Geo`` in
    paged_attention.cu) two for bf16 pages at D 128, whose double buffers
    are twice the bytes, else four; at D 256 the four consumer warps of
    ``paged_attention_d256`` (``kConsumerWarps``)."""
    return 2 if (not quantized and d == 128) else 4


def k3_piece(d):
    """Tokens per piece of the walk dealt to a warp: a page at D 64 / 128, a
    16-token slice of a stage at D 256."""
    return 16 if d == 256 else PAGE


def make_inputs(d, quantized, hq, seed=0):
    """A port pool [L, P + 1, Hkv, 64, D] (INT8 codes with f32 scales, or
    bf16 values), shuffled tables with -1 pads, bf16 queries; numpy-made."""
    rng = np.random.default_rng(seed)
    p = len(LENS) * MAXP
    shape = (LAYERS, p + 1, HKV, PAGE, d)
    if quantized:
        k, v = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
                for _ in range(2))
        ks, vs = (torch.from_numpy((rng.random(shape[:4]) * 0.02 + 0.005)
                                   .astype(np.float32)) for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                .bfloat16() for _ in range(2))
        ks = vs = None
    perm = rng.permutation(p).astype(np.int32)
    tables = np.full((len(LENS), MAXP), -1, np.int32)
    for i, n in enumerate(LENS):
        need = -(-n // PAGE)
        tables[i, :need] = perm[i * MAXP:i * MAXP + need]
    q = torch.from_numpy(rng.standard_normal((len(LENS), hq, d)).astype(np.float32))
    return (q.bfloat16(), k, v, ks, vs, torch.from_numpy(tables),
            torch.tensor(LENS, dtype=torch.int32))


def _merge(parts):
    """(acc, m, l) partials merged in order: m = max, w = exp(m_i - m)."""
    m = parts[0][1]
    for _, mi, _ in parts[1:]:
        m = torch.maximum(m, mi)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for ai, mi, li in parts:
        w = torch.exp(mi - m)
        l = l + li * w
        acc = acc + ai * w[..., None]
    return acc, m, l


def k3_emulate(q, pool_k, pool_v, k_scale, v_scale, layer, tables, ctx, scale,
               window, splits, warps, p_round="hilo", round_out=True, piece=PAGE):
    """K3's arithmetic in f32 torch ops (module docstring): the page walk
    split over ``splits`` blocks, each block's pages cut into pieces of
    ``piece`` tokens dealt to ``warps`` warps in turn; [B, Hq, D] bf16 (f32
    with ``round_out=False``: the value K3 rounds to bf16)."""
    b, hq, d = q.shape
    hkv = pool_k.shape[2]
    rep = hq // hkv
    neg = torch.tensor(NEG_INF, dtype=torch.float32)
    qf = q.float().reshape(b, hkv, rep, d)  # unscaled: the mma's A operand
    out = torch.empty((b, hkv, rep, d), dtype=torch.float32)
    for bi in range(b):
        n = int(ctx[bi])
        lo = max(n - window, 0) if window > 0 else 0
        p_lo, p_hi = lo // PAGE, min(-(-n // PAGE), tables.shape[1])
        per = -(-max(p_hi - p_lo, 0) // splits)
        split_parts = []
        for split in range(splits):
            pb = p_lo + split * per
            pe = min(p_hi, pb + per)
            pieces = max(pe - pb, 0) * (PAGE // piece)
            warp_parts = []
            for w in range(warps):
                m = neg.expand(hkv, rep).clone()
                l = torch.zeros((hkv, rep))
                acc = torch.zeros((hkv, rep, d))
                for k in range(w, pieces, warps):
                    t0 = pb * PAGE + k * piece  # the piece's first position
                    t = max(int(tables[bi, t0 // PAGE]), 0)
                    sl = slice(t0 % PAGE, t0 % PAGE + piece)
                    kt = pool_k[layer, t, :, sl].float()  # [Hkv, piece, D], exact
                    vt = pool_v[layer, t, :, sl].float()
                    s = torch.einsum("hrd,htd->hrt", qf[bi], kt)
                    if k_scale is not None:
                        s = s * (scale * k_scale[layer, t, :, sl])[:, None, :]
                    else:
                        s = s * scale
                    pos = t0 + torch.arange(piece)
                    s = torch.where((pos >= lo) & (pos < n), s, neg)
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    if v_scale is not None:
                        p = p * v_scale[layer, t, :, sl][:, None, :]
                    hi = p.bfloat16().float()
                    pv = torch.einsum("hrt,htd->hrd", hi, vt)
                    if p_round == "hilo":
                        pv = pv + torch.einsum("hrt,htd->hrd",
                                               (p - hi).bfloat16().float(), vt)
                    acc = acc * alpha[..., None] + pv
                    m = m_new
                warp_parts.append((acc, m, l))
            split_parts.append(_merge(warp_parts))
        acc, _, l = _merge(split_parts)
        out[bi] = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(b, hq, d)
    return out.bfloat16() if round_out else out


def _jax_xla(q, pool_k, pool_v, k_scale, v_scale, layer, tables, ctx, scale, window):
    """The JAX package's XLA paged attention on the same pool (its scales in
    the JAX pool's phase-major layout), in f32."""
    d = q.shape[-1]
    f = fold_for(d)

    def jscale(s):  # natural [P, Hkv, PAGE] -> [P, f, Hkv, PAGE // f]
        p, h, _ = s.shape
        return jnp.asarray(s.reshape(p, h, PAGE // f, f).permute(0, 3, 1, 2).numpy())

    quantized = k_scale is not None
    kl, vl = (jnp.asarray(t[layer].float().numpy()) for t in (pool_k, pool_v))
    if quantized:
        kl, vl = kl.astype(jnp.int8), vl.astype(jnp.int8)
    out = jpa.paged_attention_xla(
        jnp.asarray(q.float().numpy()), kl, vl, jnp.asarray(tables.numpy()),
        jnp.asarray(ctx.numpy()), scale,
        jscale(k_scale[layer]) if quantized else None,
        jscale(v_scale[layer]) if quantized else None, window=window)
    return torch.from_numpy(np.asarray(out))


def _norm_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


CASES = [(d, quantized, window, rep)
         for d in (64, 128, 256) for quantized in (False, True) for window in (0, 100)
         for rep in {64: (1, 4, 16, 32), 128: (1, 4, 16), 256: (1, 2, 4, 16)}[d]]


def errors(d, quantized, window, rep, splits):
    """Normalized errors: hi/lo P against JAX and the plain version, single
    P against the plain version, the plain version against JAX, and hi/lo
    and single P against the plain version before the output's bf16
    rounding (all in f32)."""
    q, k, v, ks, vs, tables, ctx = make_inputs(d, quantized, rep * HKV, seed=rep + d)
    scale = d ** -0.5
    args = (q, k, v, ks, vs, 1, tables, ctx, scale, window)
    geo = dict(splits=splits, warps=k3_warps(d, quantized), piece=k3_piece(d))
    hilo = k3_emulate(*args, **geo)
    single = k3_emulate(*args, **geo, p_round="single")
    plain = tpa.paged_attention_ref(q.float(), *args[1:])
    jax_out = _jax_xla(*args)
    unrounded = [k3_emulate(*args, **geo, p_round=r, round_out=False)
                 for r in ("hilo", "single")]
    return (_norm_err(hilo, jax_out), _norm_err(hilo, plain), _norm_err(single, plain),
            _norm_err(plain, jax_out), *(_norm_err(u, plain) for u in unrounded))


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("d,quantized,window,rep", CASES)
def test_k3_arithmetic_matches_the_references(d, quantized, window, rep, splits):
    """The emulated K3 (hi/lo P) within the op-level 2e-2 of the JAX
    package's XLA attention and of the port's plain version, at D 64/128
    and D 256 (16-token slices of each page over four warps), INT8
    and bf16 pools, windows 0 and 100, rep 1-16 (32 at D 64; 1, 2, 4, 16 at
    D 256, Gemma-3's groups), ragged
    lengths with -1 pads, the walk split over 1 or 3 blocks of K3's warps;
    the two references agree to f32 rounding."""
    to_jax, to_plain, _, refs, _, _ = errors(d, quantized, window, rep, splits)
    assert to_jax < TOL and to_plain < TOL
    assert refs < 1e-5


@pytest.mark.parametrize("d,quantized", [(64, True), (128, True), (128, False),
                                         (256, True), (256, False)])
def test_hi_lo_probabilities_are_nearer_than_one_bf16(d, quantized):
    """Why K3 rounds P as hi + lo: before the output's bf16 rounding the
    two-term P is at f32 rounding from the plain version, one bf16 P is
    not; after it, one bf16 P is still the further of the two."""
    _, hilo, single, _, hilo_f32, single_f32 = errors(d, quantized, 0, 4, 3)
    assert hilo_f32 < 1e-5 < single_f32
    assert hilo <= single


if __name__ == "__main__":
    worst = [0.0] * 6
    for case in CASES:
        for splits in (1, 3):
            e = errors(*case, splits)
            worst = [max(a, b) for a, b in zip(worst, e)]
            print(case, splits, " ".join(f"{x:.2e}" for x in e))
    print("worst: hi/lo vs JAX {:.2e}, hi/lo vs plain {:.2e}, single vs plain {:.2e}, "
          "plain vs JAX {:.2e}; unrounded hi/lo {:.2e}, single {:.2e}".format(*worst))
