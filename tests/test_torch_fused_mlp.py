"""The port's decode MLP block (pie_tpu_torch.ops.fused_mlp) against the
JAX package's fused_mlp_stacked (Pallas, interpret mode) on the same
weights, against the port's own unfused block, and the gates that decide
where the model takes it; then a 2-layer model at the Llama-3.2-1B widths
through __call__ and paged_forward, whose decode steps take the fused block
(its plain version here, K4 on the card) while the JAX package's, on the
CPU, do not.

Tolerances: the fused block is held to 0.02 * max|ref|, the bound of the
JAX package's own fused-kernel test (tests/test_fused_mlp.py): the plain
version dequantizes each weight to bf16 before its dot, the TPU kernel
applies scale and bias per group in f32, and bf16 casts of h2, xg, gu and
act round values an f32 ulp apart to neighbouring bf16 values. Model
logits are held to 1e-2, the INT4 tolerance of tests/test_torch_llama.py,
which states and witnesses it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.cache import paged as jpaged
from pie_tpu.cache.kv_cache import KVCache as JKVCache
from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu.ops import fused_mlp_pallas as jf
from pie_tpu.ops.quant import QuantizedTensor as JQT
from pie_tpu.ops.quant import quantize as jquantize
from pie_tpu_torch.cache import paged as tpaged
from pie_tpu_torch.cache.kv_cache import make_kv_cache
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
from pie_tpu_torch.ops import fused_mlp as tf
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.ops.quant import QuantizedTensor

from test_torch_llama import jax_to_np

D, DI, L, EPS = 2048, 4096, 2, 1e-5
CASES = [(4, 1), (4, 8), (8, 8)]  # (bits, M)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_port(qt):
    return from_jax_params(jax_to_np(qt), "cpu")


@pytest.fixture(scope="module")
def block():
    """Weights of both formats (JAX and port), inputs, and the JAX kernel's
    output for every (bits, M, layer), each computed once."""
    rng = np.random.default_rng(0)
    dense = {
        "wo": rng.standard_normal((L, D, D), np.float32) * 0.02,
        "wgu": rng.standard_normal((L, D, 2 * DI), np.float32) * 0.02,
        "wd": rng.standard_normal((L, DI, D), np.float32) * 0.02,
    }
    ln2 = np.abs(rng.standard_normal((L, D), np.float32)).astype(jnp.bfloat16)
    attn = rng.standard_normal((8, D), np.float32).astype(jnp.bfloat16)
    h = rng.standard_normal((8, D), np.float32).astype(jnp.bfloat16)
    out = {"ln2": ln2, "attn": attn, "h": h, "jax": {}, "port": {}, "want": {}}
    for bits in sorted({b for b, _ in CASES}):
        jw = {k: jax.vmap(lambda m: jquantize(m, 64, bits))(jnp.asarray(w))
              for k, w in dense.items()}
        out["jax"][bits] = jw
        out["port"][bits] = {k: _to_port(w) for k, w in jw.items()}
        for b, m in CASES:
            if b != bits:
                continue
            for layer in range(L):
                got = jf.fused_mlp_stacked(
                    jnp.asarray(attn[:m]), jnp.asarray(h[:m]), jnp.asarray(ln2[layer]),
                    jnp.int32(layer), jw["wo"], jw["wgu"], jw["wd"], eps=EPS,
                    interpret=True)
                out["want"][(bits, m, layer)] = np.asarray(got, np.float32)
    return out


def _port_inputs(block, m):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t(block["attn"][:m]), t(block["h"][:m]), t(block["ln2"])


@pytest.mark.parametrize("bits,m", CASES)
def test_ref_matches_jax_kernel(block, bits, m):
    """fused_mlp_ref against the TPU kernel in interpret mode, both layers;
    the layer's ln2 row is taken from the [L, d] table (layer 0) and passed
    as the [d] row (layer 1)."""
    attn, h, ln2 = _port_inputs(block, m)
    w = block["port"][bits]
    for layer in range(L):
        ln = ln2 if layer == 0 else ln2[layer]
        got = tf.fused_mlp_ref(attn, h, ln, layer, w["wo"], w["wgu"], w["wd"], EPS)
        assert got.dtype == torch.bfloat16 and got.shape == (m, D)
        want = block["want"][(bits, m, layer)]
        err = np.abs(got.float().numpy() - want).max()
        scale = np.abs(want).max()
        print(f"bits {bits} M {m} layer {layer}: max abs err {err:.3e} "
              f"({err / scale:.3e} of max|ref|)")
        assert err < 0.02 * scale


@pytest.mark.parametrize("fused_ln", [False, True])
@pytest.mark.parametrize("bits,m", CASES)
def test_ref_matches_unfused_block(block, bits, m, fused_ln):
    """fused_mlp_ref against the port's unfused _mlp_block (three quantized
    matmuls and the glue between them, with ln2 as its own op or folded
    into the wgu prologue)."""
    attn, h, ln2 = _port_inputs(block, m)
    w = block["port"][bits]
    model = LlamaModel(LlamaConfig(hidden_size=D, intermediate_size=DI,
                                   num_hidden_layers=L))
    p = dict(w, ln2=ln2)
    for layer in range(L):
        want = model._mlp_block(p, h[:, None], attn[:, None], layer, EPS, False,
                                fused_ln=fused_ln)[:, 0].float()
        got = tf.fused_mlp_ref(attn, h, ln2, layer, w["wo"], w["wgu"], w["wd"], EPS)
        assert (got.float() - want).abs().max() < 0.02 * want.abs().max()


def _zero_pair(k, n, bits=4, g=64, layers=2):
    """JAX and port QuantizedTensors of logical [L, K, N] holding zeros:
    all the gates read is the format and the shapes."""
    ep, kp = 32 // bits, -(-k // 512) * 512
    lead = (layers,) if layers else ()
    jqt = JQT(packed=jnp.zeros(lead + (kp // ep, n), jnp.uint32),
              scales=jnp.zeros(lead + (kp // g, n), jnp.bfloat16),
              biases=jnp.zeros(lead + (kp // g, n), jnp.bfloat16),
              bits=bits, group_size=g, shape=(k, n))
    tqt = QuantizedTensor(packed=torch.zeros(lead + (kp // ep, n), dtype=torch.int32),
                          scales=torch.zeros(lead + (kp // g, n), dtype=torch.bfloat16),
                          biases=torch.zeros(lead + (kp // g, n), dtype=torch.bfloat16),
                          bits=bits, group_size=g, shape=(k, n))
    return jqt, tqt


def _gate_cases():
    """(name, (wo, wgu, wd) as JAX/port pairs, M)."""
    def trio(d=D, di=DI, d_attn=D, fmt=((4, 64),) * 3, layers=2):
        dims = ((d_attn, d), (d, 2 * di), (di, d))
        return [_zero_pair(k, n, b, g, layers) for (k, n), (b, g) in zip(dims, fmt)]

    base = trio()
    return [
        ("m8", base, 8), ("m1", base, 1), ("m9", base, 9),
        ("unstacked wo", [_zero_pair(D, D, layers=0)] + base[1:], 1),
        ("group mismatch", trio(fmt=((4, 64), (4, 32), (4, 64))), 1),
        ("bits mismatch", trio(fmt=((4, 64), (4, 64), (8, 64))), 1),
        ("int8 g128", trio(fmt=((8, 128),) * 3), 8),
        ("d 1024", trio(d=1024, d_attn=1024), 1),
        ("di 3072", trio(di=3072), 1),
        ("d_attn 1536", trio(d_attn=1536), 1),
    ]


def test_supported_gate_matches_jax():
    """The port's fused_mlp_supported answers as the JAX package's on the
    cases of tests/test_fused_mlp.py, on group-size and bit mismatches, and
    on widths its tiles do not divide."""
    seen = {}
    for name, ws, m in _gate_cases():
        want = jf.fused_mlp_supported(*(j for j, _ in ws), m)
        assert tf.fused_mlp_supported(*(t for _, t in ws), m) == want, name
        seen[name] = want
    assert seen["m8"] and seen["m1"] and seen["int8 g128"]
    assert not any(seen[k] for k in ("m9", "unstacked wo", "group mismatch",
                                     "bits mismatch", "d 1024", "di 3072",
                                     "d_attn 1536"))


def test_fused_mlp_ok_gate():
    """The model's auto policy: on for the 1B geometry at M <= 8; off at
    M = 9, for dense weights and for the 8B geometry (hidden 4096), whose
    weights the kernel's own gate would take."""
    one_b = LlamaModel(LlamaConfig(hidden_size=D, intermediate_size=DI))
    wo, wgu, wd = (t for _, t in _gate_cases()[0][1])
    p = {"wo": wo, "wgu": wgu, "wd": wd}
    assert one_b._fused_mlp_ok(p, 8) and one_b._fused_mlp_ok(p, 1)
    assert not one_b._fused_mlp_ok(p, 9)
    dense = {k: torch.zeros(2, 4, 4) for k in ("wo", "wgu", "wd")}
    assert not one_b._fused_mlp_ok(dense, 1)
    assert not one_b._fused_mlp_ok({"wo": wo, "wd": wd}, 1)
    eight_b = LlamaModel(LlamaConfig(hidden_size=4096, intermediate_size=14336,
                                     num_hidden_layers=32))
    big = [_zero_pair(k, n, layers=1)[1]
           for k, n in ((4096, 4096), (4096, 2 * 14336), (14336, 4096))]
    assert tf.fused_mlp_supported(*big, 1)
    assert not eight_b._fused_mlp_ok(dict(zip(("wo", "wgu", "wd"), big)), 1)


def test_cpu_tensors_never_launch_k4(block):
    """On the CPU the router is the plain version; the kernel's wrapper
    refuses CPU tensors instead of computing anything."""
    attn, h, ln2 = _port_inputs(block, 1)
    w = block["port"][4]
    qmc.reset_counts()
    got = tf.fused_mlp_stacked(attn, h, ln2, 1, w["wo"], w["wgu"], w["wd"], EPS)
    want = tf.fused_mlp_ref(attn, h, ln2, 1, w["wo"], w["wgu"], w["wd"], EPS)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_mlp_cuda(attn, h, ln2, 1, w["wo"], w["wgu"], w["wd"], EPS)
    assert qmc.launch_counts["K4"] == 0


# -- the model at the 1B widths -------------------------------------------------


def _model_config():
    return dict(
        model_type="llama", hidden_size=2048, intermediate_size=2048,
        num_hidden_layers=2, num_attention_heads=32, num_key_value_heads=8,
        head_dim=64, vocab_size=512, rms_norm_eps=1e-5, rope_theta=500000.0,
        max_position_embeddings=512, tie_word_embeddings=True,
    )


@pytest.fixture(scope="module")
def model_pair():
    cfg = _model_config()
    jm = JModel(JConfig.from_dict(cfg))
    jp = jm.init_params(jax.random.PRNGKey(7), dtype=jnp.float32)
    jp = jm.quantize_params(jp, group_size=64, bits=4)
    tm = LlamaModel(LlamaConfig.from_dict(cfg))
    return jm, jp, tm, from_jax_params(jax_to_np(jp), "cpu")


@pytest.fixture
def spy(monkeypatch):
    """Counts calls of the fused block's plain version."""
    calls = []
    real = tf.fused_mlp_ref

    def counting(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tf, "fused_mlp_ref", counting)
    return calls


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_model_call_takes_fused_block(model_pair, spy):
    """A 16-token prefill (M = 16: unfused) then 4 decode steps (M = 1: the
    fused block, once per layer) through __call__; logits within 1e-2 of
    the JAX package's, which runs the unfused block on the CPU."""
    jm, jp, tm, tp = model_pair
    ids = np.random.default_rng(1).integers(0, 512, (1, 20))
    jc = JKVCache.create(2, 1, 32, 8, 64, jnp.float32)
    tc = make_kv_cache(2, 1, 32, 8, 64, dtype=torch.float32, device="cpu")
    errs = []
    for start, t in [(0, 16)] + [(i, 1) for i in range(16, 20)]:
        n0 = len(spy)
        pos_j = jnp.int32(start) + jnp.arange(t)[None]
        jc = jc.advance(jnp.asarray([start]), t)
        lj, jc = jm(jp, jnp.asarray(ids[:, start:start + t]), jc, pos_j)
        first = torch.tensor([start], dtype=torch.int32)
        tc = tc.advance(first, t)
        with torch.no_grad():
            lt, tc = tm(tp, torch.from_numpy(ids[:, start:start + t]), tc,
                        first[:, None] + torch.arange(t, dtype=torch.int32)[None])
        assert spy[n0:] == ([1, 1] if t == 1 else [])
        errs.append(_norm_err(lt.numpy(), np.asarray(lj)))
    assert max(errs) < 1e-2, errs


def test_model_paged_forward_takes_fused_block(model_pair, spy):
    """8 lanes prefilled in one padded chunk (unfused), then 4 decode steps
    of all 8 lanes (M = 8: the fused block, once per layer) through
    paged_forward; logits within 1e-2 of the JAX package's."""
    jm, jp, tm, tp = model_pair
    lanes, pages = 8, 17
    jpool = jpaged.PagedKVPool.create(2, pages, 8, 64, jnp.float32, False)
    tpool = tpaged.PagedKVPool.create(2, pages, 8, 64, torch.float32, False,
                                      device="cpu")
    tables = (np.arange(lanes * 2, dtype=np.int32).reshape(lanes, 2) + 1) % pages
    rng = np.random.default_rng(2)
    lens = rng.integers(3, 9, lanes).astype(np.int32)
    pos = np.where(np.arange(8)[None] < lens[:, None], np.arange(8)[None], -1)
    ids = np.where(pos >= 0, rng.integers(0, 512, (lanes, 8)), 0).astype(np.int32)

    def step(ids, pos, ctx):
        nonlocal jpool
        lj, jpool = jm.paged_forward(jp, jnp.asarray(ids), jpool, jnp.asarray(tables),
                                     jnp.asarray(pos), jnp.asarray(ctx))
        with torch.no_grad():
            lt, _ = tm.paged_forward(tp, torch.from_numpy(ids), tpool,
                                     torch.from_numpy(tables),
                                     torch.from_numpy(pos.astype(np.int32)),
                                     torch.from_numpy(ctx))
        return np.asarray(lj), lt.numpy()

    lj, lt = step(ids, pos.astype(np.int32), lens)
    assert spy == []
    assert _norm_err(lt[pos >= 0], lj[pos >= 0]) < 1e-2
    ctx = lens.copy()
    tok = ids[np.arange(lanes), ctx - 1]
    for _ in range(4):
        n0 = len(spy)
        lj, lt = step(tok[:, None].astype(np.int32), ctx[:, None], ctx + 1)
        assert spy[n0:] == [lanes, lanes]
        assert _norm_err(lt, lj) < 1e-2
        tok = lj[:, 0].argmax(-1).astype(np.int32)
        ctx = ctx + 1
