"""The port's Llama forward (pie_tpu_torch.models.llama) against the JAX
package's LlamaModel on the same weights: prefill and single-token decode
logits (the decode steps take the fused-ln / fused-rope route) for dense,
INT4 and INT8 weights and for f32, bf16 and INT8 KV caches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.cache.kv_cache import KVCache as JKVCache
from pie_tpu.cache.kv_cache import QuantizedKVCache as JQKVCache
from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu.ops.quant import QuantizedTensor as JQT
from pie_tpu_torch.cache.kv_cache import make_kv_cache
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_config(hidden, heads, kv_heads, tied=False, **extra):
    return dict(
        model_type="llama", hidden_size=hidden, intermediate_size=2 * hidden,
        num_hidden_layers=2, num_attention_heads=heads,
        num_key_value_heads=kv_heads, vocab_size=512, rms_norm_eps=1e-5,
        rope_theta=10000.0, max_position_embeddings=512,
        tie_word_embeddings=tied, **extra,
    )


def jax_to_np(tree):
    """JAX params -> numpy tree (QuantizedTensor -> dict), the converter's
    input form."""
    if isinstance(tree, JQT):
        return dict(packed=np.asarray(tree.packed), scales=np.asarray(tree.scales),
                    biases=np.asarray(tree.biases), bits=tree.bits,
                    group_size=tree.group_size, shape=tree.shape)
    if isinstance(tree, dict):
        return {k: jax_to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def build_pair(cfg, weights, seed=1):
    """(jax model, jax params, port model, port params) on the same weights."""
    jm = JModel(JConfig.from_dict(cfg))
    jp = jm.init_params(jax.random.PRNGKey(seed), dtype=jnp.float32)
    if weights != "dense":
        bits, g = {"int4_g64": (4, 64), "int8_g32": (8, 32)}[weights]
        jp = jm.quantize_params(jp, group_size=g, bits=bits)
    tm = LlamaModel(LlamaConfig.from_dict(cfg))
    return jm, jp, tm, from_jax_params(jax_to_np(jp), "cpu")


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _forward_j(jm, jp, ids, cache, first):
    b, t = ids.shape
    pos = jnp.asarray(first)[:, None] + jnp.arange(t)[None, :]
    cache = cache.advance(jnp.asarray(first), t)
    logits, cache = jm(jp, jnp.asarray(ids), cache, pos)
    return np.asarray(logits), cache


def _forward_t(tm, tp, ids, cache, first):
    b, t = ids.shape
    first = torch.as_tensor(np.asarray(first), dtype=torch.int32)
    pos = first[:, None] + torch.arange(t, dtype=torch.int32)[None, :]
    cache = cache.advance(first, t)
    logits, cache = tm(tp, torch.as_tensor(ids, dtype=torch.int64), cache, pos)
    return logits.numpy(), cache


# Tolerances. Dense weights keep every activation in f32, and the two
# implementations agree to ~1e-6, under the 1e-3 bound. Quantized weights
# cast each matmul input to bf16 (the JAX cast points, mirrored): the f32
# values of the two implementations differ in the last ulp (other summation
# order, rsqrt, exp), a few of those casts round to neighbouring bf16
# values, and every later cast amplifies the difference; over two layers it
# settles at 2-5e-3. Two tests below show that cause: given the same
# inputs, each quantized matmul of the model agrees with the JAX package's
# to f32 rounding, and the JAX package against itself, with only the order
# of its hidden-dimension sums changed, already differs by more than 1e-3.
# The quantized cases are held to 1e-2: twice the largest seen, and below
# the 0.025 the JAX package allows its quantized kernel.
CASES = {
    # name: (hidden, heads, kv heads, tied, weights, kv cache, tolerance)
    "dense_f32": (256, 4, 2, True, "dense", "f32", 1e-3),
    "int4_g64_dh128": (512, 4, 2, False, "int4_g64", "f32", 1e-2),
    "int8_g32": (256, 4, 2, False, "int8_g32", "f32", 1e-2),
    "bf16_kv": (256, 4, 2, False, "dense", "bf16", 1e-3),
    "int8_kv_dh128": (512, 4, 2, False, "dense", "int8", 1e-3),
    "int4_int8_kv": (256, 4, 2, False, "int4_g64", "int8", 1e-2),
}


def _caches(case):
    """Fresh (JAX, port) KV caches for a case."""
    hidden, heads, kv, _, _, kvc, _ = CASES[case]
    l, dh, s = 2, hidden // heads, 32
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.float32}[kvc]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.float32}[kvc]
    jc = (JQKVCache if kvc == "int8" else JKVCache).create(l, 1, s, kv, dh, jdt)
    tc = make_kv_cache(l, 1, s, kv, dh, dtype=tdt, quantized=kvc == "int8",
                       device="cpu")
    return jc, tc


def _steps(n=12, p=8):
    """A prefill of p tokens (T > 1), then single-token decode steps (the
    fused ln / rope route for quantized weights): (ids, [(start, len)])."""
    ids = np.random.default_rng(0).integers(0, 512, (1, n))
    return ids, [(0, p)] + [(i, 1) for i in range(p, n)]


def _logit_errors(case):
    """Normalized max error of the port's logits against the JAX
    package's, at every step of ``_steps``."""
    hidden, heads, kv, tied, weights, _, _ = CASES[case]
    jm, jp, tm, tp = build_pair(small_config(hidden, heads, kv, tied), weights)
    jc, tc = _caches(case)
    ids, steps = _steps()
    errs = []
    for start, t in steps:
        lj, jc = _forward_j(jm, jp, ids[:, start:start + t], jc, [start])
        lt, tc = _forward_t(tm, tp, ids[:, start:start + t], tc, [start])
        errs.append(_norm_err(lt, lj))
    return errs


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_jax(case):
    errs = _logit_errors(case)
    assert max(errs) < CASES[case][-1], errs


QUANTIZED = [c for c in CASES if CASES[c][4] != "dense"]


@pytest.mark.parametrize("case", QUANTIZED)
def test_quantized_matmuls_match_jax_on_the_same_inputs(case, monkeypatch):
    """Every quantized matmul of a JAX forward (prefill and one decode step
    with the fused ln / rope route), replayed through the port's ``linear``
    on the very same inputs and weights, agrees to 1e-4: the port's ops are
    right, and what separates the two models' logits comes from the inputs
    each computes for itself."""
    import pie_tpu.models.llama as jl
    from pie_tpu_torch.models.llama import linear as t_linear

    hidden, heads, kv, tied, weights, _, _ = CASES[case]
    jm, jp, _, _ = build_pair(small_config(hidden, heads, kv, tied), weights)
    to_t = lambda a: None if a is None else torch.from_numpy(np.array(a, np.float32))
    errs = []
    j_linear = jl.linear

    def replay(x, w, bias=None, layer=None, rope_cs=None, rope_dim=0,
               ln_w=None, ln_eps=0.0):
        y = j_linear(x, w, bias, layer, rope_cs, rope_dim, ln_w, ln_eps)
        if isinstance(w, JQT):
            got = t_linear(
                to_t(x), from_jax_params(jax_to_np(w), "cpu"), to_t(bias),
                None if layer is None else int(layer),
                None if rope_cs is None else tuple(map(to_t, rope_cs)),
                rope_dim, to_t(ln_w), ln_eps,
            )
            errs.append(_norm_err(got.numpy(), y))
        return y

    monkeypatch.setattr(jl, "linear", replay)
    jc, _ = _caches(case)
    ids, steps = _steps(n=9)
    with jax.disable_jit():  # concrete values inside the layer scan
        for start, t in steps:
            _, jc = _forward_j(jm, jp, ids[:, start:start + t], jc, [start])
    assert len(errs) == 2 * (4 * 2 + 1)  # 2 steps x (4 per layer + lm_head)
    assert max(errs) < 1e-4, errs


def _permute_hidden(jp, hidden, seed):
    """Dense JAX params of the same model with the hidden units reordered
    inside each block of 32 (so inside every quantization group): the
    logits are mathematically unchanged, only the order of the sums over
    the hidden dimension differs."""
    rng = np.random.default_rng(seed)
    perm = np.concatenate([b + rng.permutation(32) for b in range(0, hidden, 32)])
    layers = dict(jp["layers"])
    for name in ("wq", "wk", "wv", "wg", "wu"):
        layers[name] = layers[name][:, perm, :]
    for name in ("wo", "wd"):
        layers[name] = layers[name][:, :, perm]
    for name in ("ln1", "ln2"):
        layers[name] = layers[name][:, perm]
    out = dict(jp, embed=jp["embed"][:, perm], layers=layers, norm=jp["norm"][perm])
    if "lm_head" in jp:
        out["lm_head"] = jp["lm_head"][perm, :]
    return out


def _jax_self_errors(case, seed=0):
    """Normalized max error of the JAX package against itself with the
    hidden sums reordered, at every step of ``_steps``."""
    hidden, heads, kv, tied, weights, _, _ = CASES[case]
    jm = JModel(JConfig.from_dict(small_config(hidden, heads, kv, tied)))
    dense = jm.init_params(jax.random.PRNGKey(1), dtype=jnp.float32)
    pair = [dense, _permute_hidden(dense, hidden, seed)]
    if weights != "dense":
        bits, g = {"int4_g64": (4, 64), "int8_g32": (8, 32)}[weights]
        pair = [jm.quantize_params(p, group_size=g, bits=bits) for p in pair]
    caches = [_caches(case)[0], _caches(case)[0]]
    ids, steps = _steps()
    errs = []
    for start, t in steps:
        out = []
        for i, p in enumerate(pair):
            lg, caches[i] = _forward_j(jm, p, ids[:, start:start + t], caches[i],
                                       [start])
            out.append(lg)
        errs.append(_norm_err(out[1], out[0]))
    return errs


def test_jax_against_itself_exceeds_1e3_on_quantized_weights():
    """The witness for the quantized cases' tolerance: with only its
    summation order changed, the JAX package's INT4 model moves its own
    logits by more than 1e-3 (and its dense model by less than 1e-5)."""
    assert max(_jax_self_errors("int4_g64_dh128")) > 1e-3
    assert max(_jax_self_errors("dense_f32")) < 1e-5


def test_incremental_decode_matches_full_forward():
    """Prefill + per-token decode == one full forward (port only)."""
    cfg = small_config(256, 4, 2)
    _, _, tm, tp = build_pair(cfg, "dense", seed=3)
    ids = np.random.default_rng(1).integers(0, 512, (1, 12))
    make = lambda: make_kv_cache(2, 1, 16, 2, 64, dtype=torch.float32,
                                 device="cpu")
    full, _ = _forward_t(tm, tp, ids, make(), [0])
    cache = make()
    p = 6
    lp, cache = _forward_t(tm, tp, ids[:, :p], cache, [0])
    np.testing.assert_allclose(lp, full[:, :p], atol=2e-4, rtol=2e-4)
    for i in range(p, ids.shape[1]):
        step, cache = _forward_t(tm, tp, ids[:, i:i + 1], cache, [i])
        np.testing.assert_allclose(step[:, 0], full[:, i], atol=2e-4, rtol=2e-4)


def test_rotating_cache_matches_windowed_attention():
    """A rotating cache at capacity == window reproduces sliding-window
    attention over a large cache."""
    cfg = small_config(256, 4, 2)
    _, _, tm, tp = build_pair(cfg, "dense", seed=4)
    ids = np.random.default_rng(4).integers(0, 512, (1, 10))
    big = make_kv_cache(2, 1, 16, 2, 64, dtype=torch.float32, window=4,
                        device="cpu")
    rot = make_kv_cache(2, 1, 4, 2, 64, dtype=torch.float32, window=4,
                        device="cpu")
    for i in range(ids.shape[1]):
        lb, big = _forward_t(tm, tp, ids[:, i:i + 1], big, [i])
        lr, rot = _forward_t(tm, tp, ids[:, i:i + 1], rot, [i])
        np.testing.assert_allclose(lr, lb, atol=3e-4, rtol=3e-4)


if __name__ == "__main__":
    # Prints the numbers behind the tolerances: for each case, the port
    # against the JAX package, and the JAX package against itself with its
    # hidden sums reordered (five orders). Run from the repo root:
    #   python -m tests.test_torch_llama
    import tests.conftest  # noqa: F401  (JAX on the CPU, f32 matmuls)

    torch.set_num_threads(2)
    for case in CASES:
        port = max(_logit_errors(case))
        own = [max(_jax_self_errors(case, seed)) for seed in range(5)]
        print(f"{case:16s} port vs JAX {port:.2e}   JAX vs reordered JAX "
              + " ".join(f"{e:.2e}" for e in own))
