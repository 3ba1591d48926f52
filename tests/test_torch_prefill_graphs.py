"""The port's compiled prefills on the CPU, where StepGraphs calls the
static-buffer prefill steps directly (EngineCore._prefill_step and
PagedEngine._prefill_step):

- scatter_drop's form without a host read against its old boolean-mask
  form and against JAX's ``.at[...].set(mode="drop")``: T = 1 and T > 1,
  out-of-range slots, pads that alias kept slots in a rotating store once
  positions wrap, a row that keeps nothing; bf16 values, and INT8 codes
  with their f32 scales;
- a stricter no-host-read guard than test_torch_compiled_steps's: it also
  refuses ``nonzero``, ``masked_select``, one-argument ``torch.where`` and
  boolean-mask indexing, which read a count back on the card through no
  Tensor method that guard patches; it catches the old scatter_drop;
- every prefill under that guard: bf16 and INT8 contiguous Llama caches,
  the rotating cache, Gemma-3's DualKVCache head chunks (bf16 and INT8),
  masked extends of constrained requests, the paged direct prefill
  (Llama and Gemma-3, bf16 and INT8 pools);
- prefills replayed as on the card (each key fixed to the function of its
  first call) against the JAX package: a second prompt of the same bucket
  with another length, first position, bias and mask gives JAX's
  ``EngineCore._prefill`` token (exact, greedy), logprobs (within 1e-4,
  test_decode_step_logprobs_match_jax's tolerance; 1e-3 of their range
  over an INT8 cache, test_torch_llama's int8_kv tolerance) and cache
  contents (normalized within 1e-5 for f32 caches, 1e-2 dequantized for
  INT8, test_torch_paged_llama's tolerances), and JAX's paged prefill pool
  pages within the same tolerances.

The models are dense f32 (no bf16 cast separates the two packages) unless
a case says INT4."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pie_tpu.cache import paged as jpaged
from pie_tpu.engine.core import EngineCore as JCore
from pie_tpu.engine.core import PenaltyParams as JPen
from pie_tpu.engine.scheduler import PagedEngine as JPagedEngine
from pie_tpu.ops.sampling import SamplingParams as JSamp
from pie_tpu_torch.cache.kv_cache import (
    QuantizedKVCache,
    make_kv_cache,
    scatter_drop,
)
from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.engine.core import EngineCore, PenaltyParams
from pie_tpu_torch.engine.graphs import StepGraphs
from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler, SeqStatus
from pie_tpu_torch.ops.sampling import SamplingParams

from test_torch_compiled_steps import _models, _no_host_reads, _Replaying

PAD = -1


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# -- scatter_drop --------------------------------------------------------------------


def _old_scatter_drop(target, slots, values):
    """scatter_drop as it was at T > 1: the boolean mask makes indexing read
    the count of kept writes back to the host."""
    ok = (slots >= 0) & (slots < target.shape[1])
    rows = torch.arange(slots.shape[0])[:, None]
    target[rows.expand_as(slots)[ok], slots[ok]] = values[ok]


S = 8  # slots of the store


def _drop_slots(t: int) -> np.ndarray:
    """[4, t] write slots: row 0 a contiguous store whose tail runs past its
    end (dropped by range); row 1 a rotating store written from position 6
    with 5 real tokens, whose pads the caller drops (slot S) although their
    positions wrap onto the kept slots 6, 7, 0, 1, 2; row 2 keeps nothing;
    row 3 writes from slot 0 with no drop."""
    pos = 6 + np.arange(t)
    rot = np.where(np.arange(t) < 5, pos % S, S)
    return np.stack([3 + np.arange(t), rot, S + 2 + np.arange(t),
                     np.arange(t) % S]).astype(np.int64)


def _drop_case(t: int, kind: str, seed: int = 0):
    """(targets, values) as numpy: bf16 K rows, or INT8 codes and their f32
    scales (two stores written at the same slots)."""
    rng = np.random.default_rng(seed)
    shape, vshape = (4, S, 2, 4), (4, t, 2, 4)
    if kind == "bf16":
        f = lambda shp: rng.normal(0, 1, shp).astype(np.float32)
        return [(f(shape), f(vshape))]
    codes = lambda shp: rng.integers(-127, 128, shp).astype(np.int8)
    scales = lambda shp: rng.uniform(0.01, 1, shp[:-1] + (1,)).astype(np.float32)
    return [(codes(shape), codes(vshape)), (scales(shape), scales(vshape))]


def _torch_of(a, kind):
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if kind == "bf16" else t


@pytest.mark.parametrize("t", [1, 5, 16])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_scatter_drop_matches_jax_and_the_boolean_mask_form(t, kind):
    """Every store after the write equals JAX's ``.at[rows, slots].set(...,
    mode="drop")`` bit for bit and the old boolean-mask form's; the row
    that keeps nothing and every slot no kept write names are unchanged."""
    slots = _drop_slots(t)
    rows = np.arange(4)[:, None]
    for target, values in _drop_case(t, kind):
        new = _torch_of(target, kind)
        old = new.clone()
        scatter_drop(new, torch.from_numpy(slots), _torch_of(values, kind))
        _old_scatter_drop(old, torch.from_numpy(slots), _torch_of(values, kind))
        assert torch.equal(new, old)
        jdt = jnp.bfloat16 if kind == "bf16" else target.dtype
        want = jnp.asarray(target, jdt).at[rows, slots].set(
            jnp.asarray(values, jdt), mode="drop")
        got = new.float().numpy() if kind == "bf16" else new.numpy()
        np.testing.assert_array_equal(got, np.asarray(want, got.dtype))
        untouched = _torch_of(target, kind)
        assert torch.equal(new[2], untouched[2])


# -- the stricter guard ----------------------------------------------------------------


def _is_bool_index(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in items)


class _RefuseBoolIndex(torch.overrides.TorchFunctionMode):
    """Indexing, or assigning through an index, by a boolean tensor raises.
    A function mode sees every ``Tensor.__getitem__`` / ``__setitem__``
    call without touching the class: replacing ``torch.Tensor.__getitem__``
    and setting it back leaves CPython's sequence slot filled, which
    changes later indexing in the same process (HF's Qwen2-VL
    ``get_rope_index`` then fails with "len() of a 0-d tensor")."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__ and _is_bool_index(args[1]):
            raise AssertionError("boolean-mask indexing inside a step")
        if func is torch.Tensor.__setitem__ and _is_bool_index(args[1]):
            raise AssertionError("boolean-mask index assignment inside a step")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _strict_reads():
    """test_torch_compiled_steps's guard (``__bool__``, ``item``, ``cpu``
    ...) plus what reads a count back on the card without those methods:
    ``nonzero``, ``masked_select``, one-argument ``torch.where`` and
    indexing by a boolean tensor raise."""
    t_saved = {n: getattr(torch.Tensor, n) for n in ("nonzero", "masked_select")}
    f_saved = {n: getattr(torch, n) for n in ("nonzero", "masked_select", "where")}

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"{name} inside a step")
        return call

    def where(condition, *args, **kwargs):
        if not args and not kwargs:
            raise AssertionError("torch.where(condition) inside a step")
        return f_saved["where"](condition, *args, **kwargs)

    try:
        with _no_host_reads(), _RefuseBoolIndex():
            for n in ("nonzero", "masked_select"):
                setattr(torch.Tensor, n, refuse(f"Tensor.{n}"))
                setattr(torch, n, refuse(f"torch.{n}"))
            torch.where = where
            yield
    finally:
        for n, fn in t_saved.items():
            setattr(torch.Tensor, n, fn)
        for n, fn in f_saved.items():
            setattr(torch, n, fn)


class _Strict(StepGraphs):
    """Runs every step (prefills included) under ``_strict_reads``."""

    def __call__(self, key, fn, samples=False):
        def strict():
            with _strict_reads():
                return fn()
        return super().__call__(key, strict, samples)


def test_strict_guard_catches_the_old_scatter_drop():
    """The old form at T > 1 passes the first guard (its host read is not a
    Tensor method call) and fails the stricter one; the new form passes
    both, at T = 1 and T > 1."""
    (target, values), = _drop_case(5, "bf16")
    args = lambda t: (_torch_of(target, "bf16"), torch.from_numpy(_drop_slots(t)),
                      _torch_of(values[:, :t], "bf16"))
    with _no_host_reads():
        _old_scatter_drop(*args(5))
    with _strict_reads(), pytest.raises(AssertionError, match="boolean-mask"):
        _old_scatter_drop(*args(5))
    with _strict_reads():
        scatter_drop(*args(5))
        scatter_drop(*args(1))


# -- every prefill under the guard -------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return _models("int4")


def _strict(engine_like, attr="core"):
    owner = getattr(engine_like, attr)
    owner.graphs = _Strict(owner.graphs.device, owner.graphs.generator)
    return owner.graphs


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_single_stream_prefills_read_nothing_back(models, cache):
    """Prompts of several buckets, a prompt-cache prefix hit (a prefill from
    a first position past 0), ``cache_prompt``, logprobs, bias and
    categorical sampling: every prefill and decode step runs under the
    stricter guard, on the bf16 and on the INT8 contiguous cache."""
    _, _, tm, tp = models
    kw = dict(kv_quantized=True) if cache == "int8" else dict(kv_dtype=torch.bfloat16)
    eng = InferenceEngine(model=tm, params=tp, max_seq_len=128, decode_chunk=8,
                          device="cpu", **kw)
    graphs = _strict(eng)
    long = list(range(3, 73))
    assert len(eng.generate(long, max_completion_tokens=6, temperature=0.0).token_ids) == 6
    got = eng.generate(long[:40] + [5, 9], max_completion_tokens=6, temperature=0.8,
                       logit_bias={7: 2.0}, logprobs=True, repetition_penalty=1.2)
    assert len(got.logprobs) == 6
    eng.cache_prompt([4, 4, 8, 15, 16, 23, 42])
    assert {k[1] for k in graphs.keys if k[0] == "prefill"} >= {16, 128}


def test_rotating_cache_prefills_read_nothing_back(models):
    """A rotating cache of 32 slots: prefills from first positions that make
    the bucket's pads wrap onto kept slots, under the stricter guard."""
    _, _, tm, tp = models
    core = EngineCore(tm, tp, batch_size=1, max_seq_len=64, kv_dtype=torch.float32,
                      device="cpu")
    core.graphs = _Strict(core.graphs.device, core.graphs.generator)
    st = core.new_state(0)
    cfg = tm.config
    st = core.set_cache(make_kv_cache(cfg.num_hidden_layers, 1, 32,
                                      cfg.num_key_value_heads, cfg.resolved_head_dim,
                                      dtype=torch.float32, window=32, device="cpu"))
    args = _inputs(1, bias=False)
    for first, n in ((0, 20), (20, 9), (29, 30)):
        ids = np.zeros((1, 32), np.int32)
        ids[0, :n] = np.arange(n) + 3 + first
        st, tok, _ = core._prefill(tp, st, ids, np.array([n], np.int32),
                                   np.array([first], np.int32), *args,
                                   sampler_kind="greedy")
        assert 0 <= int(tok[0]) < cfg.vocab_size
    assert int(st.lengths[0]) == 59


def test_constrained_extends_read_nothing_back():
    """A json_schema request's masked prompt prefill and masked extends
    (EXTEND_BUCKETS), with forced runs riding them, under the guard."""
    from pie_tpu_torch.structured.json_machine import JsonMachine

    from test_torch_constrained_engine import SCHEMA, make_pair

    _, eng = make_pair()
    graphs = _strict(eng)
    res, text = eng.generate_constrained([1, 2, 3], JsonMachine(SCHEMA),
                                         max_completion_tokens=24, temperature=0.0)
    assert res.completion_tokens > 2 and text.startswith("{")
    masked = {k for k in graphs.keys if k[0] == "prefill" and k[5]}
    assert masked and {k[1] for k in masked} & set(eng.EXTEND_BUCKETS)


def _gemma_pair(weights):
    from test_torch_gemma3 import TINY, build_pair

    return build_pair(TINY, weights)


@pytest.mark.parametrize("quantized", [False, True])
def test_gemma3_head_chunks_read_nothing_back(quantized):
    """Gemma-3's DualKVCache (window 8): a 30-token prompt prefills in head
    chunks of 8 before its tail, bf16 and INT8 groups, under the guard."""
    _, _, tm, tp = _gemma_pair("int4_g64")
    eng = InferenceEngine(model=tm, params=tp, max_seq_len=64, decode_chunk=4,
                          prompt_cache=False, kv_quantized=quantized, device="cpu")
    graphs = _strict(eng)
    out = eng.generate(list(range(5, 35)), max_completion_tokens=5, temperature=0.0)
    assert len(out.token_ids) == 5
    assert sum(1 for k in graphs.keys if k[0] == "prefill") >= 1


@pytest.mark.parametrize("family", ["llama", "gemma3"])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_direct_prefills_read_nothing_back(models, family, quantized):
    """Prompts longer than the direct-prefill threshold (several chunk
    buckets) beside short riders, on bf16 and INT8 pools, under the guard:
    every request completes and the direct prefills ran as their own key."""
    if family == "llama":
        _, _, tm, tp = models
    else:
        _, _, tm, tp = _gemma_pair("int4_g64")
    sched = Scheduler(PagedEngine(tm, tp, num_lanes=4, num_pages=48, max_pages_per_seq=8,
                                  prefill_chunk=32, rider_width=8, kv_quantized=quantized,
                                  kv_dtype=torch.float32, device="cpu"),
                      decode_steps=4)
    graphs = _strict(sched, "engine")
    seqs = [sched.add_request(list(range(1, 1 + n)), max_new_tokens=5, temperature=0.0)
            for n in (70, 3, 45)]
    sched.run_to_completion(max_steps=400)
    assert all(s.status == SeqStatus.COMPLETED for s in seqs)
    assert {k[1] for k in graphs.keys if k[0] == "prefill"} == {16, 32}


# -- replayed prefills against JAX ---------------------------------------------------------


def _inputs(b, bias=True, seed=0, backend="torch"):
    """Greedy sampling, neutral penalties and a width-8 logit bias (or none)
    for JAX or the port."""
    rng = np.random.default_rng(seed)
    ids = np.full((b, 8 if bias else 0), PAD, np.int32)
    vals = np.zeros(ids.shape, np.float32)
    if bias:
        ids[:, :3] = rng.choice(np.arange(1, 500), (b, 3), replace=False)
        vals[:, :3] = rng.uniform(-3, 3, (b, 3))
    if backend == "jax":
        return (JSamp.make(b, temperature=0.0), JPen.make(b), jnp.asarray(ids),
                jnp.asarray(vals))
    return (SamplingParams.make(b, temperature=0.0, device="cpu"),
            PenaltyParams.make(b, device="cpu"), torch.from_numpy(ids),
            torch.from_numpy(vals))


def _mask(v, seed):
    rng = np.random.default_rng(100 + seed)
    return rng.uniform(size=(1, v)) < 0.4


def _cache_dense(cache):
    """Every group's K and V as f32 numpy (INT8 dequantized), with the
    slot positions and lengths."""
    if isinstance(cache, QuantizedKVCache) or hasattr(cache, "k_q"):
        k = np.asarray(cache.k_q, np.float32) * np.asarray(cache.k_scale, np.float32)
        v = np.asarray(cache.v_q, np.float32) * np.asarray(cache.v_scale, np.float32)
    else:
        k, v = np.asarray(cache.k, np.float32), np.asarray(cache.v, np.float32)
    return k, v, np.asarray(cache.slot_positions), np.asarray(cache.length)


@pytest.mark.parametrize("cache", ["f32", "int8", "rotating"])
def test_replayed_prefill_matches_jax_core(cache):
    """Two prefills under one key (bucket 32, greedy, logprobs, bias width
    8, a mask) with the second run by the first call's function: the first
    writes a 12-token prompt from position 0, the second a 20-token
    continuation from position 12 (past the 32 slots of the rotating cache:
    its pads wrap onto kept slots) with other bias ids and values and
    another mask. After each, the port's token equals JAX's, its logprobs
    and cache contents agree within the stated tolerances, and its state
    (lengths, history) equals JAX's."""
    jm, jp, tm, tp = _models("dense")
    cfg = tm.config
    kw = dict(batch_size=1, kv_dtype=jnp.float32)
    if cache == "rotating":
        jc = JCore(jm, jp, max_seq_len=32, kv_window=32, **kw)
    else:
        jc = JCore(jm, jp, max_seq_len=64, kv_quantized=cache == "int8", **kw)
    tc = EngineCore(tm, tp, batch_size=1, max_seq_len=64, kv_dtype=torch.float32,
                    kv_quantized=cache == "int8", device="cpu")
    tc.graphs = _Replaying(tc.graphs.device, tc.graphs.generator)
    js, ts = jc.new_state(0), tc.new_state(0)
    if cache == "rotating":
        ts = tc.set_cache(make_kv_cache(cfg.num_hidden_layers, 1, 32,
                                        cfg.num_key_value_heads, cfg.resolved_head_dim,
                                        dtype=torch.float32, window=32, device="cpu"))
    tol = 1e-2 if cache == "int8" else 1e-5
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 512, 32).astype(np.int32)
    for call, (first, n) in enumerate(((0, 12), (12, 20))):
        ids = np.zeros((1, 32), np.int32)
        ids[0, :n] = prompt[first:first + n]
        mask = _mask(cfg.vocab_size, call)
        lens, pos = np.array([n], np.int32), np.array([first], np.int32)
        js, jtok, jaux = jc._prefill(
            jp, js, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(pos),
            *_inputs(1, seed=call, backend="jax"), allowed_mask=jnp.asarray(mask),
            return_logprobs=True, sampler_kind="greedy")
        ts, ttok, taux = tc._prefill(
            tp, ts, ids, lens, pos, *_inputs(1, seed=call), allowed_mask=mask,
            return_logprobs=True, sampler_kind="greedy")
        assert ttok.tolist() == np.asarray(jtok).tolist()
        assert mask[0, int(ttok[0])]
        chosen, tv, ti = (np.asarray(a) for a in jaux)
        lp_tol = 1e-3 * np.abs(tv).max() if cache == "int8" else 1e-4
        np.testing.assert_allclose(taux[0].numpy(), chosen, rtol=0, atol=lp_tol)
        np.testing.assert_allclose(taux[1].numpy(), tv, rtol=0, atol=lp_tol)
        np.testing.assert_array_equal(taux[2].numpy(), ti)
        jk, jv, jslots, jlen = _cache_dense(js.cache)
        tk, tv_, tslots, tlen = _cache_dense(ts.cache)
        assert _norm_err(tk, jk) < tol and _norm_err(tv_, jv) < tol
        np.testing.assert_array_equal(tslots, jslots)
        np.testing.assert_array_equal(tlen, jlen)
        for f in ("last_token", "lengths", "history", "done"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)))
    keys = [k for k in tc.graphs.keys if k[0] == "prefill"]
    assert keys == [("prefill", 32, "greedy", True, 8, True, False, False, id(tp))]


def _paged_dense(pool, n):
    """Pages [0, n) of a pool's K and V as f32 (INT8 dequantized; JAX's
    phase-major scales unpermuted)."""
    out = []
    for k, s in (("k", "k_scale"), ("v", "v_scale")):
        a = np.asarray(getattr(pool, k)[:, :n], np.float32)
        if pool.quantized:
            sc = getattr(pool, s)
            sc = (np.asarray(jpaged.unpermute_page_scales(sc))[:, :n]
                  if isinstance(sc, jax.Array) else sc[:, :n].numpy()[..., None])
            a = a * sc
        out.append(a)
    return out


@pytest.mark.parametrize("quantized", [False, True])
def test_replayed_paged_prefill_matches_jax(quantized):
    """Two direct prefill chunks of one bucket (32) under one key, the
    second run by the first call's function: another sequence's block
    table, positions from 40 and a shorter chunk. The pool's pages equal
    JAX's PagedEngine._prefill's after each (normalized within 1e-5, or
    1e-2 dequantized for INT8 pages)."""
    jm, jp, tm, tp = _models("dense")
    geo = dict(num_lanes=2, num_pages=16, max_pages_per_seq=4, prefill_chunk=32,
               rider_width=8, kv_quantized=quantized)
    je = JPagedEngine(jm, jp, kv_dtype=jnp.float32, **geo)
    te = PagedEngine(tm, tp, kv_dtype=torch.float32, device="cpu", **geo)
    te.graphs = _Replaying(te.graphs.device, te.key)
    tol = 1e-2 if quantized else 1e-5
    rng = np.random.default_rng(9)
    for table, first, n in (([3, 7, -1, -1], 0, 32), ([12, 0, 5, -1], 40, 21)):
        ids = np.zeros((1, 32), np.int32)
        pos = np.full((1, 32), -1, np.int32)
        ids[0, :n] = rng.integers(1, 512, n)
        pos[0, :n] = first + np.arange(n)
        bt = np.array([table], np.int32)
        ctx = np.array([first + n], np.int32)
        _, je.pool = je._prefill(jp, je.pool, jnp.asarray(ids), jnp.asarray(pos),
                                 jnp.asarray(bt), jnp.asarray(ctx),
                                 jnp.asarray(n - 1, jnp.int32))
        te._prefill(tp, ids, pos, bt, ctx)
        for got, want in zip(_paged_dense(te.pool, 16), _paged_dense(je.pool, 16)):
            assert _norm_err(got, want) < tol
    assert [k for k in te.graphs.keys] == [("prefill", 32, id(tp))]
