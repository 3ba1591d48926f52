"""The port's native scheduler (pie_tpu_torch.runtime.native_scheduler) on
the CPU: the C++ core of native/, built by the port, driving the port's
native programs. Mirrors tests/test_native_scheduler.py (the core's
lifecycle and parameters, batched greedy streams, stop tokens and
streaming, lane reuse and page return, cancellation) and holds the port
against the JAX package on the same weights: the greedy streams against
JAX's NativeScheduler (where JAX's library builds) and, always, against
JAX's Python Scheduler; the three native programs against JAX's
``_prefill`` / ``_sample_first`` / ``_decode``; and a steady native step
reads the device once, for its tokens."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from pie_tpu.engine.core import PenaltyParams as JPen
from pie_tpu.engine.scheduler import PagedEngine as JPagedEngine
from pie_tpu.engine.scheduler import Scheduler as JScheduler
from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu.ops.sampling import SamplingParams as JSamp
from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.engine.scheduler import HISTORY_LEN, PagedEngine
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
from pie_tpu_torch.runtime.native_scheduler import NativeScheduler, NativeSchedulerCore

from test_torch_llama import jax_to_np

TINY = dict(
    hidden_size=64,
    intermediate_size=128,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    vocab_size=256,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    max_position_embeddings=512,
    tie_word_embeddings=False,
)
PROMPTS = {
    "a": [5, 17, 42, 7],
    "b": [9, 3, 3, 7, 1],
    "c": list(range(10, 40)),  # spans two prefill chunks of 16
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_models(cfg=TINY):
    """JAX and port models on the f32 weights of tests/test_native_scheduler.py
    (HF's init, seed 0), the embedding and head at unit scale (50x) so
    greedy choices are decisive across the two packages."""
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**cfg,
                                                                attention_bias=False))
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    jm = JModel(JConfig.from_dict(dict(cfg, model_type="llama")))
    jp = jm.from_hf_state_dict(sd, dtype=jnp.float32)
    jp["embed"] = jp["embed"] * 50.0
    jp["lm_head"] = jp["lm_head"] * 50.0
    tm = LlamaModel(LlamaConfig.from_dict(dict(cfg, model_type="llama")))
    return jm, jp, tm, from_jax_params(jax_to_np(jp), "cpu")


def jax_native_or_skip():
    """JAX's NativeScheduler class, or a skip when JAX's own build of the
    native library (cmake + ninja into native/build) is unavailable."""
    from pie_tpu.runtime.allocator import load_native

    if load_native() is None:
        pytest.skip("the JAX package's native library is unavailable")
    from pie_tpu.runtime.native_scheduler import NativeScheduler as JNative

    return JNative


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def expected(models):
    """The port's single-stream greedy streams (10 tokens) of PROMPTS."""
    _, _, tm, tp = models
    eng = InferenceEngine(model=tm, params=tp, max_seq_len=256,
                          kv_dtype=torch.float32, decode_chunk=8,
                          prompt_cache=False, device="cpu")
    return {k: eng.generate(p, max_completion_tokens=10, temperature=0.0).token_ids
            for k, p in PROMPTS.items()}


def _engine(models, num_lanes=4, num_pages=32, chunk=16):
    _, _, tm, tp = models
    return PagedEngine(tm, tp, num_lanes=num_lanes, num_pages=num_pages,
                       max_pages_per_seq=8, prefill_chunk=chunk,
                       kv_dtype=torch.float32, device="cpu")


def _sched(models, **kw):
    return NativeScheduler(_engine(models, **kw))


# -- the core binding (no model) -------------------------------------------------


def test_core_lifecycle_echo():
    core = NativeSchedulerCore(num_lanes=2, num_pages=16, max_pages_per_seq=4,
                               prefill_chunk=8, history_len=16)
    sid = core.submit([10, 11, 12], max_new_tokens=5)
    assert core.has_work
    while core.has_work:
        core.begin_step()
        while (chunk := core.next_prefill()) is not None:
            lane, seq_id, ids, start, ctx, is_last = chunk
            assert seq_id == sid
            if is_last:
                core.commit_first(lane, int(ids[-1]) + 1)
        if core.decode_view() > 0:
            core.commit_decode(core.last_tokens + 1)
    assert core.seq_output(sid) == [13, 14, 15, 16, 17]
    assert core.pop_finished() == [(sid, "length")]
    assert core.num_free_pages == 16
    core.release(sid)
    with pytest.raises(KeyError):
        core.seq_output(sid)


def test_core_stop_token_and_params():
    core = NativeSchedulerCore(num_lanes=2, num_pages=16, max_pages_per_seq=4,
                               prefill_chunk=8, history_len=16)
    sid = core.submit([1, 2], max_new_tokens=100, stop_token_ids=(4,),
                      temperature=0.25, top_p=0.8, top_k=7, repetition_penalty=1.5)
    core.begin_step()
    lane = core.next_prefill()[0]
    core.commit_first(lane, 3)
    assert core.decode_view() == 1
    assert core.temperature[lane] == pytest.approx(0.25)
    assert core.top_p[lane] == pytest.approx(0.8)
    assert core.top_k[lane] == 7
    assert core.rep_pen[lane] == pytest.approx(1.5)
    assert core.histories[lane, -3:].tolist() == [1, 2, 3]  # prompt + first
    toks = np.zeros(2, np.int32)
    toks[lane] = 4  # the stop token
    core.commit_decode(toks)
    assert core.pop_finished() == [(sid, "stop")]
    assert core.seq_output(sid) == [3, 4]


# -- end to end on the tiny model ---------------------------------------------------


def _jax_streams(models, impl):
    """JAX's batched greedy streams of PROMPTS, all three at once, through its
    Python Scheduler or its NativeScheduler (f32 pages)."""
    jm, jp, _, _ = models
    eng = JPagedEngine(jm, jp, num_lanes=4, num_pages=32, max_pages_per_seq=8,
                       prefill_chunk=16, kv_dtype=jnp.float32)
    sched = JScheduler(eng) if impl == "jax_scheduler" else jax_native_or_skip()(eng)
    reqs = {k: sched.add_request(p, max_new_tokens=10, temperature=0.0)
            for k, p in PROMPTS.items()}
    sched.run_to_completion(max_steps=200)
    return {k: list(r.output_ids) for k, r in reqs.items()}


@pytest.mark.parametrize("ref", ["jax_scheduler", "jax_native"])
def test_native_batched_greedy_matches_single_stream(models, expected, ref):
    """Three prompts batched (one spans two prefill chunks): each stream is
    the single-stream engine's and JAX's batched one, token for token."""
    sched = _sched(models)
    reqs = {k: sched.add_request(p, max_new_tokens=10, temperature=0.0)
            for k, p in PROMPTS.items()}
    sched.run_to_completion(max_steps=200)
    want = _jax_streams(models, ref)
    for k, req in reqs.items():
        assert req.done and req.finish_reason == "length"
        assert req.output_ids == expected[k] == want[k], k


def test_native_stop_tokens_and_streaming(models, expected):
    stop_tok = expected["a"][3]
    streamed = []
    sched = _sched(models)
    req = sched.add_request(PROMPTS["a"], max_new_tokens=10, temperature=0.0,
                            stop_token_ids=(stop_tok,))
    req.on_token = lambda r, t: streamed.append(t)
    sched.run_to_completion(max_steps=200)
    assert req.finish_reason == "stop"
    assert req.output_ids == expected["a"][:expected["a"].index(stop_tok) + 1]
    assert streamed == req.output_ids


def test_native_lane_reuse_and_page_return(models, expected):
    sched = _sched(models, num_lanes=2)
    reqs = [sched.add_request(PROMPTS["a"], max_new_tokens=10, temperature=0.0)
            for _ in range(5)]
    sched.run_to_completion(max_steps=1000)
    for r in reqs:
        assert r.output_ids == expected["a"]
    assert sched.core.num_free_pages == sched.engine.pool.num_pages
    assert not sched.requests  # finished requests are dropped


def test_native_cancellation(models):
    sched = _sched(models)
    req = sched.add_request([5, 6, 7], max_new_tokens=50, temperature=0.0)

    def maybe_cancel(r, t):
        if len(r.output_ids) >= 3:
            sched.cancel(r)

    req.on_token = maybe_cancel
    sched.run_to_completion(max_steps=200)
    assert req.finish_reason == "cancelled"
    assert 3 <= len(req.output_ids) <= 5
    assert sched.core.num_free_pages == sched.engine.pool.num_pages


# -- the native programs against JAX's ----------------------------------------------


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_native_programs_match_jax(models):
    """On the same f32 weights and pools: a 20-token prompt prefilled in
    chunks of 16 and 4 (bucket 16) with its last row's logits, the first
    token under a repetition penalty that moves it, then two batched decode
    steps with one lane active and three frozen: logits, tokens and every
    pool page equal JAX's programs (f32 tolerance)."""
    jm, jp, _, _ = models
    je = JPagedEngine(jm, jp, num_lanes=4, num_pages=16, max_pages_per_seq=8,
                      prefill_chunk=16, kv_dtype=jnp.float32)
    te = _engine(models, num_pages=16)
    prompt = np.arange(30, 50, dtype=np.int32)
    table = np.full((4, 8), -1, np.int32)
    table[1, :2] = [3, 7]
    for start, n in ((0, 16), (16, 4)):
        ids = np.zeros((1, 16), np.int32)
        pos = np.full((1, 16), -1, np.int32)
        ids[0, :n] = prompt[start:start + n]
        pos[0, :n] = np.arange(start, start + n)
        ctx = np.array([start + n], np.int32)
        jl, je.pool = je._prefill(jp, je.pool, jnp.asarray(ids), jnp.asarray(pos),
                                  jnp.asarray(table[1:2]), jnp.asarray(ctx),
                                  jnp.asarray(n - 1, jnp.int32))
        tl = te._prefill_logits(te.params, ids, pos, table[1:2], ctx, n - 1)
        assert tl.shape == (1, TINY["vocab_size"])
        assert _norm_err(tl[0].numpy(), np.asarray(jl)) < 1e-5
    # the first token: the penalty sends the argmax elsewhere
    top = int(np.argmax(np.asarray(jl)))
    hist = np.full((1, HISTORY_LEN), -1, np.int32)
    hist[0, -3:] = [prompt[-2], prompt[-1], top]
    samp = {"temperature": np.zeros(1, np.float32), "top_p": np.ones(1, np.float32),
            "min_p": np.zeros(1, np.float32), "top_k": np.full(1, -1, np.int32)}
    pen = {"repetition": np.full(1, 1e4, np.float32),
           "presence": np.zeros(1, np.float32), "frequency": np.zeros(1, np.float32)}
    jtok = je._sample_first(jl, JSamp.make(1, temperature=0.0),
                            JPen.make(1, repetition=1e4), jnp.asarray(hist), je.key)
    ttok = te._sample_first(tl, samp, pen, hist, "greedy", True)
    assert int(jtok) == int(ttok[0]) != top
    # two decode steps of lane 1; lanes 0, 2 and 3 frozen (table -1, PAD)
    last = np.zeros(4, np.int32)
    ctx = np.zeros(4, np.int32)
    active = np.array([0, 1, 0, 0], np.uint8)
    last[1], ctx[1] = int(ttok[0]), 21
    hist4 = np.full((4, HISTORY_LEN), -1, np.int32)
    samp4 = {k: np.repeat(v, 4) for k, v in samp.items()}
    pen4 = {"repetition": np.ones(4, np.float32), "presence": np.zeros(4, np.float32),
            "frequency": np.zeros(4, np.float32)}
    for _ in range(2):
        jt, je.pool, je.key = je._decode(
            jp, je.pool, jnp.asarray(last), jnp.asarray(ctx), jnp.asarray(table),
            jnp.asarray(hist4), JSamp.make(4, temperature=0.0), JPen.make(4),
            jnp.asarray(active.astype(bool)), je.key, sampler_kind="greedy")
        tt, tlog = te._decode(te.params, last, ctx, table, hist4, samp4, pen4,
                              active, "greedy", False)
        assert np.asarray(jt).tolist() == tt.tolist()
        assert tt.tolist()[0] == tt.tolist()[2] == -1
        last[1], ctx[1] = int(tt[1]), ctx[1] + 1
    for name in ("k", "v"):
        want = np.asarray(getattr(je.pool, name))[:, :16]
        got = getattr(te.pool, name)[:, :16].numpy()
        assert np.abs(got - want).max() < 1e-4, name
    assert te.graphs.keys == {("native_prefill", 16, id(te.params)),
                              ("first", "greedy", True, False),
                              ("native", "greedy", False, False, id(te.params))}


def test_steady_native_step_reads_back_once(models, monkeypatch):
    """Once every lane decodes, a native step moves tensors to the host
    once: the step's [B] tokens (no .item(), no bool of a tensor)."""
    sched = _sched(models)
    reqs = [sched.add_request(p, max_new_tokens=10, temperature=0.0)
            for p in PROMPTS.values()]
    sched.step()  # prefills the first chunks
    sched.step()  # the rest of "c"; every lane now decodes
    assert sched.core.decode_view() == 3 and not sched.core.num_waiting
    reads = []
    real_cpu = torch.Tensor.cpu

    def counted(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    def refuse(name):
        def fn(self, *a, **kw):
            raise AssertionError(f"Tensor.{name} inside a native step")
        return fn

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    sched.step()
    monkeypatch.undo()
    assert reads == [(4,)]
    sched.run_to_completion(max_steps=100)
    assert all(len(r.output_ids) == 10 for r in reqs)
