"""Constrained decoding under the port's continuous batching
(pie_tpu_torch.engine.async_engine.BatchedInferenceEngine and the
Scheduler's constrained lanes) on the CPU: every test of
tests/test_batched_constrained.py on the port, and greedy constrained lanes
beside free ones against the JAX package's Scheduler on the same model and
tokenizer, token for token (finish reasons and parsed outputs too),
including a lane whose speculated tokens the machine rejects and rolls
back. The model and tokenizer are tests/test_batched_constrained.py's
(dense f32 weights from jax.random.PRNGKey(3), the pools in f32), whose
two packages' logits differ by ~4e-7 (test_torch_constrained_engine)."""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from pie_tpu.engine.scheduler import PagedEngine as JPagedEngine
from pie_tpu.engine.scheduler import Scheduler as JScheduler
from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu.structured import RootStateMachine as JRoot
from pie_tpu.structured.token_masks import TokenMasker as JMasker
from pie_tpu_torch.engine import scheduler as sched_mod
from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
from pie_tpu_torch.structured import RootStateMachine
from pie_tpu_torch.structured.json_machine import JsonMachine
from pie_tpu_torch.structured.token_masks import TokenMasker

from test_batched_constrained import TINY
from test_batched_constrained import _tokenizer as _jax_tokenizer
from test_torch_constrained_engine import port_tokenizer
from test_torch_llama import jax_to_np

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"enum": ["alpha", "beta"]},
        "count": {"type": "integer"},
    },
    "required": ["name", "count"],
    "additionalProperties": False,
}
TOOLS = [{
    "type": "function",
    "function": {
        "name": "get_weather",
        "parameters": {
            "type": "object",
            "properties": {"city": {"type": "string"}},
            "required": ["city"],
            "additionalProperties": False,
        },
    },
}]
HELLO = [{"role": "user", "text": "hello"}]
FREE = ([5, 7, 11], [5, 7, 12], [9, 6, 7, 8], [6, 8, 6, 8, 6])


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = dict(TINY, model_type="llama")
    jm = JModel(JConfig.from_dict(cfg))
    jp = jm.init_params(jax.random.PRNGKey(3), dtype=jnp.float32)
    return jm, jp, LlamaModel(LlamaConfig.from_dict(cfg)), from_jax_params(
        jax_to_np(jp), "cpu")


@pytest.fixture(scope="module")
def engine(models):
    _, _, tm, tp = models
    eng = BatchedInferenceEngine(
        model=tm, params=tp, tokenizer=port_tokenizer(), num_lanes=4,
        num_pages=32, max_pages_per_seq=8, prefill_chunk=16,
        kv_dtype=torch.float32, device="cpu",
    )
    yield eng
    eng.shutdown()


# -- the tests of tests/test_batched_constrained.py, on the port ---------------------


def test_json_schema_constrained_batched_chat(engine):
    inter = engine.chat(
        HELLO,
        response_format={"type": "json_schema",
                         "json_schema": {"name": "t", "schema": SCHEMA}},
        max_completion_tokens=64,
        temperature=0.9,  # even at high temperature the mask forces validity
    )
    data = json.loads(inter.text)
    assert data["name"] in ("alpha", "beta")
    assert isinstance(data["count"], int)
    assert inter.finish_reason == "stop"


def test_forced_tool_call_batched(engine):
    inter = engine.chat(HELLO, tools=TOOLS, tool_choice="required",
                        max_completion_tokens=80, temperature=1.0)
    assert inter.finish_reason == "tool_calls"
    calls = inter.tool_calls
    assert calls and calls[0]["name"] == "get_weather"
    assert "city" in calls[0]["arguments"]


def test_constrained_and_freeform_lanes_coexist(engine):
    """A constrained request and plain ones decode at once; the constrained
    lane's mask does not leak onto the other lanes, whose greedy tokens are
    those they give alone. The constrained chat samples at 0.8 on a shared
    generator whose draws depend on how the threads' requests meet in
    chunks; its budget is 128 tokens (the JAX test's 64 is met by ~98 % of
    such outputs on this model: 59 of 60 seeds of the single stream ended
    within 42 tokens, one took 65)."""
    results = {}

    def constrained():
        results["c"] = engine.chat(
            HELLO,
            response_format={"type": "json_schema",
                             "json_schema": {"name": "t", "schema": SCHEMA}},
            max_completion_tokens=128, temperature=0.8)

    def freeform(i):
        results[f"f{i}"] = engine.generate([5, 7, 11 + i], max_completion_tokens=12,
                                           temperature=0.0)

    threads = [threading.Thread(target=constrained)] + [
        threading.Thread(target=freeform, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    data = json.loads(results["c"].text)
    assert data["name"] in ("alpha", "beta")
    for i in range(2):
        res = results[f"f{i}"]
        assert res.finish_reason in ("stop", "length")
        assert len(res.token_ids) == 12
        alone = engine.generate([5, 7, 11 + i], max_completion_tokens=12,
                                temperature=0.0)
        assert res.token_ids == alone.token_ids


def test_logit_bias_batched(engine):
    forced = engine.tokenizer.encode("alpha")[-1]
    res = engine.generate([5, 7, 11], max_completion_tokens=6, temperature=0.0,
                          logit_bias={int(forced): 1000.0})
    assert res.finish_reason in ("stop", "length")
    assert all(t == forced for t in res.token_ids), res.token_ids


def test_per_state_sampler_switching_batched(engine, monkeypatch):
    """Reasoning + tool call under batching: the <think> phase dispatches
    at the request's temperature, the tool-call phase at 0 (state_kwargs),
    in that order."""
    st = RootStateMachine(engine.tokenizer.control_tokens).configure(
        tools=TOOLS, tool_choice="required", reasoning=True)
    assert st.state_kwargs == {"tool_call": {"temperature": 0.0, "min_p": 0.02}}
    seen = []
    orig = sched_mod.sampler_kind_for

    def recording(temps, *a, **kw):
        seen.extend(float(t) for t in np.asarray(temps).ravel())
        return orig(temps, *a, **kw)

    close_id = engine.tokenizer.encode("</think>")[-1]
    monkeypatch.setattr(sched_mod, "sampler_kind_for", recording)
    result, text = engine.generate_constrained(
        [5, 6], st.machine, max_completion_tokens=80, temperature=0.9,
        state_kwargs=st.state_kwargs, logit_bias={int(close_id): 50.0})
    assert result.finish_reason in ("tool_calls", "length")
    assert text.startswith("<think>") and '{"' in text
    assert any(abs(t - 0.9) < 1e-6 for t in seen), seen
    assert any(t == 0.0 for t in seen), seen
    last_hot = max(i for i, t in enumerate(seen) if abs(t - 0.9) < 1e-6)
    first_cold = min(i for i, t in enumerate(seen) if t == 0.0)
    assert last_hot < first_cold, seen


def _chunks_until_free_done(engine, n_free: int, with_constrained: bool):
    """Run n_free plain chats (and optionally one json_schema chat) at once;
    the scheduler chunks dispatched when the last plain one finished."""
    sched = engine.scheduler
    lock = threading.Lock()
    stats = {"chunks": 0, "free_done": 0, "free_done_at": 0}
    orig = sched.step

    def counting_step():
        with lock:
            stats["chunks"] += 1
        return orig()

    sched.step = counting_step
    try:
        def free():
            engine.chat(HELLO, max_completion_tokens=24, temperature=0.0)
            with lock:
                stats["free_done"] += 1
                if stats["free_done"] == n_free:
                    stats["free_done_at"] = stats["chunks"]

        def cons():
            engine.chat(HELLO, response_format={
                "type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}},
                max_completion_tokens=24, temperature=0.0)

        threads = [threading.Thread(target=free) for _ in range(n_free)]
        if with_constrained:
            threads.append(threading.Thread(target=cons))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sched.step = orig
    return stats["free_done_at"] or stats["chunks"]


def test_constrained_lane_keeps_free_lanes_chunked(engine):
    """A json_schema request does not collapse the chunks of the free lanes
    to single steps: they finish in a comparable number of chunks."""
    baseline = _chunks_until_free_done(engine, n_free=3, with_constrained=False)
    mixed = _chunks_until_free_done(engine, n_free=3, with_constrained=True)
    assert mixed <= 2 * baseline + 4, (mixed, baseline)
    assert mixed < 20, (mixed, baseline)


# -- against the JAX Scheduler ---------------------------------------------------------


def _machines(kind, jtok, ttok):
    """(JAX machine, port machine, state_kwargs, generation kwargs) of a
    request kind."""
    kw = {"json_schema": dict(response_format={
              "type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}),
          "tool": dict(tools=TOOLS, tool_choice="required"),
          "reasoning": dict(response_format={"type": "json_object"}, reasoning=True),
          }[kind]
    jst = JRoot(jtok.control_tokens).configure(**kw)
    tst = RootStateMachine(ttok.control_tokens).configure(**kw)
    assert tst.state_kwargs == jst.state_kwargs
    return jst.machine, tst.machine, tst.state_kwargs, tst.generation_kwargs


def _run_both(models, constrained, free=FREE, decode_steps=8, max_new=40):
    """The same requests through the JAX Scheduler and the port's, greedy:
    ``constrained`` [(prompt, kind)], each with its machine, then the free
    ``free`` prompts. Returns the JAX and port sequences."""
    jm, jp, tm, tp = models
    jtok, ttok = _jax_tokenizer(), port_tokenizer()
    jmask, tmask = JMasker(jtok), TokenMasker(ttok)
    geo = dict(num_lanes=8, num_pages=64, max_pages_per_seq=8, prefill_chunk=16)
    js = JScheduler(JPagedEngine(jm, jp, kv_dtype=jnp.float32, **geo),
                    decode_steps=decode_steps)
    ts = Scheduler(PagedEngine(tm, tp, kv_dtype=torch.float32, device="cpu", **geo),
                   decode_steps=decode_steps)
    out = ([], [])
    for prompt, kind in constrained:
        jmach, tmach, skw, gkw = _machines(kind, jtok, ttok)
        kw = dict(max_new_tokens=max_new, temperature=gkw.get("temperature", 0.0),
                  stop_token_ids=tuple(ttok.stop_tokens), state_kwargs=skw)
        out[0].append(js.add_request(prompt, machine=jmach, masker=jmask, **kw))
        out[1].append(ts.add_request(prompt, machine=tmach.copy(), masker=tmask, **kw))
    for prompt in free:
        for sch, seqs in zip((js, ts), out):
            seqs.append(sch.add_request(prompt, max_new_tokens=max_new, temperature=0.0))
    js.run_to_completion(max_steps=2000)
    ts.run_to_completion(max_steps=2000)
    return out


def _text(masker, ids):
    return "".join(masker.token_strs[t] for t in ids
                   if t < masker.vocab_size and masker.token_strs[t] is not None)


@pytest.mark.parametrize("kinds", [("json_schema",), ("tool",), ("reasoning",),
                                   ("json_schema", "tool")])
def test_constrained_lanes_match_jax_scheduler(models, kinds):
    """Greedy constrained lanes beside four free lanes: every lane's tokens
    and finish reason equal the JAX Scheduler's; the free lanes give the
    tokens they give with no constrained neighbour, and the constrained
    lanes' text parses where the machine completed (a stop token may end a
    lane first; its text is then a valid prefix)."""
    prompt = port_tokenizer().apply_chat_template(HELLO, add_generation_prompt=True)
    jseqs, tseqs = _run_both(models, [(prompt, k) for k in kinds])
    for j, t in zip(jseqs, tseqs):
        assert (t.output_ids, t.finish_reason) == (j.output_ids, j.finish_reason)
    _, alone = _run_both(models, [])
    assert [s.output_ids for s in tseqs[len(kinds):]] == [s.output_ids for s in alone]
    masker = TokenMasker(port_tokenizer())
    stops = set(port_tokenizer().stop_tokens)
    for seq, kind in zip(tseqs, kinds):
        text = _text(masker, [t for t in seq.output_ids if t not in stops])
        if seq.machine.is_complete and kind != "reasoning":
            json.loads(text)
        elif kind == "json_schema":
            assert JsonMachine(SCHEMA).advance(text)


def test_rejected_speculation_rolls_back(models, monkeypatch):
    """A constrained lane's unmasked (speculated) tokens that the machine
    rejects are dropped and the lane rolled back to the host's truth: the
    run meets at least one rejection, and its tokens still equal the JAX
    Scheduler's and the port's single-stream engine's."""
    from test_torch_constrained_engine import make_pair

    rejected = []
    orig = Scheduler._emit_constrained

    def spy(self, seq, tok, masked=True):
        ok = orig(self, seq, tok, masked)
        if not ok and not masked:
            rejected.append(tok)
        return ok

    monkeypatch.setattr(Scheduler, "_emit_constrained", spy)
    resyncs = []
    orig_resync = Scheduler._resync_lane
    monkeypatch.setattr(Scheduler, "_resync_lane",
                        lambda self, lane, seq: (resyncs.append(len(seq.output_ids)),
                                                 orig_resync(self, lane, seq))[1])
    prompt = [1, 2, 3]
    jseqs, tseqs = _run_both(models, [(prompt, "json_schema")], free=(), max_new=48)
    assert rejected and resyncs
    assert (tseqs[0].output_ids, tseqs[0].finish_reason) == (
        jseqs[0].output_ids, jseqs[0].finish_reason)
    _, single = make_pair()
    res, _ = single.generate_constrained(prompt, JsonMachine(SCHEMA),
                                         max_completion_tokens=48, temperature=0.0,
                                         stop_token_ids=port_tokenizer().stop_tokens)
    assert res.token_ids == tseqs[0].output_ids


def test_batched_generate_constrained_matches_single_stream(engine):
    """BatchedInferenceEngine.generate_constrained, greedy, gives the single
    stream's tokens, finish reason and text."""
    from test_torch_constrained_engine import make_pair

    _, single = make_pair()
    for kind in ("json_schema", "tool"):
        _, mach, skw, gkw = _machines(kind, _jax_tokenizer(), engine.tokenizer)
        kw = dict(max_completion_tokens=40, temperature=0.0, state_kwargs=skw)
        b = engine.generate_constrained([1, 2, 3], mach, **kw)
        s = single.generate_constrained([1, 2, 3], mach, **kw)
        assert (b[0].token_ids, b[0].finish_reason, b[1]) == (
            s[0].token_ids, s[0].finish_reason, s[1])
