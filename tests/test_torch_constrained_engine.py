"""Constrained decoding on the port's single-stream engine
(pie_tpu_torch.engine.InferenceEngine.generate_constrained and the chat
API's structured branch) against the JAX package's engine on the same tiny
model and the same offline tokenizer: every test of
tests/test_constrained_engine.py on the port, and the greedy token streams,
parsed outputs, finish reasons and logprobs of each against JAX's. Sampled
requests are checked for validity and, at one choice point, by
distribution.

The model is tests/test_constrained_engine.py's own: TINY Llama, dense f32
weights from jax.random.PRNGKey(3), carried across with from_jax_params. No
bf16 cast separates the two packages' logits there (they differ by at most
~4e-7 on logits of ~0.5), and test_greedy_margins_clear_the_noise checks
that every masked greedy choice point used here has a top-2 logprob margin
above 1e-4, the tolerance logprobs are held to: equal greedy streams are
the test, not luck, and no near-tie was met on these prompts."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from pie_tpu.engine import InferenceEngine as JEngine
from pie_tpu.models.llama import LlamaConfig as JConfig
from pie_tpu.models.llama import LlamaModel as JModel
from pie_tpu.structured import RootStateMachine as JRoot
from pie_tpu.structured.json_machine import JsonMachine as JJson
from pie_tpu_torch.cache.prompt_cache import PromptCache
from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
from pie_tpu_torch.structured import RootStateMachine
from pie_tpu_torch.structured.json_machine import JsonMachine
from pie_tpu_torch.tokenizer import Tokenizer
from pie_tpu_torch.tokenizer.control_tokens import LLAMA3

from test_constrained_engine import TINY
from test_constrained_engine import _tokenizer as _jax_tokenizer
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
ONE_NAME = {
    "type": "object",
    "properties": {"name": {"enum": ["alpha", "beta"]}},
    "required": ["name"],
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


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_tokenizer():
    """The same offline word-level tokenizer, in the port's wrapper."""
    return Tokenizer(_jax_tokenizer()._tok, LLAMA3)


def weights():
    """TINY's dense f32 weights, as tests/test_constrained_engine.py makes
    them."""
    cfg = dict(TINY, model_type="llama")
    jm = JModel(JConfig.from_dict(cfg))
    return cfg, jm, jm.init_params(jax.random.PRNGKey(3), dtype=jnp.float32)


def make_pair(**kw):
    cfg, jm, jp = weights()
    kw = dict(max_seq_len=128, decode_chunk=4, **kw)
    je = JEngine(model=jm, params=jp, tokenizer=_jax_tokenizer(),
                 kv_dtype=jnp.float32, **kw)
    te = InferenceEngine(model=LlamaModel(LlamaConfig.from_dict(cfg)),
                         params=from_jax_params(jax_to_np(jp), "cpu"),
                         tokenizer=port_tokenizer(), kv_dtype=torch.float32,
                         device="cpu", **kw)
    return je, te


@pytest.fixture(scope="module")
def engines():
    return make_pair()


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


def both_constrained(engines, prompt, schema=None, machines=None, **kw):
    """generate_constrained on both engines: (JAX result, JAX text), (port
    result, port text)."""
    je, te = engines
    jmach, tmach = machines or (JJson(schema), JsonMachine(schema))
    return (je.generate_constrained(prompt, jmach, **kw),
            te.generate_constrained(prompt, tmach, **kw))


def assert_same(j, t):
    (jr, jtext), (tr, ttext) = j, t
    assert tr.token_ids == jr.token_ids
    assert ttext == jtext
    assert (tr.finish_reason, tr.prompt_tokens, tr.completion_tokens) == (
        jr.finish_reason, jr.prompt_tokens, jr.completion_tokens)


def chat_both(engines, **kw):
    je, te = engines
    return je.chat(HELLO, **kw), te.chat(HELLO, **kw)


def assert_same_chat(j, t):
    assert t.text == j.text
    assert t.metadata["token_ids"] == j.metadata["token_ids"]
    assert t.finish_reason == j.finish_reason
    assert t.metadata.get("reasoning_content") == j.metadata.get("reasoning_content")
    assert t.tool_calls == j.tool_calls


# -- the tests of tests/test_constrained_engine.py, on the port ----------------------


@pytest.mark.parametrize("sampling", ["hot", "greedy"])
def test_json_schema_constrained_chat(engines, sampling):
    """The JAX test at temperature 0.9 (the mask forces validity), and the
    same request greedy on both packages."""
    rf = {"type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}
    if sampling == "greedy":
        # greedy on this model pads with whitespace and runs out of tokens,
        # in both packages alike: a valid prefix of the schema's output
        j, inter = chat_both(engines, response_format=rf, max_completion_tokens=64,
                             temperature=0.0)
        assert_same_chat(j, inter)
        assert inter.finish_reason == "length"
        assert JsonMachine(SCHEMA).advance(inter.text)
        return
    inter = engines[1].chat(HELLO, response_format=rf, max_completion_tokens=64,
                            temperature=0.9)
    data = json.loads(inter.text)
    assert data["name"] in ("alpha", "beta")
    assert isinstance(data["count"], int)
    assert inter.finish_reason == "stop"


@pytest.mark.parametrize("sampling", ["warm", "greedy"])
def test_json_object_mode(engines, sampling):
    kw = dict(response_format={"type": "json_object"}, max_completion_tokens=200)
    if sampling == "warm":
        inter = engines[1].chat(HELLO, temperature=0.3, **kw)
    else:
        j, inter = chat_both(engines, temperature=0.0, **kw)
        assert_same_chat(j, inter)
    if inter.finish_reason == "stop":
        assert isinstance(json.loads(inter.text), dict)
    else:
        # the budget ran out inside the structure: the text is still a valid
        # prefix of a JSON object (every emitted token was mask-approved)
        assert JsonMachine({"type": "object"}).advance(inter.text)


@pytest.mark.parametrize("sampling", ["hot", "greedy"])
def test_forced_tool_call(engines, sampling):
    kw = dict(tools=TOOLS, tool_choice="required", max_completion_tokens=80)
    if sampling == "hot":
        inter = engines[1].chat(HELLO, temperature=1.0, **kw)
    else:
        j, inter = chat_both(engines, temperature=0.0, **kw)
        assert_same_chat(j, inter)
    assert inter.finish_reason == "tool_calls"
    calls = inter.tool_calls
    assert calls and calls[0]["name"] == "get_weather"
    assert "city" in calls[0]["arguments"]


def test_constrained_forced_fast_path(engines):
    """Tokens the machine fixes are emitted with no device program: a
    schema whose output is fully forced takes fewer prefills than tokens,
    and both packages take the same number."""
    schema = {
        "type": "object",
        "properties": {"name": {"enum": ["alpha"]}},
        "required": ["name"],
        "additionalProperties": False,
    }
    counts = []
    for eng in engines:
        calls = {"n": 0}
        orig = eng.core._prefill

        def counting(*a, _orig=orig, _calls=calls, **kw):
            _calls["n"] += 1
            return _orig(*a, **kw)

        eng.core._prefill = counting
        try:
            out = eng.generate_constrained([1, 2, 3], (JJson if eng is engines[0]
                                                       else JsonMachine)(schema),
                                           max_completion_tokens=64, temperature=0.0)
        finally:
            eng.core._prefill = orig
        counts.append((calls["n"], out))
    (jn, j), (tn, t) = counts
    assert_same(j, t)
    result, text = t
    assert json.loads(text) == {"name": "alpha"}
    assert result.finish_reason == "stop"
    assert tn == jn < result.completion_tokens


def test_constrained_logprobs_and_stop(engines):
    """Logprobs: forced tokens report 0.0 with no top list, sampled ones
    their top-k, within test_torch_engine's 1e-4 of JAX's; a stop token
    ends generation in the middle of the machine, as in JAX."""
    j, t = both_constrained(engines, [1, 2, 3], ONE_NAME, max_completion_tokens=64,
                            temperature=0.0, logprobs=True)
    assert_same(j, t)
    result = t[0]
    assert result.finish_reason == "stop"
    assert len(result.logprobs) == result.completion_tokens
    assert any(lp.logprob == 0.0 and lp.top == [] for lp in result.logprobs)
    assert all(lp.logprob <= 0.0 for lp in result.logprobs)
    for a, b in zip(result.logprobs, j[0].logprobs):
        assert a.token_id == b.token_id
        assert abs(a.logprob - b.logprob) < 1e-4
        assert len(a.top) == len(b.top)
        # the allowed tokens' entries; masked ones tie at -1e30 and either
        # package may list any of them
        a_ok, b_ok = ([(i, v) for i, v in x.top if v > -1e29] for x in (a, b))
        assert [i for i, _ in a_ok] == [i for i, _ in b_ok]
        np.testing.assert_allclose([v for _, v in a_ok], [v for _, v in b_ok],
                                   rtol=0, atol=1e-4)

    eot = engines[1].tokenizer.stop_tokens[0]
    j2, t2 = both_constrained(engines, [1, 2, 3], ONE_NAME, max_completion_tokens=64,
                              temperature=0.0, stop_token_ids=[eot],
                              logit_bias={eot: 50.0})
    assert_same(j2, t2)
    assert t2[0].finish_reason in (
        "stop", "length", "error: constrained decoding produced invalid token")


def test_reasoning_chat_state(engines):
    """reasoning=True: <think>...</think> and then the structured output,
    which labeled_output reads without the think block."""
    rf = {"type": "json_schema", "json_schema": {"schema": {
        "type": "object",
        "properties": {"name": {"enum": ["alpha"]}},
        "required": ["name"], "additionalProperties": False,
    }}}
    jst = JRoot(engines[0].tokenizer.control_tokens).configure(
        response_format=rf, reasoning=True)
    st = RootStateMachine(engines[1].tokenizer.control_tokens).configure(
        response_format=rf, reasoning=True)
    j, t = both_constrained(engines, [1, 2, 3], machines=(jst.machine, st.machine),
                            max_completion_tokens=200, temperature=0.0)
    assert_same(j, t)
    result, text = t
    assert text.startswith("<think>")
    if result.finish_reason == "stop":
        label, value = RootStateMachine.labeled_output(st, text)
        assert label == "json"
        assert value == {"name": "alpha"}


def test_per_state_sampler_switching(engines):
    """Reasoning + tool call: the <think> phase samples at the request's
    temperature, the tool-call phase at temperature 0 (state_kwargs), in
    that order, as the JAX engine does."""
    st = RootStateMachine(engines[1].tokenizer.control_tokens).configure(
        tools=TOOLS, tool_choice="required", reasoning=True)
    assert st.state_kwargs == {"tool_call": {"temperature": 0.0, "min_p": 0.02}}
    assert st.generation_kwargs == {}
    engine = engines[1]
    seen = []
    orig = engine.core._prefill

    def recording(params, state, ids, lens, first, sampling, *a, **kw):
        seen.append(float(sampling.temperature[0]))
        return orig(params, state, ids, lens, first, sampling, *a, **kw)

    close_id = engine.tokenizer.encode("</think>")[-1]
    engine.core._prefill = recording
    try:
        engine.generate_constrained(
            [5, 6], st.machine, max_completion_tokens=60, temperature=0.9,
            state_kwargs=st.state_kwargs, logit_bias={close_id: 50.0})
    finally:
        engine.core._prefill = orig
    assert any(abs(t - 0.9) < 1e-6 for t in seen), seen
    assert any(t == 0.0 for t in seen), seen
    last_hot = max(i for i, t in enumerate(seen) if abs(t - 0.9) < 1e-6)
    first_cold = min(i for i, t in enumerate(seen) if t == 0.0)
    assert last_hot < first_cold, seen


@pytest.mark.parametrize("sampling", ["warm", "greedy"])
def test_reasoning_chat_response(engines, sampling):
    """reasoning=True: the response keeps reasoning_content apart from the
    visible answer."""
    kw = dict(response_format={"type": "json_object"}, reasoning=True,
              max_completion_tokens=200)
    if sampling == "warm":
        inter = engines[1].chat(HELLO, temperature=0.3, **kw)
    else:
        j, inter = chat_both(engines, temperature=0.0, **kw)
        assert_same_chat(j, inter)
    assert inter.metadata.get("reasoning_content") is not None
    assert "<think>" not in (inter.text or "")


# -- beyond the JAX tests --------------------------------------------------------------


def test_greedy_margins_clear_the_noise(engines):
    """Every masked choice point of the greedy chats above has a top-2
    logprob margin above 1e-4, the tolerance the two packages' logprobs
    are held to (their logits differ by at most ~4e-7 here)."""
    rf = {"type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}
    je = engines[0]
    margins = []
    root = JRoot(je.tokenizer.control_tokens)
    for kw in (dict(response_format=rf), dict(response_format={"type": "json_object"}),
               dict(tools=TOOLS, tool_choice="required"),
               dict(response_format={"type": "json_object"}, reasoning=True)):
        st = root.configure(**kw)
        prompt = je.tokenizer.apply_chat_template(HELLO, add_generation_prompt=True,
                                                  tools=kw.get("tools"))
        merged = {"temperature": 0.0, **st.generation_kwargs}
        if st.state_kwargs:
            merged["state_kwargs"] = st.state_kwargs
        res, _ = je.generate_constrained(prompt, st.machine, 200, logprobs=True,
                                         **merged)
        for lp in res.logprobs:
            allowed = [v for _, v in lp.top if v > -1e29]
            if len(allowed) >= 2:
                margins.append(allowed[0] - allowed[1])
    assert margins and min(margins) > 1e-4, sorted(margins)[:5]


def test_unconstrained_after_constrained_matches_fresh_engine(engine):
    """A constrained request writes the core's one DecodeState in place,
    which every captured decode step reads: an unconstrained greedy request
    after it gives the tokens of a fresh engine."""
    prompt = [9, 6, 7, 8, 6, 7, 8, 5]
    engine.generate_constrained([1, 2, 3], JsonMachine(SCHEMA),
                                max_completion_tokens=40, temperature=0.0)
    got = engine.generate(prompt, max_completion_tokens=12, temperature=0.0)
    fresh = InferenceEngine(model=engine.model, params=engine.params,
                            tokenizer=engine.tokenizer, max_seq_len=128,
                            decode_chunk=4, kv_dtype=torch.float32, device="cpu")
    assert got.token_ids == fresh.generate(prompt, max_completion_tokens=12,
                                           temperature=0.0).token_ids


def test_prompt_cache_after_constrained_request():
    """Difference from the JAX package (ROADMAP C): its generate_constrained
    writes the KV of its prompt from position 0 but leaves the prompt cache
    claiming an earlier request's tokens, so an unconstrained request that
    repeats that earlier prompt reuses overwritten KV. The port's prompt
    cache claims what the constrained request wrote, so the repeat gives a
    fresh engine's tokens; the JAX engine's differ."""
    je, te = make_pair()
    a = [9, 6, 7, 8, 6, 7, 8, 5, 9, 6, 7]
    outs = []
    for eng, mach in ((je, JJson(SCHEMA)), (te, JsonMachine(SCHEMA))):
        first = eng.generate(a, max_completion_tokens=8, temperature=0.0).token_ids
        eng.generate_constrained(a[:2] + [1, 2, 3, 4, 5, 6, 7, 8], mach,
                                 max_completion_tokens=40, temperature=0.0)
        again = eng.generate(a, max_completion_tokens=8, temperature=0.0).token_ids
        outs.append((first, again))
    (jfirst, jagain), (tfirst, tagain) = outs
    assert tfirst == jfirst
    assert tagain == tfirst  # the port: as a fresh engine
    assert jagain != jfirst  # the JAX engine: stale prefix KV
    claimed = te.prompt_cache.computed_ids
    assert claimed[:len(a)] == a


def test_constrained_request_with_a_fresh_prompt_cache(engine):
    """After a constrained request the prompt cache claims the prompt and
    the output tokens whose KV was written: a continuation of that text
    reuses the prefix and decodes as a cold engine does."""
    engine.prompt_cache = PromptCache()
    res, _ = engine.generate_constrained([1, 2, 3], JsonMachine(SCHEMA),
                                         max_completion_tokens=40, temperature=0.0)
    claimed = engine.prompt_cache.computed_ids
    assert claimed[:3] == [1, 2, 3] and claimed[3:] == res.token_ids[:len(claimed) - 3]
    follow = claimed + [6, 7]
    assert engine.prompt_cache.reuse_prefix(follow) == len(claimed)
    warm = engine.generate(follow, max_completion_tokens=6, temperature=0.0).token_ids
    cold = InferenceEngine(model=engine.model, params=engine.params, max_seq_len=128,
                           decode_chunk=4, kv_dtype=torch.float32, prompt_cache=False,
                           device="cpu")
    assert warm == cold.generate(follow, max_completion_tokens=6,
                                 temperature=0.0).token_ids


def test_first_choice_point_distribution(engines):
    """A sampled choice point is compared by distribution (as
    tests/test_sampling.py does): the port's first token of a json_schema
    request at temperature 1, over 600 requests, against the masked
    softmax the JAX engine reports for the same choice point (atol 0.06)."""
    je, te = engines
    res, _ = je.generate_constrained([1, 2, 3], JJson(SCHEMA), max_completion_tokens=1,
                                     temperature=1.0, logprobs=True)
    want = {i: np.exp(v) for i, v in res.logprobs[0].top if v > -1e29}
    assert sum(want.values()) > 0.99 and len(want) >= 2
    draws = [te.generate_constrained([1, 2, 3], JsonMachine(SCHEMA),
                                     max_completion_tokens=1,
                                     temperature=1.0)[0].token_ids[0]
             for _ in range(600)]
    assert set(draws) <= set(want)
    got = np.array([draws.count(i) / len(draws) for i in want])
    np.testing.assert_allclose(got, list(want.values()), atol=0.06)
