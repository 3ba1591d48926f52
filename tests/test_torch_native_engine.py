"""The native scheduler as the serving backend on the CPU:
``BatchedInferenceEngine(scheduler_impl="native")`` drives the C++ host
runtime under the generate / chat surface, and the OpenAI server answers
concurrent requests over it. Mirrors tests/test_native_engine.py (against
the single stream, concurrent callers, constrained parity, concurrent HTTP
requests) and holds the port against the JAX package on the same weights:
greedy streams against JAX's single-stream engine, a json_schema chat
against JAX's native engine (where JAX's library builds) and, always,
JAX's Python-scheduled batching engine. Then the refusals: an image
prompt, logit bias, XTC and DRY end in a named error on the native path,
where JAX's native path serves XTC and DRY requests without them."""

import asyncio
import dataclasses
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
aiohttp = pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestClient, TestServer

from pie_tpu.engine import InferenceEngine as JEngine
from pie_tpu.engine.async_engine import BatchedInferenceEngine as JBatched
from pie_tpu.tokenizer import Tokenizer as JTokenizer
from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
from pie_tpu_torch.engine.engine import InferenceError
from pie_tpu_torch.server.app import create_app
from pie_tpu_torch.tokenizer import Tokenizer
from pie_tpu_torch.tokenizer.control_tokens import LLAMA3

from test_torch_native_scheduler import jax_native_or_skip, tiny_models

SCHEMA = {
    "type": "object",
    "properties": {"name": {"enum": ["alpha", "beta"]}},
    "required": ["name"],
    "additionalProperties": False,
}
JSON_FORMAT = {"type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def hf_tokenizer():
    """The offline word-level tokenizer of tests/test_native_engine.py (the
    Llama-3 control tokens, a few words and the JSON pieces)."""
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    words = ["hello", "world", "how", "are", "you", "fine", "thanks", "user",
             "assistant", "system", "<unk>"]
    json_pieces = (list('{}[]":,.-0123456789 ')
                   + ['{"', '"}', '": ', '", "', "true", "false", "null"]
                   + list("abcdefghijklmnopqrstuvwxyz")
                   + ["name", "count", "alpha", "beta"])
    specials = LLAMA3.all_control_tokens
    vocab = {w: i for i, w in enumerate(specials + words)}
    for piece in json_pieces:
        if piece not in vocab:
            vocab[piece] = len(vocab)
    raw = RawTok(models.WordLevel(vocab, unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token="<|begin_of_text|>",
        eos_token="<|end_of_text|>", unk_token="<unk>")


@pytest.fixture(scope="module")
def setup():
    """Port and JAX models on the same f32 weights, the port's single-stream
    engine and native batching engine (f32 pages), the JAX tokenizer twin."""
    jm, jp, tm, tp = tiny_models()
    hf = hf_tokenizer()
    tok = Tokenizer(hf, LLAMA3)
    single = InferenceEngine(model=tm, params=tp, tokenizer=tok, max_seq_len=128,
                             kv_dtype=torch.float32, decode_chunk=4,
                             prompt_cache=False, device="cpu")
    native = BatchedInferenceEngine(model=tm, params=tp, tokenizer=tok, num_lanes=4,
                                    num_pages=32, max_pages_per_seq=8,
                                    prefill_chunk=16, kv_dtype=torch.float32,
                                    scheduler_impl="native", device="cpu")
    yield dict(jm=jm, jp=jp, jtok=JTokenizer(hf, LLAMA3), single=single,
               native=native)
    native.shutdown()


def _jax_batched(setup, impl):
    """A JAX batching engine on the same weights with f32 pages (as
    tests/test_native_engine.py casts them)."""
    if impl == "native":
        jax_native_or_skip()
    eng = JBatched(model=setup["jm"], params=setup["jp"], tokenizer=setup["jtok"],
                   num_lanes=4, num_pages=32, max_pages_per_seq=8, prefill_chunk=16,
                   scheduler_impl=impl)
    eng.core.pool = dataclasses.replace(eng.core.pool,
                                        k=eng.core.pool.k.astype(jnp.float32),
                                        v=eng.core.pool.v.astype(jnp.float32))
    return eng


def test_native_engine_matches_single(setup):
    """One greedy request: the native engine's stream is the port's single
    stream and JAX's."""
    prompt = [5, 17, 42, 7]
    want = setup["single"].generate(prompt, max_completion_tokens=10,
                                    temperature=0.0).token_ids
    jax_single = JEngine(model=setup["jm"], params=setup["jp"], max_seq_len=128,
                         kv_dtype=jnp.float32, decode_chunk=4)
    jwant = jax_single.generate(prompt, max_completion_tokens=10,
                                temperature=0.0).token_ids
    res = setup["native"].generate(prompt, max_completion_tokens=10, temperature=0.0)
    assert res.token_ids == want == jwant
    assert res.finish_reason == "length"


def test_native_engine_concurrent(setup):
    single, native = setup["single"], setup["native"]
    prompts = [[5, 17, 42], [9, 3, 3, 7], [11, 13], [2, 4, 6, 8, 10]]
    want = [single.generate(p, max_completion_tokens=8, temperature=0.0).token_ids
            for p in prompts]
    results = {}

    def run(i):
        results[i] = native.generate(prompts[i], max_completion_tokens=8,
                                     temperature=0.0).token_ids

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i in range(4):
        assert results[i] == want[i], i
    sched = native.scheduler
    assert sched.core.num_free_pages == 32 and not sched.requests


@pytest.fixture(scope="module")
def init_weights(setup):
    """The weights of tests/test_native_engine.py (JAX's init, key 1; the
    constrained chat there completes on them) for a port native engine and
    JAX's batching engines."""
    import jax

    from pie_tpu_torch.models.llama import from_jax_params

    from test_torch_llama import jax_to_np

    jp = setup["jm"].init_params(jax.random.PRNGKey(1), dtype=jnp.float32)
    native = BatchedInferenceEngine(
        model=setup["native"].model, params=from_jax_params(jax_to_np(jp), "cpu"),
        tokenizer=setup["native"].tokenizer, num_lanes=4, num_pages=32,
        max_pages_per_seq=8, prefill_chunk=16, kv_dtype=torch.float32,
        scheduler_impl="native", device="cpu")
    yield dict(setup, jp=jp, native=native)
    native.shutdown()


def test_native_failed_step_frees_lanes_and_engine_recovers(setup, monkeypatch):
    """A native decode step that raises fails the requests in flight with
    InferenceError, their lanes and pages come back to the C++ core, and
    the next request is served as before (the port's answer to ROADMAP
    C.3.4 on this path too)."""
    native = setup["native"]
    real = native.core._decode
    calls = []

    def fail_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected device failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(native.core, "_decode", fail_once)
    with pytest.raises(InferenceError, match="scheduler failure"):
        native.generate([5, 17, 42, 7], max_completion_tokens=4, temperature=0.0)
    core = native.scheduler.core
    assert core.num_free_pages == 32 and core.num_running == 0
    assert not native.scheduler.requests
    want = setup["single"].generate([9, 3, 3], max_completion_tokens=4,
                                    temperature=0.0).token_ids
    assert native.generate([9, 3, 3], max_completion_tokens=4,
                           temperature=0.0).token_ids == want


def _schema_chat(engine):
    return engine.chat([{"role": "user", "text": "hello"}],
                       response_format=JSON_FORMAT, max_completion_tokens=64,
                       temperature=0.0)


@pytest.mark.parametrize("impl", ["python", "native"])
def test_native_engine_constrained_parity(init_weights, impl):
    """A json_schema chat on the native scheduler: every token sampled
    under the machine's host mask, the first one after the prefill too. It
    answers valid JSON that ends with "stop", again the same text, and the
    text JAX's native engine gives (where JAX's library builds). JAX's
    Python-scheduled engine answers valid JSON too, but on these weights'
    near ties its mixed steps (M = lanes + rider) pick other tokens than a
    per-token decode, as tests/test_native_engine.py notes: against it the
    comparison is the schema, not the text."""
    setup = init_weights
    inter = _schema_chat(setup["native"])
    assert json.loads(inter.text)["name"] in ("alpha", "beta")
    assert inter.finish_reason == "stop"
    jeng = _jax_batched(setup, impl)
    try:
        want = _schema_chat(jeng)
    finally:
        jeng.shutdown()
    assert want.finish_reason == "stop"
    if impl == "native":
        assert inter.text == want.text
    else:
        assert json.loads(want.text)["name"] in ("alpha", "beta")
    assert _schema_chat(setup["native"]).text == inter.text


def test_server_concurrent_requests_on_native_scheduler(setup):
    """Four concurrent chats answer 200; a logit_bias request answers 400
    with the native scheduler's reason."""
    native = setup["native"]

    async def go():
        app = create_app(engine=native, device="cpu")
        async with TestClient(TestServer(app),
                              timeout=aiohttp.ClientTimeout(total=590)) as client:

            async def one(i, **extra):
                resp = await client.post("/v1/chat/completions", json=dict(
                    model="tiny", messages=[{"role": "user",
                                             "content": f"hello world {i}"}],
                    max_completion_tokens=6, temperature=0.0, **extra))
                return resp.status, await resp.json()

            outs = await asyncio.gather(*[one(i) for i in range(4)])
            biased = await one(9, logit_bias={"20": 5.0})
            return outs, biased

    outs, (status, body) = asyncio.run(go())
    for code, data in outs:
        assert code == 200, data
        assert data["choices"][0]["finish_reason"] in ("stop", "length")
    assert status == 400 and "native scheduler" in body["error"]["message"]


REFUSED = {
    "image": (dict(pixel_values=np.zeros((1, 3, 4, 4), np.float32)), "text requests"),
    "logit_bias": (dict(logit_bias={20: 5.0}), "logit bias"),
    "xtc": (dict(temperature=0.8, xtc_probability=0.5), "XTC"),
    "dry": (dict(dry_multiplier=0.8), "DRY"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_native_refusals(setup, case, monkeypatch):
    """What the native path cannot serve ends in InferenceError naming it;
    the engine serves the next request as before. (The image case gives the
    text model a stand-in tower: the request reaches the scheduler thread,
    which refuses it before any tower runs.)"""
    kw, reason = REFUSED[case]
    native = setup["native"]
    if case == "image":
        monkeypatch.setattr(native.model, "vision", object(), raising=False)
    with pytest.raises(InferenceError, match=reason):
        native.generate([5, 17, 42, 7], max_completion_tokens=4, **kw)
    monkeypatch.undo()
    res = native.generate([5, 17, 42, 7], max_completion_tokens=4, temperature=0.0)
    assert res.token_ids == setup["single"].generate(
        [5, 17, 42, 7], max_completion_tokens=4, temperature=0.0).token_ids


@pytest.mark.parametrize("impl", ["python", "native"])
def test_jax_batched_engines_ignore_xtc_and_dry(setup, impl):
    """Reference defect (ROADMAP C.3.3): JAX's batching engine, on its
    native scheduler and on its Python one, serves XTC and DRY requests
    without them: no error, and the greedy stream of the same request
    without them."""
    jeng = _jax_batched(setup, impl)
    try:
        plain = jeng.generate([5, 17, 42, 7], max_completion_tokens=8,
                              temperature=0.0).token_ids
        res = jeng.generate([5, 17, 42, 7], max_completion_tokens=8, temperature=0.0,
                            xtc_probability=0.5, dry_multiplier=5.0)
    finally:
        jeng.shutdown()
    assert res.finish_reason == "length"
    assert res.token_ids == plain
