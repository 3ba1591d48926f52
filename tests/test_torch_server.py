"""The port's OpenAI-compatible server (pie_tpu_torch.server) on the CPU:
aiohttp TestClient, tiny model, offline tokenizer. Covers chat (non-stream
+ SSE stream + usage chunk), completions, responses, logprobs, error
mapping, and the settings that are refused."""

import asyncio
import json

import pytest
import torch

transformers = pytest.importorskip("transformers")
aiohttp = pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestClient, TestServer

from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel
from pie_tpu_torch.server.app import create_app
from pie_tpu_torch.server.config import Settings
from pie_tpu_torch.tokenizer import Tokenizer
from pie_tpu_torch.tokenizer.control_tokens import LLAMA3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

TINY = dict(
    hidden_size=64,
    intermediate_size=128,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    vocab_size=256,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    max_position_embeddings=256,
    tie_word_embeddings=False,
)


def _tiny_tokenizer():
    from tokenizers import Tokenizer as RawTok, models, pre_tokenizers

    words = [
        "hello", "world", "how", "are", "you", "fine", "thanks", "user",
        "assistant", "system", "weather", "sunny", "<unk>",
    ]
    specials = LLAMA3.all_control_tokens
    vocab = {w: i for i, w in enumerate(specials + words)}
    raw = RawTok(models.WordLevel(vocab, unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    hf = transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token="<|begin_of_text|>",
        eos_token="<|end_of_text|>", unk_token="<unk>",
    )
    return Tokenizer(hf, LLAMA3)


@pytest.fixture(scope="module")
def engine_fixture():
    config = LlamaConfig.from_dict(dict(TINY, model_type="llama"))
    model = LlamaModel(config)
    params = model.init_params(seed=1, dtype=torch.float32, device="cpu")
    return InferenceEngine(
        model=model, params=params, tokenizer=_tiny_tokenizer(),
        max_seq_len=128, kv_dtype=torch.float32, decode_chunk=4,
        device="cpu",
    )


def _call(engine, coro_fn):
    # aiohttp Applications cannot be restarted across event loops; build a
    # fresh app (cheap) around the warm module-scoped engine per test
    async def run():
        app = create_app(engine=engine, settings=Settings(), device="cpu")
        async with TestClient(
            TestServer(app), timeout=aiohttp.ClientTimeout(total=590)
        ) as client:
            return await coro_fn(client)

    return asyncio.run(run())


def test_health(engine_fixture):
    async def go(client):
        resp = await client.get("/health")
        assert resp.status == 200
        return await resp.json()

    assert _call(engine_fixture, go)["status"] == "ok"


def test_chat_completion(engine_fixture):
    async def go(client):
        resp = await client.post(
            "/v1/chat/completions",
            json={
                "model": "tiny",
                "messages": [{"role": "user", "content": "hello world"}],
                "max_tokens": 8,
                "temperature": 0.0,
            },
        )
        assert resp.status == 200, await resp.text()
        return await resp.json()

    data = _call(engine_fixture, go)
    assert data["object"] == "chat.completion"
    choice = data["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["finish_reason"] in ("stop", "length")
    assert data["usage"]["prompt_tokens"] > 0
    assert data["usage"]["completion_tokens"] > 0


def test_chat_streaming_sse(engine_fixture):
    # random weights mostly pick ids the tiny tokenizer decodes to nothing:
    # a logit_bias on an in-vocab word makes content chunks certain
    hello = engine_fixture.tokenizer.encode("hello", add_bos=False)[0]

    async def go(client):
        resp = await client.post(
            "/v1/chat/completions",
            json={
                "messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 6,
                "temperature": 0.0,
                "stream": True,
                "stream_options": {"include_usage": True},
                "logit_bias": {str(hello): 100.0},
            },
        )
        assert resp.status == 200
        body = (await resp.read()).decode()
        return body

    body = _call(engine_fixture, go)
    events = [
        json.loads(line[6:])
        for line in body.splitlines()
        if line.startswith("data: ") and line != "data: [DONE]"
    ]
    assert body.rstrip().endswith("data: [DONE]")
    # first chunk carries the role
    assert events[0]["choices"][0]["delta"].get("role") == "assistant"
    # some content chunk exists
    assert any(
        e["choices"] and e["choices"][0]["delta"].get("content")
        for e in events
    )
    # a finish chunk exists
    assert any(
        e["choices"] and e["choices"][0].get("finish_reason") for e in events
    )
    # usage chunk included
    assert any(e.get("usage") for e in events)


def test_completions(engine_fixture):
    async def go(client):
        resp = await client.post(
            "/v1/completions",
            json={"prompt": "hello world how", "max_tokens": 5,
                  "temperature": 0.0, "logprobs": 2},
        )
        assert resp.status == 200, await resp.text()
        return await resp.json()

    data = _call(engine_fixture, go)
    assert data["object"] == "text_completion"
    assert isinstance(data["choices"][0]["text"], str)
    lp = data["choices"][0]["logprobs"]
    assert lp is not None and len(lp["tokens"]) == len(lp["token_logprobs"])


def test_responses_api(engine_fixture):
    async def go(client):
        resp = await client.post(
            "/v1/responses",
            json={"input": "hello", "instructions": "you are fine",
                  "max_output_tokens": 5, "temperature": 0.0},
        )
        assert resp.status == 200, await resp.text()
        return await resp.json()

    data = _call(engine_fixture, go)
    assert data["object"] == "response"
    assert data["output"][0]["type"] == "message"
    assert data["usage"]["input_tokens"] > 0


def test_invalid_request_422(engine_fixture):
    async def go(client):
        resp = await client.post("/v1/chat/completions", json={"messages": "x"})
        return resp.status

    assert _call(engine_fixture, go) == 422


def test_completions_streaming_501(engine_fixture):
    async def go(client):
        resp = await client.post(
            "/v1/completions", json={"prompt": "hello", "stream": True}
        )
        return resp.status

    assert _call(engine_fixture, go) == 501


def test_completions_logit_bias_forces_text(engine_fixture):
    """A logit_bias that forces an in-vocab word makes the text non-empty."""
    hello = engine_fixture.tokenizer.encode("hello", add_bos=False)[0]

    async def go(client):
        resp = await client.post(
            "/v1/completions",
            json={"prompt": "hello world", "max_tokens": 3,
                  "temperature": 0.0, "logit_bias": {str(hello): 100.0}},
        )
        assert resp.status == 200, await resp.text()
        return await resp.json()

    assert "hello" in _call(engine_fixture, go)["choices"][0]["text"]


def test_unported_settings_raise(engine_fixture):
    """BATCHING=1 refuses the single-stream engine; MODEL_PATH must name a
    checkpoint, with or without BATCHING=1, on either scheduler
    (NATIVE_SCHEDULER=1 picks the C++ one)."""
    with pytest.raises(ValueError, match="BATCHING"):
        create_app(engine=engine_fixture, settings=Settings(batching=True),
                   device="cpu")
    for batching, native in ((False, False), (True, False), (True, True)):
        with pytest.raises(FileNotFoundError, match="nonexistent"):
            create_app(settings=Settings(model_path="/nonexistent", batching=batching,
                                         native_scheduler=native), device="cpu")


def test_constrained_request_is_refused(engine_fixture):
    """response_format pins the output shape. The port decodes it under the
    constraint now (no longer refused): over the tokenizer of
    tests/test_constrained_engine.py, which has the JSON pieces, a
    json_schema chat answers 200 with content that parses to the schema,
    and a named tool_choice answers with parsed tool_calls."""
    from test_torch_constrained_engine import port_tokenizer

    engine = InferenceEngine(model=engine_fixture.model, params=engine_fixture.params,
                             tokenizer=port_tokenizer(), max_seq_len=128,
                             kv_dtype=torch.float32, decode_chunk=4, device="cpu")
    schema = {"type": "object", "properties": {"name": {"enum": ["alpha", "beta"]}},
              "required": ["name"], "additionalProperties": False}
    tools = [{"type": "function", "function": {
        "name": "get_weather", "parameters": {
            "type": "object", "properties": {"city": {"type": "string"}},
            "required": ["city"], "additionalProperties": False}}}]
    msgs = [{"role": "user", "content": "hello"}]
    quote = engine.tokenizer.encode('"')[0]

    async def go(client):
        out = []
        for extra in ({"response_format": {"type": "json_schema", "json_schema": {
                          "name": "t", "schema": schema}}},
                      # a bias toward '"' closes the city string early: greedy
                      # on this random model would fill the budget inside it
                      {"tools": tools, "logit_bias": {str(quote): 20.0},
                       "parallel_tool_calls": False,
                       "tool_choice": {"type": "function",
                                       "function": {"name": "get_weather"}}}):
            resp = await client.post("/v1/chat/completions", json=dict(
                messages=msgs, max_tokens=64, temperature=0.0, **extra))
            out.append((resp.status, await resp.json()))
        return out

    (s1, b1), (s2, b2) = _call(engine, go)
    assert s1 == 200, b1
    assert json.loads(b1["choices"][0]["message"]["content"])["name"] in ("alpha", "beta")
    assert s2 == 200, b2
    call = b2["choices"][0]["message"]["tool_calls"][0]["function"]
    assert call["name"] == "get_weather"
    assert "city" in json.loads(call["arguments"])


def test_abandoned_stream_keeps_the_engine_to_itself(engine_fixture):
    """A client that leaves a streamed chat after its first content chunk:
    the server's next write fails, the producer closes the generation at
    its next token, and only then does the engine's lock pass to the next
    request. No two threads ever drive the single-stream engine at once
    (one could capture a prefill or step graph while the other replays)."""
    import threading
    import time

    hello = engine_fixture.tokenizer.encode("hello", add_bos=False)[0]

    class Watched:
        """The engine, counting the threads inside it; its stream pauses
        20 ms before each delta, as a slow generation would."""

        def __init__(self, inner):
            self.inner, self.active, self.most = inner, 0, 0
            self.guard = threading.Lock()

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def _enter(self):
            with self.guard:
                self.active += 1
                self.most = max(self.most, self.active)

        def _leave(self):
            with self.guard:
                self.active -= 1

        def chat_stream(self, *a, **kw):
            self._enter()
            try:
                inner = self.inner.chat_stream(*a, **kw)
                while True:
                    time.sleep(0.02)
                    try:
                        delta = next(inner)
                    except StopIteration as e:
                        return e.value
                    yield delta
            finally:
                self._leave()

        def chat(self, *a, **kw):
            self._enter()
            try:
                return self.inner.chat(*a, **kw)
            finally:
                self._leave()

    watched = Watched(engine_fixture)
    body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 60,
            "temperature": 0.0, "logit_bias": {str(hello): 100.0}}

    async def run():
        app = create_app(engine=watched, settings=Settings(), device="cpu")
        async with TestClient(TestServer(app)) as client:
            resp = await client.post("/v1/chat/completions", json=dict(body, stream=True))
            assert resp.status == 200
            lines = 0
            while lines < 2:  # the role chunk, then one content chunk
                lines += (await resp.content.readline()).startswith(b"data: ")
            resp.close()
            again = await client.post("/v1/chat/completions",
                                      json=dict(body, max_tokens=4))
            assert again.status == 200, await again.text()
            return await again.json()

    data = asyncio.run(run())
    assert data["choices"][0]["message"]["content"]
    assert watched.most == 1 and watched.active == 0
