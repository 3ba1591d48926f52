"""The port's continuous-batching service (BatchedInferenceEngine) on the
CPU: concurrent callers decode the streams of the single-stream engine,
an early close cancels, oversized and unported requests are refused, and
the OpenAI server over it answers concurrent chats and an n=2 chat with
two choices, without the single-stream lock."""

import asyncio
import os
import sys
import threading

import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")
pytest.importorskip("transformers")

from aiohttp.test_utils import TestClient, TestServer

from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
from pie_tpu_torch.engine.engine import InferenceError
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel
from pie_tpu_torch.server.app import create_app
from pie_tpu_torch.server.config import Settings

from test_torch_server import TINY, _tiny_tokenizer


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """Single-stream and batching engines on the same f32 weights, the
    embedding and head at unit scale so greedy choices are decisive."""
    model = LlamaModel(LlamaConfig.from_dict(dict(TINY, model_type="llama")))
    params = model.init_params(seed=1, dtype=torch.float32, device="cpu")
    params["embed"] = params["embed"] * 50.0
    params["lm_head"] = params["lm_head"] * 50.0
    tok = _tiny_tokenizer()
    single = InferenceEngine(model=model, params=params, tokenizer=tok,
                             max_seq_len=256, kv_dtype=torch.float32,
                             decode_chunk=8, prompt_cache=False, device="cpu")
    batched = BatchedInferenceEngine(model=model, params=params, tokenizer=tok,
                                     num_lanes=4, num_pages=32, max_pages_per_seq=8,
                                     prefill_chunk=16, kv_dtype=torch.float32,
                                     device="cpu")
    yield single, batched
    batched.shutdown()


def test_concurrent_callers_match_single_stream(engines):
    """More callers than lanes and than cores, with a short interpreter
    switch interval: each request gets the stream the single-stream engine
    decodes, and every lane and page comes back."""
    single, batched = engines
    prompts = [[5, 17, 42, 7], [9, 3, 3, 7, 1], list(range(10, 40))]
    expected = [single.generate(p, max_completion_tokens=8, temperature=0.0).token_ids
                for p in prompts]
    n = 3 * max(4, os.cpu_count() or 1)
    results = [None] * n

    def worker(i):
        results[i] = batched.generate(prompts[i % 3], max_completion_tokens=8,
                                      temperature=0.0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i, r in enumerate(results):
        assert r is not None, f"request {i} failed"
        assert r.token_ids == expected[i % 3], i
        assert r.finish_reason == "length"
    sched = batched.scheduler
    assert len(sched.free_lanes) == 4 and not sched.running
    assert sched.manager.num_free_pages() + len(sched.prefix_store) == 32


def test_streaming_and_early_close_cancels(engines):
    _, batched = engines
    gen = batched.generate_stream([5, 17, 42, 7], max_completion_tokens=50,
                                  temperature=0.0)
    assert len([next(gen).token_id for _ in range(3)]) == 3
    gen.close()  # abandoned: the sequence is cancelled
    r = batched.generate([9, 3, 3], max_completion_tokens=4, temperature=0.0)
    assert len(r.token_ids) == 4
    sched = batched.scheduler
    for _ in range(100):  # the scheduler thread frees the cancelled lane
        if not sched.running:
            break
        threading.Event().wait(0.05)
    assert not sched.running
    assert sched.manager.num_free_pages() + len(sched.prefix_store) == 32


def test_oversized_and_unported_requests_are_refused(engines):
    _, batched = engines
    with pytest.raises(InferenceError):  # more pages than max_pages_per_seq
        batched.generate(list(range(1, 100)), max_completion_tokens=4096,
                         temperature=0.0)
    with pytest.raises(InferenceError, match="image"):
        batched.generate([1, 2], pixel_values=torch.zeros(1))
    with pytest.raises(InferenceError, match="empty prompt"):
        batched.generate_constrained([], machine=None)
    with pytest.raises(ValueError, match="scheduler_impl"):
        BatchedInferenceEngine(model=batched.model, params=batched.params,
                               scheduler_impl="rust", device="cpu")


def test_failed_step_frees_lanes_and_engine_recovers(engines, monkeypatch):
    """A device step that raises fails the requests in flight with
    InferenceError, frees their lanes and pages, and the next request is
    served as before."""
    single, batched = engines
    core = batched.core
    real = core._chunk
    calls = []

    def fail_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected device failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(core, "_chunk", fail_once)
    with pytest.raises(InferenceError, match="scheduler failure"):
        batched.generate([5, 17, 42, 7], max_completion_tokens=4, temperature=0.0)
    sched = batched.scheduler
    assert len(sched.free_lanes) == 4 and not sched.running
    want = single.generate([9, 3, 3], max_completion_tokens=4, temperature=0.0)
    r = batched.generate([9, 3, 3], max_completion_tokens=4, temperature=0.0)
    assert r.token_ids == want.token_ids


def _serve(engine, coro_fn):
    async def run():
        app = create_app(engine=engine, settings=Settings(batching=True),
                         device="cpu")
        async with TestClient(TestServer(app),
                              timeout=aiohttp.ClientTimeout(total=590)) as client:
            return await coro_fn(client)

    return asyncio.run(run())


def test_server_answers_concurrent_chats_and_n2(engines):
    single, batched = engines
    msg = [{"role": "user", "content": "hello world"}]
    want = single.chat([{"role": "user", "text": "hello world"}],
                       max_completion_tokens=6, temperature=0.0)

    async def go(client):
        async def chat(**extra):
            resp = await client.post("/v1/chat/completions", json=dict(
                messages=msg, max_tokens=6, temperature=0.0, **extra))
            return resp.status, await resp.json()

        many = await asyncio.gather(*(chat() for _ in range(4)))
        two = await chat(n=2)
        return many, two

    many, (status, body) = _serve(batched, go)
    for st, data in many:
        assert st == 200, data
        assert data["choices"][0]["message"]["content"] == want.text
        assert data["usage"]["completion_tokens"] == want.completion_tokens
    assert status == 200, body
    assert [c["index"] for c in body["choices"]] == [0, 1]
    assert all(c["message"]["content"] == want.text for c in body["choices"])
    assert body["usage"]["completion_tokens"] == 2 * want.completion_tokens
