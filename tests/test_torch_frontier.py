"""The port's front tier (pie_tpu_torch/server/frontier.py) on the CPU,
in front of the port's own engine server (mirrors tests/test_frontier.py):
routing with failover off a dead host, the SSE relay chunk by chunk, and
a failover started from another thread (a heartbeat's), which hops onto
the frontier's event loop."""

import asyncio
import threading

import pytest
import torch

transformers = pytest.importorskip("transformers")
aiohttp = pytest.importorskip("aiohttp")

from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from pie_tpu_torch.engine import InferenceEngine
from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel
from pie_tpu_torch.server.app import create_app
from pie_tpu_torch.server.frontier import ROUTER_KEY, create_frontier

from test_torch_server import TINY, _tiny_tokenizer

CHAT_BODY = {
    "model": "tiny",
    "messages": [{"role": "user", "content": "hello world"}],
    "max_completion_tokens": 5,
    "temperature": 0.0,
}


@pytest.fixture(scope="module")
def engine():
    model = LlamaModel(LlamaConfig.from_dict(dict(TINY, model_type="llama")))
    params = model.init_params(seed=1, dtype=torch.float32, device="cpu")
    eng = InferenceEngine(model=model, params=params, tokenizer=_tiny_tokenizer(),
                          max_seq_len=128, kv_dtype=torch.float32, decode_chunk=4,
                          device="cpu")
    eng.chat([{"role": "user", "text": "hello"}], max_completion_tokens=2,
             temperature=0.0)
    return eng


def _run(coro_fn):
    return asyncio.run(coro_fn())


def test_frontier_routes_and_fails_over(engine):
    async def go():
        engine_server = TestServer(create_app(engine=engine, device="cpu"))
        await engine_server.start_server()
        live = f"http://{engine_server.host}:{engine_server.port}"
        dead = "http://127.0.0.1:9"  # discard port: connection refused
        frontier = create_frontier([dead, live])
        # load the live host so the first request goes to the dead one
        frontier[ROUTER_KEY]._hosts[live] = 5
        async with TestClient(TestServer(frontier),
                              timeout=aiohttp.ClientTimeout(total=120)) as client:
            for _ in range(3):
                resp = await client.post("/v1/chat/completions", json=CHAT_BODY)
                assert resp.status == 200, await resp.text()
                data = await resp.json()
                assert data["choices"][0]["finish_reason"] in ("stop", "length")
            health = await (await client.get("/health")).json()
            assert health["hosts"] == [live]  # the dead host is out
            assert health["inflight"] == 0
            # the same request straight to the engine: the relay changes nothing
            async with aiohttp.ClientSession() as direct:
                want = await (await direct.post(live + "/v1/chat/completions",
                                                json=CHAT_BODY)).json()
            assert data["choices"][0]["message"] == want["choices"][0]["message"]
        await engine_server.close()

    _run(go)


def test_frontier_relays_sse_stream(engine):
    async def go():
        engine_server = TestServer(create_app(engine=engine, device="cpu"))
        await engine_server.start_server()
        live = f"http://{engine_server.host}:{engine_server.port}"
        async with TestClient(TestServer(create_frontier([live])),
                              timeout=aiohttp.ClientTimeout(total=120)) as client:
            resp = await client.post("/v1/chat/completions",
                                     json={**CHAT_BODY, "stream": True})
            assert resp.status == 200, await resp.text()
            assert resp.headers["Content-Type"].startswith("text/event-stream")
            body = (await resp.read()).decode()
            events = [ln for ln in body.splitlines() if ln.startswith("data: ")]
            assert len(events) >= 3 and events[-1] == "data: [DONE]"
        await engine_server.close()

    _run(go)


def test_failover_from_another_thread(engine):
    """A request waits on a host that never answers; a heartbeat thread
    declares that host dead; the router re-dispatches from that thread,
    which the frontier hops onto its own loop, and the client gets the
    live host's answer."""

    async def go():
        hang = asyncio.Event()

        async def never(request):
            await hang.wait()
            return web.json_response({})

        stuck_app = web.Application()
        stuck_app.router.add_post("/v1/chat/completions", never)
        stuck = TestServer(stuck_app)
        await stuck.start_server()
        engine_server = TestServer(create_app(engine=engine, device="cpu"))
        await engine_server.start_server()
        slow = f"http://{stuck.host}:{stuck.port}"
        live = f"http://{engine_server.host}:{engine_server.port}"
        frontier = create_frontier([slow, live])
        router = frontier[ROUTER_KEY]
        router._hosts[live] = 5
        async with TestClient(TestServer(frontier),
                              timeout=aiohttp.ClientTimeout(total=120)) as client:
            post = asyncio.ensure_future(client.post("/v1/chat/completions",
                                                     json=CHAT_BODY))
            while router.inflight == 0:
                await asyncio.sleep(0.01)
            router._hosts[live] = 0
            beat = threading.Thread(target=router.mark_host_dead, args=(slow,))
            beat.start()
            resp = await post
            beat.join()
            assert resp.status == 200, await resp.text()
            assert (await resp.json())["choices"][0]["finish_reason"] in ("stop", "length")
            assert router.live_hosts() == [live]
        hang.set()
        await engine_server.close()
        await stuck.close()

    _run(go)
