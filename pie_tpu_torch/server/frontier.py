"""Front-tier HTTP router for multi-host serving.

Port of the JAX package's ``pie_tpu/server/frontier.py``. A deployment
runs one engine server (``python -m pie_tpu_torch.server``) per host; this
tier sits in front of them, places each request on the least-loaded live
host (``parallel.router.RequestRouter``), proxies the OpenAI wire format
unchanged (SSE streams included, chunk by chunk), and fails a dead host's
in-flight requests over to the survivors by re-dispatching them (a request
holds no state above its engine host: a re-queue is a re-prefill there).

Run:  python -m pie_tpu_torch.server.frontier --hosts http://h0:8000,http://h1:8000 [--port 8080]
      (or PIE_HOSTS=... in place of --hosts)
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

try:
    import aiohttp
    from aiohttp import web
except ImportError:  # pragma: no cover
    aiohttp = None
    web = None

from pie_tpu_torch.parallel.router import DispatchError, RequestRouter, RoutedRequest

logger = logging.getLogger(__name__)

ROUTER_KEY = web.AppKey("pie_router", object) if web else None
SESSION_KEY = web.AppKey("pie_session", object) if web else None
LOOP_KEY = web.AppKey("pie_loop", object) if web else None

PROXY_PATHS = (
    "/v1/chat/completions",
    "/v1/completions",
    "/v1/responses",
)


class _HttpDispatch:
    """RequestRouter transport: forwards the request body to the chosen
    engine host over HTTP and completes/fails the routed request with the
    upstream response. Streaming responses are relayed chunk-by-chunk.

    The dispatch callable may be invoked from a non-loop thread (the
    Heartbeat death callback re-queues orphans from its monitor thread),
    so the aiohttp app's event loop is captured at startup and all HTTP
    work hops onto it via ``run_coroutine_threadsafe``. Calling
    ``asyncio.get_running_loop()`` here used to raise off-loop and the
    router treated it as a host failure, cascading dead-marks across the
    fleet."""

    def __init__(self, session_factory, loop_factory):
        self._session_factory = session_factory
        self._loop_factory = loop_factory
        self.router: Optional[RequestRouter] = None

    def __call__(self, host: str, req: RoutedRequest):
        payload = req.payload  # (path, body_bytes, headers, response_sink)
        loop = self._loop_factory()
        if loop is None:  # startup not finished: genuinely can't transport
            raise DispatchError("frontier event loop not running")
        coro = self._run(host, req, payload)
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            loop.create_task(coro)
        else:  # heartbeat / router thread
            asyncio.run_coroutine_threadsafe(coro, loop)

    async def _run(self, host, req, payload):
        path, body, headers, sink = payload
        session = self._session_factory()
        try:
            resp = await session.post(
                host + path, data=body,
                headers={"Content-Type": headers.get(
                    "Content-Type", "application/json"
                )},
            )
        except (aiohttp.ClientError, OSError, asyncio.TimeoutError) as e:
            # includes the session-total timeout: without this the routed
            # request was never completed OR failed over and the client
            # waited out the proxy timeout for a 503
            logger.warning("host %s unreachable: %s", host, e)
            self.router.mark_host_dead(host)
            return
        except Exception as e:  # pragma: no cover - transport bug
            logger.exception("dispatch to %s raised", host)
            self.router.fail(req, f"error: {type(e).__name__}: {e}")
            return
        self.router.complete(req, resp)


async def _wait_routed(routed: RoutedRequest, timeout: float) -> bool:
    """Await request completion without parking an executor thread.

    ``run_in_executor(None, routed.wait, 600)`` blocked a default-pool
    thread per in-flight request — ~32 concurrent requests saturated the
    pool and stalled everything else on it. A done
    callback hops completion onto this loop instead."""
    loop = asyncio.get_running_loop()
    done = asyncio.Event()
    routed.add_done_callback(
        lambda _req: loop.call_soon_threadsafe(done.set)
    )
    try:
        await asyncio.wait_for(done.wait(), timeout)
        return True
    except asyncio.TimeoutError:
        return False


async def _proxy(request: "web.Request") -> "web.StreamResponse":
    app = request.app
    router: RequestRouter = app[ROUTER_KEY]
    body = await request.read()
    routed = router.submit(
        (request.path, body, dict(request.headers), None)
    )
    # wait for an upstream response (failover re-dispatches internally)
    ok = await _wait_routed(routed, 600.0)
    if not ok or routed.error:
        return web.json_response(
            {"error": {"message": routed.error or "timeout",
                       "type": "router_error"}},
            status=503,
        )
    upstream: aiohttp.ClientResponse = routed.result
    out = web.StreamResponse(
        status=upstream.status,
        headers={
            "Content-Type": upstream.headers.get(
                "Content-Type", "application/json"
            )
        },
    )
    try:
        await out.prepare(request)
        async for chunk in upstream.content.iter_any():
            await out.write(chunk)
        await out.write_eof()
    except (aiohttp.ClientError, OSError, asyncio.TimeoutError) as e:
        # Known limitation: a host dying MID-STREAM cannot be failed over
        # — bytes already reached the client, so re-dispatching would
        # replay the stream from the start. We close the client
        # connection so the client sees a truncated stream and retries,
        # and mark the host for the heartbeat to confirm.
        logger.warning("upstream stream broke mid-relay: %s", e)
        router.mark_host_dead(routed.host)
        raise
    finally:
        # release the pooled connection even when the client disconnects
        # mid-stream (leaked connections exhausted the pool)
        upstream.release()
    return out


async def _health(request: "web.Request") -> "web.Response":
    router: RequestRouter = request.app[ROUTER_KEY]
    return web.json_response(
        {"status": "ok", "hosts": router.live_hosts(),
         "inflight": router.inflight}
    )


def create_frontier(hosts: list[str]) -> "web.Application":
    if web is None:  # pragma: no cover
        raise RuntimeError("aiohttp is required for the frontier tier")
    app = web.Application()
    app[LOOP_KEY] = None
    dispatch = _HttpDispatch(
        lambda: app[SESSION_KEY], lambda: app[LOOP_KEY]
    )
    router = RequestRouter(dispatch)
    dispatch.router = router
    for h in hosts:
        router.add_host(h.rstrip("/"))
    app[ROUTER_KEY] = router

    async def _init(app):
        app[LOOP_KEY] = asyncio.get_running_loop()
        app[SESSION_KEY] = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=600)
        )

    async def _close(app):
        await app[SESSION_KEY].close()

    app.on_startup.append(_init)
    app.on_cleanup.append(_close)
    for p in PROXY_PATHS:
        app.router.add_post(p, _proxy)
    app.router.add_get("/health", _health)
    return app


def main():  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument(
        "--hosts", default=os.environ.get("PIE_HOSTS", ""),
        help="comma-separated engine base URLs",
    )
    args = ap.parse_args()
    hosts = [h for h in args.hosts.split(",") if h]
    if not hosts:
        raise SystemExit("PIE_HOSTS / --hosts required")
    web.run_app(create_frontier(hosts), port=args.port)


if __name__ == "__main__":  # pragma: no cover
    main()
