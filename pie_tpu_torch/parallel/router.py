"""Cross-host request routing for multi-host serving.

Port of the JAX package's ``pie_tpu/parallel/router.py`` (pure Python, a
copy). The serving tier splits into a front tier (HTTP,
``server/frontier.py``) and N engine hosts, each running its own scheduler
over its own cards. The router places each request on the least-loaded
live host, tracks it in flight, and, paired with
:class:`pie_tpu_torch.parallel.distributed.Heartbeat` or a transport that
reports a dead host, re-queues that host's in-flight requests onto the
survivors.

Transport-agnostic: a "host" is any callable sink (an HTTP client bound to
an engine host, a local BatchedInferenceEngine, a test stub). The router
only decides placement and owns the re-queue bookkeeping.
"""

from __future__ import annotations

import itertools
import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)


class DispatchError(RuntimeError):
    """Raised (or wrapped) by a dispatch transport to signal that the
    *host* failed — connection refused, socket error, transport down.

    Only this class triggers dead-host failover when a dispatch callable
    raises synchronously; any other exception is a programming error in
    the transport and fails just the one request: marking hosts dead on
    arbitrary exceptions would cascade until no host was left."""


@dataclass
class RoutedRequest:
    """One request tracked by the router."""

    request_id: int
    payload: Any
    host: Optional[str] = None
    attempts: int = 0
    done: bool = False
    result: Any = None
    error: Optional[str] = None
    _event: threading.Event = field(default_factory=threading.Event)
    _done_callbacks: list = field(default_factory=list)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def add_done_callback(self, cb: Callable[["RoutedRequest"], None]):
        """Register ``cb(req)`` to run when the request completes or
        fails. Runs immediately if already done. Callbacks fire on
        whichever thread finishes the request — use a threadsafe
        primitive (``loop.call_soon_threadsafe``) to hop into an event
        loop. Lets async servers await completion without parking an
        executor thread per request on ``wait``."""
        run_now = False
        if self.done or self._event.is_set():
            run_now = True
        else:
            self._done_callbacks.append(cb)
            # re-check: _finish may have raced between the check and append
            if self._event.is_set() and cb in self._done_callbacks:
                self._done_callbacks.remove(cb)
                run_now = True
        if run_now:
            cb(self)


class RequestRouter:
    """Least-loaded placement with dead-host re-queue.

    dispatch(host_id, request) is the transport: it must deliver the
    request to that host's engine and eventually call
    ``router.complete(request, result)`` or ``router.fail(request, err)``.
    On host death (``mark_host_dead`` — wire it to Heartbeat's
    ``on_peer_death``), in-flight requests of that host are re-dispatched
    to survivors, bounded by ``max_attempts``.
    """

    def __init__(
        self,
        dispatch: Callable[[str, RoutedRequest], None],
        max_attempts: int = 3,
    ):
        self._dispatch = dispatch
        self.max_attempts = max_attempts
        self._lock = threading.Lock()
        self._hosts: dict[str, int] = {}  # host -> in-flight count
        self._dead: set[str] = set()
        self._inflight: dict[int, RoutedRequest] = {}
        self._ids = itertools.count()

    # -- membership -------------------------------------------------------

    def add_host(self, host_id: str):
        with self._lock:
            self._hosts.setdefault(host_id, 0)
            self._dead.discard(host_id)

    def live_hosts(self) -> list[str]:
        with self._lock:
            return [h for h in self._hosts if h not in self._dead]

    def mark_host_dead(self, host_id: str):
        """Heartbeat callback: re-queue the dead host's in-flight work."""
        with self._lock:
            self._dead.add(host_id)
            orphans = [
                r for r in self._inflight.values()
                if r.host == host_id and not r.done
            ]
        logger.warning(
            "host %s dead; re-queueing %d requests", host_id, len(orphans)
        )
        for r in orphans:
            self._place(r)

    # -- request path -----------------------------------------------------

    def submit(self, payload: Any) -> RoutedRequest:
        req = RoutedRequest(request_id=next(self._ids), payload=payload)
        with self._lock:
            self._inflight[req.request_id] = req
        self._place(req)
        return req

    def _place(self, req: RoutedRequest):
        with self._lock:
            live = [
                (n, h) for h, n in self._hosts.items() if h not in self._dead
            ]
            fail_reason = None
            if not live:
                fail_reason = "error: no live hosts"
            elif req.attempts >= self.max_attempts:
                fail_reason = "error: exceeded max attempts"
            if fail_reason is not None:
                req.error = fail_reason
                req.done = True
                self._inflight.pop(req.request_id, None)
        if fail_reason is not None:
            self._signal(req)  # outside the lock: callbacks may re-enter
            return
        with self._lock:
            _, host = min(live)
            if req.host is not None and req.host in self._hosts:
                # leaving a (dead) host: its counter no longer matters but
                # keep it consistent for any later revival
                self._hosts[req.host] = max(0, self._hosts[req.host] - 1)
            req.host = host
            req.attempts += 1
            self._hosts[host] += 1
        try:
            self._dispatch(host, req)
        except DispatchError:
            # the transport says the HOST failed: fail over
            logger.exception("dispatch to %s failed", host)
            self.mark_host_dead(host)
        except Exception as e:  # transport bug: fail this request only
            logger.exception("dispatch raised a non-transport error")
            self.fail(req, f"error: dispatch raised {type(e).__name__}: {e}")

    @staticmethod
    def _signal(req: RoutedRequest):
        req._event.set()
        callbacks, req._done_callbacks = req._done_callbacks, []
        for cb in callbacks:
            try:
                cb(req)
            except Exception:  # pragma: no cover - callback bug
                logger.exception("done callback raised")

    def _finish(self, req: RoutedRequest):
        with self._lock:
            self._inflight.pop(req.request_id, None)
            if req.host in self._hosts:
                self._hosts[req.host] = max(0, self._hosts[req.host] - 1)
            req.done = True
        self._signal(req)

    def complete(self, req: RoutedRequest, result: Any):
        req.result = result
        self._finish(req)

    def fail(self, req: RoutedRequest, error: str):
        req.error = error
        self._finish(req)

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)
