"""Profiling instrumentation: host timing zones (off unless
``PIE_PROFILE=1``), a device trace through ``torch.profiler``, a
file-based heartbeat, and a timing wrapper around a page allocator.

Port of the JAX package's ``pie_tpu/utils/profiling.py`` (``zone``,
``profiled``, ``zone_report``, ``reset_zones``, ``ProfiledAllocator``) with
``torch.profiler`` in place of ``jax.profiler``; ``Heartbeat`` is the JAX
package's ``pie_tpu/parallel/distributed.py`` liveness beacon, kept here
until the port's ``parallel/`` (ROADMAP A10).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Optional

logger = logging.getLogger(__name__)

ENABLED = os.environ.get("PIE_PROFILE", "0") in ("1", "true", "True")

_zones: dict[str, list[float]] = defaultdict(list)
_zlock = threading.Lock()


@contextlib.contextmanager
def zone(name: str):
    """A host timing zone (recorded only with PIE_PROFILE=1)."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        with _zlock:
            _zones[name].append(time.perf_counter() - t0)


def profiled(fn):
    """Decorator form of :func:`zone`."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with zone(fn.__qualname__):
            return fn(*a, **kw)

    return wrapper


def zone_report() -> dict[str, dict]:
    with _zlock:
        return {
            name: {"count": len(vs), "total_s": sum(vs),
                   "mean_ms": 1e3 * sum(vs) / max(1, len(vs))}
            for name, vs in sorted(_zones.items())
        }


def reset_zones() -> None:
    with _zlock:
        _zones.clear()


@contextlib.contextmanager
def device_trace(log_dir: str = "pie_trace"):
    """Record a ``torch.profiler`` trace of the CPU and, where there is a
    card, its kernels; the Chrome trace goes to ``log_dir/trace.json``.
    Yields the profiler (``key_averages()`` for a table)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class ProfiledAllocator:
    """A page allocator whose allocations and frees are timing zones (the
    reference's ProfiledAllocatorWrapper); every other call passes
    through."""

    def __init__(self, allocator):
        self._a = allocator

    def allocate_n(self, n: int):
        with zone("PageAllocator.allocate_n"):
            return self._a.allocate_n(n)

    def free(self, pid: int):
        with zone("PageAllocator.free"):
            return self._a.free(pid)

    def __getattr__(self, name):
        return getattr(self._a, name)


class Heartbeat:
    """File-based liveness beacon and peer monitor over a shared directory:
    a host that misses ``timeout`` seconds of beats is reported dead."""

    def __init__(self, directory: str | Path, host_id: str, interval: float = 5.0,
                 timeout: float = 30.0,
                 on_peer_death: Optional[Callable[[str], None]] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.interval = interval
        self.timeout = timeout
        self.on_peer_death = on_peer_death
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead: set[str] = set()

    def _path(self, host: str) -> Path:
        return self.dir / f"{host}.heartbeat"

    def beat(self) -> None:
        self._path(self.host_id).write_text(
            json.dumps({"ts": time.time(), "host": self.host_id}))

    def peers(self) -> dict[str, float]:
        out = {}
        for p in self.dir.glob("*.heartbeat"):
            if p.stem == self.host_id:
                continue
            try:
                out[p.stem] = json.loads(p.read_text())["ts"]
            except (OSError, ValueError, KeyError):
                continue
        return out

    def dead_peers(self) -> list[str]:
        now = time.time()
        return [h for h, ts in self.peers().items() if now - ts > self.timeout]

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.beat()
            for host in self.dead_peers():
                if host not in self._dead:
                    self._dead.add(host)
                    logger.warning("peer %s missed heartbeats", host)
                    if self.on_peer_death:
                        try:
                            self.on_peer_death(host)
                        except Exception:
                            logger.exception("on_peer_death failed")
            self._stop.wait(self.interval)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="pie-heartbeat",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None
        try:
            self._path(self.host_id).unlink(missing_ok=True)
        except OSError:
            pass
