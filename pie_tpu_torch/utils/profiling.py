"""Profiling instrumentation: host timing zones (off unless
``PIE_PROFILE=1``), a device trace through ``torch.profiler`` and a
timing wrapper around a page allocator.

Port of the JAX package's ``pie_tpu/utils/profiling.py`` (``zone``,
``profiled``, ``zone_report``, ``reset_zones``, ``ProfiledAllocator``) with
``torch.profiler`` in place of ``jax.profiler``. The heartbeat lives in
``pie_tpu_torch/parallel/distributed.py``, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import threading
import time
from collections import defaultdict
from pathlib import Path

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

