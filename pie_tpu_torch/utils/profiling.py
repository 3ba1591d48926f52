"""Host spans and request stamps of the serving path, on the clock a
benchmark's host timings use (``time.perf_counter_ns``), with anchors that
put them on ``torch.profiler``'s timeline.

Off by default: ``span()`` then returns one shared no-op context (falsy)
and records nothing. ``enable()`` starts a window; ``collect()`` reads it;
``disable()`` ends it and lets go of what it kept. While it is on:

- ``with span(name):`` records one ``Span``: its start and end
  (``perf_counter_ns``), the thread CPU ns it consumed
  (``thread_time_ns``), its id and its parent's (the innermost open span
  of the same thread, 0 for none);
- ``request(seq)`` registers a request, whose stamps ``t_submit``,
  ``t_admit`` and ``t_first`` (``perf_counter_ns``, 0 for "not yet") are
  read when the window is collected, finished or not.

Both lists are bounded; what overflows is counted, not kept. ``collect()``
returns them with two anchors, each a pair (``perf_counter_ns``, the
profiler's clock) taken at ``enable()`` and at ``collect()``: the profiler
(kineto) stamps CPU events in Unix-epoch ns, so ``to_profiler_ns`` maps a
span onto its trace by the line through the two anchors.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional

#: spans and requests a window keeps; later ones are counted as dropped
MAX_SPANS = 200_000
MAX_REQUESTS = 50_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    cpu_ns: int
    id: int
    parent: int


class Request(NamedTuple):
    id: int
    t_submit: int
    t_admit: int
    t_first: int


class _Off:
    """What ``span()`` returns with recording off: enters and exits."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


OFF = _Off()

_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_spans: list = []
_requests: list = []
_dropped = {"spans": 0, "requests": 0}
_anchor0: Optional[tuple] = None


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "c0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        c1 = time.thread_time_ns()
        _local.stack.pop()
        rec = Span(self.name, self.t0, t1, c1 - self.c0, self.id, self.parent)
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(rec)
            else:
                _dropped["spans"] += 1
        return False


def span(name: str):
    """A span named ``name`` around a ``with`` block (``OFF`` while
    recording is off)."""
    if not _on:
        return OFF
    return _Span(name)


def request(seq) -> None:
    """Register a request (anything with ``seq_id`` and the three stamps)
    for the window being recorded; held until ``disable()``."""
    if not _on:
        return
    with _lock:
        if len(_requests) < MAX_REQUESTS:
            _requests.append(seq)
        else:
            _dropped["requests"] += 1


def _anchor() -> tuple:
    """(perf_counter_ns, Unix-epoch ns) read together; the first is the
    midpoint of two reads around the second."""
    a = time.perf_counter_ns()
    u = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, u


def _clear() -> None:
    _spans.clear()
    _requests.clear()
    _dropped.update(spans=0, requests=0)


def enable() -> None:
    """Start a window: take the first anchor, record from now on."""
    global _on, _anchor0
    with _lock:
        _clear()
        _anchor0 = _anchor()
        _on = True


def disable() -> None:
    """End the window and drop what it kept (``collect()`` it first)."""
    global _on, _anchor0
    with _lock:
        _on = False
        _clear()
        _anchor0 = None


def collect() -> dict:
    """The window so far: ``spans`` (``Span``), ``requests`` (``Request``,
    the stamps as they stand now), ``dropped`` counts and ``anchors`` (at
    ``enable()`` and now). Recording goes on until ``disable()``."""
    with _lock:
        spans = list(_spans)
        seqs = list(_requests)
        dropped = dict(_dropped)
        a0 = _anchor0
    reqs = [Request(s.seq_id, s.t_submit, s.t_admit, s.t_first) for s in seqs]
    return {"spans": spans, "requests": reqs, "dropped": dropped,
            "anchors": [a0, _anchor()] if a0 is not None else []}


def to_profiler_ns(anchors: list, t_ns: int) -> int:
    """A ``perf_counter_ns`` time on the profiler's clock, by the line
    through the window's two anchors."""
    (p0, u0), (p1, u1) = anchors
    return u0 + round((t_ns - p0) * (u1 - u0) / (p1 - p0))
