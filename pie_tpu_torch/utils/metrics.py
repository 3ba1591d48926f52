"""Serving metrics: request counters, token throughput, TTFT/latency
histograms, Prometheus text exposition.

Reference parity: the usage accounting surface (reference
engine/inference_engine.py:132-138, server/models/chat/output.py:56-69)
plus the observability the reference lacked (SURVEY.md §5.5: "No
Prometheus/OTel") — implemented dependency-free.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Optional

_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram:
    def __init__(self, buckets=_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float):
        self.total += v
        self.n += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def lines(self, name: str) -> list[str]:
        out = []
        cum = 0
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out.append(f'{name}_bucket{{le="{b}"}} {cum}')
        out.append(f'{name}_bucket{{le="+Inf"}} {self.n}')
        out.append(f"{name}_sum {self.total}")
        out.append(f"{name}_count {self.n}")
        return out


class Metrics:
    """Process-wide serving metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.ttft = Histogram()
        self.queue_wait = Histogram()  # submit to a batching lane
        self.request_latency = Histogram()

    def count(self, name: str, value: float = 1.0):
        with self._lock:
            self.counters[name] += value

    def observe_ttft(self, seconds: float):
        with self._lock:
            self.ttft.observe(seconds)

    def observe_queue_wait(self, seconds: float):
        with self._lock:
            self.queue_wait.observe(seconds)

    def observe_latency(self, seconds: float):
        with self._lock:
            self.request_latency.observe(seconds)

    def record_request(
        self, prompt_tokens: int, completion_tokens: int,
        ttft: Optional[float], latency: float, error: bool = False,
    ):
        with self._lock:
            self.counters["requests_total"] += 1
            if error:
                self.counters["request_errors_total"] += 1
            self.counters["prompt_tokens_total"] += prompt_tokens
            self.counters["completion_tokens_total"] += completion_tokens
            if ttft is not None:
                self.ttft.observe(ttft)
            self.request_latency.observe(latency)

    def render(self) -> str:
        """Prometheus text format."""
        with self._lock:
            lines = []
            for name, v in sorted(self.counters.items()):
                lines.append(f"pie_{name} {v}")
            lines += self.ttft.lines("pie_ttft_seconds")
            lines += self.queue_wait.lines("pie_queue_wait_seconds")
            lines += self.request_latency.lines("pie_request_seconds")
            return "\n".join(lines) + "\n"


_global: Optional[Metrics] = None
_glock = threading.Lock()


def get_metrics() -> Metrics:
    global _global
    with _glock:
        if _global is None:
            _global = Metrics()
        return _global


class Timer:
    """Context helper for latency measurement."""

    def __init__(self):
        self.start = time.perf_counter()
        self.first_token: Optional[float] = None

    def mark_first_token(self):
        if self.first_token is None:
            self.first_token = time.perf_counter() - self.start

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start
