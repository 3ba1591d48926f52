"""The traced slice of a ``--trace 1`` run: the benchmark's own spans
around the calls into the port's scheduler and device programs, the work
each dispatched chunk and prefill did, and the profiler's device trace of
the same slice.

The slice opens and closes on the scheduler thread, at the entry of a
``Scheduler.step``, after a ``torch.cuda.synchronize``: every kernel in the
trace then belongs to a chunk or prefill dispatched inside the slice, and
every such dispatch ran all its kernels inside it. For each dispatched
chunk the benchmark records its steps and rider slices, and when the
scheduler hands the chunk's tokens out it records, per step, the context
length of every lane that produced a token (prompt + tokens before it: the
step that yields output token j of a request reads plen + j pool tokens).
For each direct prefill it records the real tokens and their positions,
and for each call of the batching service's vision tower
(``BatchedInferenceEngine._embed_images``, on the scheduler thread between
steps) its images' grids.
"""

from __future__ import annotations

import collections
import contextlib
import re
import time

import numpy as np
import torch

PAD = -1  # what a frozen lane emits

#: host spans of the scheduler thread, by the method they wrap
SPANS = {
    "step": "scheduler step",
    "_admit": "admission",
    "_direct_prefill": "direct prefill dispatch",
    "_plan_chunk": "chunk planning",
    "_drain_inflight": "drain (read back a chunk)",
    "_emit_chunk": "token hand-out",
}
PREFIX = "portbench."
#: idle gaps shorter than this are counted together, not labelled by span
SHORT_GAP_NS = 20_000


class Slice:
    """Spans, work records and the profiler over one slice of the window."""

    def __init__(self, start: float, length: float):
        self.start_at, self.length = start, length
        self.prof = None
        self.active = False
        self.done = False
        self.chunks: list = []  # every dispatched chunk, in order
        self._pending: collections.deque = collections.deque()
        self.prefills: list = []
        self.towers: list = []

    # -- installation -------------------------------------------------------

    def install(self, sched, core, engine=None) -> None:
        """Wrap the scheduler's and the paged engine's methods, and the
        batching service's tower call where ``engine`` is given (instance
        attributes: the program's own calls go through them). A run gives
        the engine; the port's tracing test wraps the scheduler alone."""
        for name, label in SPANS.items():
            self._wrap(sched, name, label)
        step = sched.step

        def traced_step(*a, **k):
            self._toggle()
            return step(*a, **k)

        sched.step = traced_step
        emit = sched._emit_chunk

        def traced_emit(emitted, n):
            self._record_emission(sched, emitted, n)
            return emit(emitted, n)

        sched._emit_chunk = traced_emit
        chunk = core._chunk

        def traced_chunk(params, num_steps, *a, rider=None, **k):
            rides = (np.zeros(num_steps, np.int64) if rider is None
                     else (np.asarray(rider.ids) >= 0).sum(axis=1))
            rec = dict(steps=int(num_steps), rider_tokens=[int(x) for x in rides],
                       in_slice=self.active, ctxs=None)
            self.chunks.append(rec)
            self._pending.append(rec)
            with self._span("chunk dispatch"):
                return chunk(params, num_steps, *a, rider=rider, **k)

        core._chunk = traced_chunk
        prefill = core._prefill

        def traced_prefill(params, ids, positions, *a, **k):
            pos = np.asarray(positions)[0]
            self.prefills.append(dict(bucket=int(np.asarray(ids).shape[1]),
                                      positions=pos[pos >= 0].tolist(),
                                      in_slice=self.active))
            with self._span("prefill dispatch"):
                return prefill(params, ids, positions, *a, **k)

        core._prefill = traced_prefill
        if engine is None:
            return
        embed = engine._embed_images

        def traced_embed(seq):
            kw = seq.image_inputs[1]
            self.towers.append(dict(grid_thw=np.asarray(kw["grid_thw"]).tolist(),
                                    in_slice=self.active))
            with self._span("vision tower"):
                return embed(seq)

        engine._embed_images = traced_embed

    def _wrap(self, obj, name: str, label: str) -> None:
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            with self._span(label):
                return fn(*a, **k)

        setattr(obj, name, wrapped)

    def _span(self, label: str):
        if self.active:
            return torch.profiler.record_function(PREFIX + label)
        return contextlib.nullcontext()

    # -- the slice ----------------------------------------------------------

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that its first
        start does not stall the scheduler inside the slice."""
        prof = _profiler()
        prof.start()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.stop()

    def _toggle(self) -> None:
        now = time.perf_counter()
        if not self.active and not self.done and now >= self.start_at:
            _sync()
            self.prof = _profiler()
            self.prof.start()
            self.active = True
            with torch.profiler.record_function(PREFIX + "slice open"):
                pass
        elif self.active and now >= self.start_at + self.length:
            self.close()

    def close(self) -> None:
        """Close the slice (the scheduler thread, or the main thread once the
        window ends if the scheduler never came back)."""
        if not self.active:
            return
        _sync()
        with torch.profiler.record_function(PREFIX + "slice close"):
            pass
        self.active = False
        self.done = True
        self.prof.stop()

    def _record_emission(self, sched, emitted, n: int) -> None:
        rec = self._pending.popleft() if self._pending else None
        if rec is None:
            return
        ctxs = [[] for _ in range(n)]
        for lane, seq in sched.running.items():
            if seq.machine is not None or seq.status.value != "decoding":
                continue
            j, plen = len(seq.output_ids), len(seq.prompt_ids)
            for s in range(n):
                if int(emitted[s, lane]) != PAD:
                    ctxs[s].append(plen + j)
                    j += 1
        rec["ctxs"] = ctxs

    # -- reduction ------------------------------------------------------------

    def reduce(self) -> dict:
        """What the per-layer readers read: the slice's device time by
        kernel, busy and window seconds, the idle gaps by the host span they
        fall in, and the work records of the chunks, prefills and tower
        calls in it."""
        if self.prof is None or not self.done:
            return {}
        dev, cpu, marks = [], [], {}
        for e in self.prof.profiler.kineto_results.events():
            name, s, t = e.name(), e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not (name.startswith(PREFIX) or e.is_user_annotation()):
                    dev.append((s, t, name))
            elif name.startswith(PREFIX):
                label = name[len(PREFIX):]
                if label.startswith("slice "):
                    marks[label] = s
                else:
                    cpu.append((s, t, label))
        lo = marks.get("slice open", min((s for s, _, _ in dev), default=0))
        hi = marks.get("slice close", max((t for _, t, _ in dev), default=lo))
        dev = [(max(s, lo), min(t, hi), n) for s, t, n in dev if t > lo and s < hi]
        kernels: dict = collections.defaultdict(float)
        for s, t, n in dev:
            kernels[n] += (t - s) / 1e9
        busy, gaps = _union_and_gaps(sorted(dev), lo, hi)
        idle: dict = collections.defaultdict(lambda: [0.0, 0])
        for gs, gt in gaps:
            if gt - gs < SHORT_GAP_NS:
                label = f"between kernels (under {SHORT_GAP_NS // 1000} us)"
            else:
                label = _innermost(cpu, (gs + gt) // 2) or "outside a scheduler step"
            idle[label][0] += (gt - gs) / 1e9
            idle[label][1] += 1
        return dict(
            window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
            kernels=dict(kernels),
            chunks=[c for c in self.chunks if c["in_slice"]],
            prefills=[p for p in self.prefills if p["in_slice"]],
            towers=[t for t in self.towers if t["in_slice"]],
            idle=dict(idle),
        )


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _union_and_gaps(intervals: list, lo: int, hi: int) -> tuple:
    """Covered nanoseconds of sorted (start, end, _) intervals inside
    [lo, hi], and the uncovered gaps."""
    busy, gaps, at = 0, [], lo
    for s, t, _ in intervals:
        if s > at:
            gaps.append((at, s))
        if t > at:
            busy += t - max(s, at)
            at = t
    if hi > at:
        gaps.append((at, hi))
    return busy, gaps


def _innermost(spans: list, t: int):
    """The shortest host span covering time t."""
    best = None
    for s, e, label in spans:
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, label)
    return best[1] if best else None


def kernel_seconds(trace: dict, patterns: tuple) -> float:
    """Device seconds of the kernels whose name matches any pattern (a
    regular expression searched in the demangled name)."""
    rx = [re.compile(p) for p in patterns]
    return sum(v for k, v in trace.get("kernels", {}).items()
               if any(r.search(k) for r in rx))


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time, and the idle time by
    what the host was doing, each with its seconds as measured."""
    ops = sorted(trace.get("kernels", {}).items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace.get("idle", {}).items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "device_ops": [[_short(k), v] for k, v in ops],
        "idle_gaps": [[f"{k} ({n} gaps)", s] for k, (s, n) in idle],
    }


def _short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]
