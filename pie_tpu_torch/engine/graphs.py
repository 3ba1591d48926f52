"""Compiled step programs: the port's counterpart of ``jax.jit``.

The JAX package compiles each prefill and each decode step into one device
program (``EngineCore._prefill`` and ``PagedEngine._prefill`` are
``jax.jit``, ``EngineCore._decode`` and ``PagedEngine._chunk`` ``jax.jit``
over a ``lax.scan``), with the step's static arguments (sampler kind,
logprobs, penalties, bias, mask, rider, prompt or KV bucket) in the
compile key. Here a step is a
Python function over static device buffers: it reads its inputs from
buffers whose addresses never change and writes its carried state back
into them in place. ``StepGraphs`` runs such a function:

- on the CPU it calls the function directly (the tests' path);
- on the card the first call of a key runs the function once eagerly on a
  side stream (the warm-up, and this step's real work: lazy one-time
  state such as kernel attributes, tensor maps and workspaces is made
  here) and then captures it into a ``torch.cuda.CUDAGraph``, as
  ``jax.jit`` compiles at its first call; every later call of the key
  replays the graph. A capture that fails raises: nothing falls back to
  eager on the card.

All graphs share one memory pool. A graph captured later can place its
outputs in blocks that an earlier graph uses for its intermediates, so a
replay's outputs are valid only until the next replay of ANY graph of the
runner: every caller copies them into tensors of its own first (the
prefills and both decode paths do). A graph that samples has the engine's
``torch.Generator`` registered with it, so every replay draws new numbers
(without that each replay would repeat the Philox offset it captured).
Captures use ``capture_error_mode="thread_local"``: a thread other than
the capturing one (a server's request thread) may touch CUDA meanwhile.

Launch counts (``quant_matmul_cuda.launch_counts``): a capture launches
nothing, so the counts it added are taken back and kept as the graph's
delta, which every replay adds again. K1 per token, K2 per prefill, K3 per
step and K4 per step read as they do for eager steps. ``stats()`` splits
graphs, captures, capture seconds and replays by step kind (a key's first
element: "prefill", "decode", "mixed").

A step returns a tuple of tensors. A replay returns the graph's own output
tensors, which the next replay of the key overwrites: the caller copies
them out (on the same stream) before it replays again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Hashable, Optional

import torch

from pie_tpu_torch.ops import quant_matmul_cuda as qmc


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    outputs: tuple
    counts: dict  # launch_counts delta of one replay


class StepGraphs:
    """A cache of captured step graphs keyed by the step's static
    arguments (``jax.jit``'s ``static_argnames``)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.generator = generator
        #: every key a step was run under (the CPU too)
        self.keys: set = set()
        self._graphs: dict = {}
        self._pool = None
        self._side = None
        #: captures made and the host seconds they took (warm-up included)
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        #: the same counts by step kind
        self.by_kind: dict = {}

    def __call__(self, key: Hashable, fn: Callable[[], tuple],
                 samples: bool = False) -> tuple:
        """Run step ``fn`` under ``key``; ``samples``: the step draws from
        the generator (its graph registers it)."""
        self.keys.add(key)
        if self.device.type != "cuda":
            return fn()
        hit = self._graphs.get(key)
        if hit is None:
            return self._warm_up_and_capture(key, fn, samples)
        hit.graph.replay()
        for name, n in hit.counts.items():
            qmc.launch_counts[name] += n
        self.replays += 1
        self._kind(key)["replays"] += 1
        return hit.outputs

    def _kind(self, key) -> dict:
        kind = key[0] if isinstance(key, tuple) and key else key
        return self.by_kind.setdefault(str(kind), dict(
            graphs=0, captures=0, capture_seconds=0.0, replays=0))

    def _warm_up_and_capture(self, key, fn, samples):
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._side
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()  # this step, eagerly
        cur.wait_stream(side)
        for t in out:
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        if samples:
            if self.generator is None:
                raise ValueError(f"step {key!r} samples but no generator is set")
            graph.register_generator_state(self.generator)
        before = dict(qmc.launch_counts)
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    outputs = fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid already: report fn's error
                    raise
                graph.capture_end()
        finally:
            counts = {k: qmc.launch_counts[k] - before[k] for k in before}
            qmc.launch_counts.update(before)  # a capture launches nothing
        self._graphs[key] = _Captured(graph, tuple(outputs), counts)
        secs = time.perf_counter() - t0
        self.captures += 1
        self.capture_seconds += secs
        kind = self._kind(key)
        kind["graphs"] += 1
        kind["captures"] += 1
        kind["capture_seconds"] += secs
        return out

    def pool_bytes(self) -> int:
        """Device bytes the graphs' shared memory pool holds (0 on the CPU
        and before the first capture)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def stats(self) -> dict:
        """What chip_smoke.py prints beside an engine's speed."""
        return dict(graphs=len(self._graphs), captures=self.captures,
                    capture_seconds=self.capture_seconds, replays=self.replays,
                    pool_bytes=self.pool_bytes(), keys=len(self.keys),
                    by_kind={k: dict(v) for k, v in sorted(self.by_kind.items())})
