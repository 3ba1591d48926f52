"""The program's own spans and request stamps in a run of a cell
(``pie_tpu_torch.utils.profiling``), the seven readings over them, and a
runner that records them.

The readings read ``run.program`` (what ``profiling.collect()`` returned
after the window) and, for ``idle_host_pct``, the traced slice's idle gaps
``run.trace["gaps"]`` (profiler ns). The harness keeps neither yet: for
``metrics/<name>.py`` files to read them, ``harness.serve`` has to call
``profiling.enable()`` at the window's open and keep ``profiling.collect()``
after ``wait_clients`` as ``run.program`` (traced runs only), and
``tracing.Slice.reduce`` has to return its gaps. ``main`` does both around
the unchanged harness, in one process:

    python3 portbench/spans.py --workload NAME --seeds N [N ...] --seconds 51 \\
        --slice 0|1 --program 0|1

prints one JSON line a run: the cell's metrics as ``run.py`` reads them
(end-to-end with ``--slice 0``, per-layer with ``--slice 1``) and, with
``--program 1``, the cell's readings; each whole line, the slice's
breakdown included, also goes to ``build/portbench/spans/<workload>.jsonl``.
``--program 0 --slice 0`` is a plain untraced run, the control of what the
program's tracing costs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.readers import pct  # noqa: E402

STEP, READBACK, CHUNK = "pie.sched.step", "pie.sched.readback", "pie.engine.chunk"


def _ns(t: float) -> int:
    return round(t * 1e9)


def queue_wait_ms(run, q: float):
    """The q-th percentile over requests submitted in the window of their
    wait from submission to a lane (to the close, if not admitted by then),
    ms."""
    prog = getattr(run, "program", None)
    if not prog:
        return None
    lo, hi = _ns(run.t_open), _ns(run.t_close)
    waits = [(min(r.t_admit, hi) if r.t_admit else hi) - r.t_submit
             for r in prog["requests"] if lo <= r.t_submit <= hi]
    return pct(waits, q) / 1e6 if waits else None


def admit_to_first_ms(run, q: float):
    """The q-th percentile over requests admitted in the window of the time
    from their lane to their first token (to the close, if none by then),
    ms."""
    prog = getattr(run, "program", None)
    if not prog:
        return None
    lo, hi = _ns(run.t_open), _ns(run.t_close)
    times = [(min(r.t_first, hi) if r.t_first else hi) - r.t_admit
             for r in prog["requests"] if r.t_admit and lo <= r.t_admit <= hi]
    return pct(times, q) / 1e6 if times else None


def _window_spans(run, name: str) -> list:
    lo, hi = _ns(run.t_open), _ns(run.t_close)
    return [s for s in run.program["spans"] if s.name == name and lo <= s.start_ns <= hi]


def _host(run) -> tuple:
    """(wall ns, thread CPU ns, chunks) of the scheduler's steps that
    started in the window, their read-backs left out."""
    steps, reads = _window_spans(run, STEP), _window_spans(run, READBACK)
    wall = sum(s.end_ns - s.start_ns for s in steps) - sum(s.end_ns - s.start_ns for s in reads)
    cpu = sum(s.cpu_ns for s in steps) - sum(s.cpu_ns for s in reads)
    return wall, cpu, len(_window_spans(run, CHUNK))


def host_ms_per_chunk(run):
    """Host time inside the scheduler's steps, less the time waiting in
    their read-backs, over the chunks they dispatched, ms."""
    if not getattr(run, "program", None):
        return None
    wall, _, chunks = _host(run)
    return wall / chunks / 1e6 if chunks else None


def sched_cpu_pct(run):
    """The scheduler thread's CPU time over the wall time of that same host
    time (read-backs left out), %: well under 100, it waits for the
    interpreter lock or the OS, not for its own work."""
    if not getattr(run, "program", None):
        return None
    wall, cpu, _ = _host(run)
    return 100.0 * cpu / wall if wall > 0 else None


def idle_host_pct(run):
    """Share of the traced slice in which no device operation ran while the
    scheduler thread was inside a step and not inside its read-back, %: a
    part of ``device_idle_pct``."""
    from pie_tpu_torch.utils.profiling import to_profiler_ns

    prog, tr = getattr(run, "program", None), run.trace
    if not prog or not tr or "gaps" not in tr or tr.get("window_s", 0) <= 0:
        return None

    def conv(s):
        return to_profiler_ns(prog["anchors"], s.start_ns), to_profiler_ns(prog["anchors"],
                                                                            s.end_ns)

    steps = sorted(conv(s) for s in prog["spans"] if s.name == STEP)
    reads = sorted(conv(s) for s in prog["spans"] if s.name == READBACK)
    host, j = [], 0
    for a, b in steps:  # each step less the read-backs inside it
        while j < len(reads) and reads[j][1] <= b:
            if reads[j][0] >= a:
                host.append((a, reads[j][0]))
                a = reads[j][1]
            j += 1
        host.append((a, b))
    return 100.0 * _overlap(host, sorted(tr["gaps"])) / (tr["window_s"] * 1e9)


def _overlap(a: list, b: list) -> int:
    """Nanoseconds covered by both of two sorted lists of disjoint
    (start, end) intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


#: each cell's readings, by the metric name they would take
READINGS = {
    "qwen7b-chat": {
        "queue_wait_p90_ms.ttft_p90": lambda run: queue_wait_ms(run, 90),
        "host_ms_per_chunk.tpot_p90": host_ms_per_chunk,
    },
    "qwen7b-longprompt": {
        "queue_wait_p50_ms.ttft_p50": lambda run: queue_wait_ms(run, 50),
        "admit_to_first_p50_ms.ttft_p50": lambda run: admit_to_first_ms(run, 50),
    },
    "mistral7b-decode": {
        "host_ms_per_chunk.tok": host_ms_per_chunk,
        "sched_cpu_pct.tok": sched_cpu_pct,
        "idle_host_pct.tok": idle_host_pct,
    },
}


@contextlib.contextmanager
def program_window(kept: dict, program: bool):
    """Around ``harness.serve``: with ``program``, the program's tracer on
    from the window's open and collected once the clients are done
    (``kept["program"]``); the traced slice's idle gaps kept in
    ``kept["gaps"]``."""
    from pie_tpu_torch.utils import profiling
    from portbench import harness, tracing

    drive, wait, gaps = harness.drive, harness.wait_clients, tracing._union_and_gaps

    def traced_drive(*a, **k):
        if program:
            profiling.enable()
        return drive(*a, **k)

    def traced_wait(*a, **k):
        wait(*a, **k)
        if program:
            kept["program"] = profiling.collect()
            profiling.disable()

    def kept_gaps(*a, **k):
        busy, out = gaps(*a, **k)
        kept["gaps"] = out
        return busy, out

    harness.drive, harness.wait_clients, tracing._union_and_gaps = (
        traced_drive, traced_wait, kept_gaps)
    try:
        yield
    finally:
        profiling.disable()
        harness.drive, harness.wait_clients, tracing._union_and_gaps = drive, wait, gaps


def serve(workload: str, seed: int, seconds: float, slice_: bool, program: bool,
          root: Path = ROOT, device: str = "cuda"):
    """One run through the harness, with the program's window and the
    slice's gaps attached to it."""
    from portbench import harness

    kept: dict = {}
    with program_window(kept, program):
        cell, run, peak = harness.serve(root, workload, seed, seconds, slice_, device)
    if program:
        run.program = kept["program"]
    if run.trace:
        run.trace["gaps"] = kept.get("gaps", [])
    return cell, run, peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--slice", type=int, choices=(0, 1), default=1)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from portbench import harness, run as _run  # noqa: F401  (the benchmark's environment)
    from portbench.tracing import breakdown

    out = ROOT / "build" / "portbench" / "spans"
    out.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        _, run, peak = serve(args.workload, seed, args.seconds, bool(args.slice),
                             bool(args.program))
        line = {"workload": args.workload, "seed": seed, "slice": args.slice,
                "program": args.program, "run_s": time.perf_counter() - t0,
                "metrics": {m["name"]: harness.load_reader(ROOT, m["name"]).read(run)
                            for m in harness.cell_metrics(ROOT, args.workload,
                                                          bool(args.slice))}}
        if args.program:
            line["readings"] = {k: fn(run) for k, fn in READINGS[args.workload].items()}
            line["program_spans"] = len(run.program["spans"])
            line["program_requests"] = len(run.program["requests"])
            line["dropped"] = run.program["dropped"]
        print(json.dumps(line), flush=True)
        if run.trace:
            line["breakdown"] = breakdown(run.trace)
        with open(out / f"{args.workload}.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
