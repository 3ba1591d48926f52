"""Find an open-loop cell's knee: the highest arrival rate whose
completions keep up with its arrivals.

    python3 portbench/sweep.py --workload NAME --seed N --seconds S --windows W --rates R1 R2 ...

One process: the cell's model and warm-up once, then ``W`` windows of ``S``
seconds at each rate, in the order given (requests still open at a
window's close are cancelled and drained before the next). The windows of
one rate are consecutive stretches of one Poisson schedule at that rate, so
no two see the same arrivals. A window keeps up when the mean number of
requests in the system over its last quarter exceeds that over its second
(the first quarter, filling from empty, is left out) by no more than
``NOISE`` standard deviations of the difference of two Poisson counts of
those sizes: bursts alone move each quarter's backlog by that much at any
rate, and a long request holds either quarter's up for seconds. The
knee is the highest rate that kept up in every window, as every lower rate
swept did. Per window it prints one JSON line (requests sent and finished, the
two backlogs, TTFT p50 / p95, output tokens/s; where requests carry inputs,
the TTFT p50 of those that do), and last a line with the knee; each line is
also appended to ``chiprun_out/sweep-<workload>.jsonl``. Request inputs
(a traffic's ``inputs``) are made and warmed up as a run makes them.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: seconds between the samples of a window's backlog
SAMPLE_S = 0.25
#: how many standard deviations of a Poisson count a backlog may grow by
NOISE = 2.0


def backlog(records, t: float) -> int:
    """Requests due by ``t`` and not finished by then."""
    return sum(1 for r in records if r.due <= t and not (r.finished and r.finished <= t))


def mean_backlog(records, a: float, b: float) -> float:
    ts = [a + SAMPLE_S * (i + 0.5) for i in range(int((b - a) / SAMPLE_S))]
    return sum(backlog(records, t) for t in ts) / len(ts)


def keeps_up(second: float, last: float) -> bool:
    """The backlog did not grow beyond the noise of arrivals in both
    quarters."""
    return last - second <= NOISE * (second + last + 2.0) ** 0.5


def knee(lines: list):
    """The highest rate that kept up in every window, with every lower rate
    swept keeping up too (None if the lowest did not)."""
    best = None
    for rate in sorted({x["rate"] for x in lines}):
        if not all(x["keeps_up"] for x in lines if x["rate"] == rate):
            break
        best = rate
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()

    import numpy as np
    import torch

    from portbench import harness, traffic as traffic_mod

    cell, cfg, traffic, _ = harness.cell_files(ROOT, args.workload)
    dev = torch.device("cuda")
    engine = harness.build_engine(cfg, args.seed, dev)
    harness.warm_up(engine, cfg, traffic, args.seed, dev)
    out = ROOT / "chiprun_out" / f"sweep-{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    s, lines = args.seconds, []
    for i, rate in enumerate(args.rates):
        tr = dict(traffic, rate_per_s=rate)
        stream = traffic_mod.requests(tr, cfg, args.seed + i + 1, s * args.windows, dev)
        for w in range(args.windows):
            reqs = [dataclasses.replace(r, due_s=r.due_s - w * s) for r in stream
                    if w * s <= r.due_s < (w + 1) * s]
            t_open, t_close, recs, futures = harness.drive(engine, reqs, tr, s,
                                                           cfg["assumed"]["lanes"])
            harness.wait_clients(recs, futures, t_close)
            ttft = [(r.times[0] if r.times else t_close) - r.due for r in recs]
            second = mean_backlog(recs, t_open + s / 4, t_open + s / 2)
            last = mean_backlog(recs, t_open + 3 * s / 4, t_close)
            line = dict(
                workload=args.workload, rate=rate, window=w, seconds=s, sent=len(recs),
                finished=sum(1 for r in recs if r.finished and r.finished <= t_close),
                backlog_second_quarter=second, backlog_last_quarter=last,
                keeps_up=keeps_up(second, last),
                ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
                ttft_p95_ms=1e3 * float(np.percentile(ttft, 95)),
                **({"inputs_ttft_p50_ms": 1e3 * float(np.percentile(
                    [x for x, r in zip(ttft, recs) if r.extras], 50))}
                   if any(r.extras for r in recs) else {}),
                output_tok_s=sum(1 for r in recs for t in r.times if t <= t_close) / s,
                card=torch.cuda.get_device_name(0),
            )
            lines.append(line)
            print(json.dumps(line), flush=True)
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")
            time.sleep(2.0)
    engine.shutdown()
    summary = dict(workload=args.workload, knee=knee(lines), rates=args.rates,
                   windows=args.windows, seconds=s)
    print(json.dumps(summary), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
