"""Readings that the limits of ``checks/<workload>.json`` are set from.

    python3 portbench/calibrate.py --workload NAME --seconds S --seeds N1 N2 ... [--control]

For each seed, in one process: a run of the cell at its own load for the
window (weights, traffic and the check's sample all from the seed), judged
by ``check.compare`` as a benchmark run is. With ``--control``, the control
is put in the program's place and judged by the same ``check.compare``: the
plain reference computed with every activation in float8 e4m3, a step
below the bf16 the configuration states, serves its own first choice at
each position of the requests the check samples (read over the program's
prompts and tokens, so a request is the control's own greedy decode up to
its first departure from the program's), and, for the sampled requests
with inputs, its own features (the tower in float8) written over the
placeholder rows of the prompt embeddings the program served, in their
type. One JSON line per seed, also appended to
``chiprun_out/calibrate-<workload>.jsonl``.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control_run(run, spec: dict, seed: int, device):
    """``run`` with the check's sampled requests served by the control."""
    import torch

    from portbench import check

    picked = check.sample(run, seed, spec["sample_tokens"])
    ref = run.kit.reference(run.cfg, seed, device, "fp8")
    _, _, low = check.reference_gaps(ref, picked, device)
    served = {id(r): lg.argmax(dim=-1).tolist() for r, lg in zip(picked, low)}
    records = [dataclasses.replace(r, tokens=served[id(r)]) if id(r) in served else r
               for r in run.records]
    embeds = dict(run.embeds)
    with_inputs = [r for r in picked if r.extras and r.index in embeds]
    if with_inputs:
        low_feats = ref.features([(torch.tensor(r.prompt), r.extras) for r in with_inputs])
        for r, (rows, feats) in zip(with_inputs, low_feats):
            e = embeds[r.index].clone()
            e[rows.to(e.device)] = feats.to(e.device, e.dtype)
            embeds[r.index] = e
    return dataclasses.replace(run, records=records, embeds=embeds)


def judged(compared: dict) -> dict:
    return dict(correct=all(c["ok"] for c in compared.values()),
                **{k: c["value"] for k, c in compared.items()})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()

    import torch

    from portbench import check, harness

    dev = torch.device("cuda")
    spec = harness.cell_files(ROOT, args.workload)[3]
    out = ROOT / "chiprun_out" / f"calibrate-{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for seed in args.seeds:
        _, run, _ = harness.serve(ROOT, args.workload, seed, args.seconds, False)
        t0 = time.perf_counter()
        picked = check.sample(run, seed, spec["sample_tokens"])
        line = dict(workload=args.workload, seed=seed,
                    program=judged(check.compare(run, run.cfg, spec, seed, dev)),
                    reference_s=time.perf_counter() - t0,
                    sampled_requests=len(picked),
                    sampled_with_inputs=sum(1 for r in picked if r.extras),
                    run=harness.diagnostics(run))
        if args.control:
            ctrl = control_run(run, spec, seed, dev)
            line["control"] = judged(check.compare(ctrl, run.cfg, spec, seed, dev))
        line["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
