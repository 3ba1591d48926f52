"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number that decides
``correct`` beside its limit (also the last lines on standard error).
Exits non-zero, printing no result, without enough CUDA devices, or if
JAX, Flax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
# every compiler cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# a library that could load JAX or Flax by itself is told not to
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.cell_files(ROOT, args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    bad = result.pop("_forbidden")
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(f"diagnostics: {json.dumps(result.pop('diagnostics'))}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['holds']} {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
