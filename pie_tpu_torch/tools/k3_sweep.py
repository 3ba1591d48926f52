"""K3 (the paged decode attention) beside copies of itself with another
launch geometry or one part taken out, timed at 8 lanes x 2,048-token
contexts on one CUDA card.

    python -m pie_tpu_torch.tools.k3_sweep [--splits 1 2 4 8] [--extra NAME=file.cu]

Variants, each built from csrc/paged_attention.cu by editing source lines:

- ``kernel``: K3 as it ships;
- ``stages=3``: three cp.async stages per warp in place of two;
- ``warps=2``: two warps per block (more blocks per SM where shared
  memory allows);
- ``single P``: the probabilities rounded to one bf16 for PV (one mma per
  step in place of the hi + lo pair; its results are less exact);
- ``copies only``: the page walk with no QK, softmax or PV (results wrong
  by design): what the copies and the merges alone take.

Each variant's page splits follow ``page_splits`` from its own blocks per
SM; ``--splits`` also times the shipped kernel at each given split count.
Cases: the Llama-3-8B heads (32 / 8, D 128) on INT8 and bf16 pages, and
the Llama-3.2-1B heads (32 / 8, D 64) on INT8 pages. Times are device time
per call from a captured CUDA graph over the 4 layers of the pool; each
line carries the card's name and power limit and the bound (bytes over
3.35 TB/s).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from pie_tpu_torch.ops import paged_attention as pa
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.tools.decode_ab import k3_inputs
from pie_tpu_torch.tools.hbm_peak import HBM_BYTES_PER_S
from pie_tpu_torch.tools.k1_breakdown import build_all
from pie_tpu_torch.tools.prefill_ab import device_ms

CASES = [("8B int8", 32, 8, 128, True), ("8B bf16", 32, 8, 128, False),
         ("1B int8", 32, 8, 64, True)]
LAYERS = 4

STAGES = "constexpr int kStages = 2;"
WARPS = "static constexpr int kWarps = (!kQ8 && D == 128) ? 2 : 4;"
LO_MMA = re.compile(r"\n\s*mma_16816\(o\[mt\]\[[^]]*\], alo\[mt\][^;]*;")
COMPUTE = re.compile(r"\n    // scores: tile j.*?\n(    __syncwarp\(\);  // this stage is free)", re.S)


def variant_sources(src: str) -> dict[str, str]:
    for what, n in ((src.count(STAGES), 1), (src.count(WARPS), 1),
                    (len(LO_MMA.findall(src)), 3), (len(COMPUTE.findall(src)), 1)):
        if what != n:
            raise RuntimeError("paged_attention.cu no longer has the lines the variants edit")
    return {"kernel": src, "stages=3": src.replace(STAGES, STAGES.replace("2", "3")),
            "warps=2": src.replace(WARPS, "static constexpr int kWarps = 2;"),
            "single P": LO_MMA.sub("", src),
            "copies only": COMPUTE.sub(r"\n\1", src)}


def bind(lib: Path) -> dict:
    fns = {}
    for entry in ("paged_attention", "paged_attention_geometry"):
        _, symbol, argtypes = qmc.ENTRY_POINTS[entry]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[entry] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=path.cu")
    ap.add_argument("--splits", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    sources = variant_sources((qmc.CSRC / "paged_attention.cu").read_text())
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    qmc.build()
    dev = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory(dir=qmc.BUILD_ROOT, prefix="k3-variants-") as tmp:
        libs = {name: bind(lib) for name, lib in build_all(sources, Path(tmp)).items()}
        for case, hq, hkv, d, quantized in CASES:
            q, k, v, ks, vs, tables, ctx, nbytes = k3_inputs(hq, hkv, d, quantized, LAYERS)
            scale = d ** -0.5
            call = lambda i: pa.paged_attention_decode(q, k, v, ks, vs, i % LAYERS, tables,
                                                       ctx, scale)
            row = dict(case=f"K3 {case} 8 x 2048", card=card,
                       bound_us=nbytes / HBM_BYTES_PER_S * 1e6)
            for name, fns in libs.items():
                qmc._libs.update(fns)
                pa._geometry.clear()
                plan = pa.launch_plan(dev, 8, hq, hkv, d, tables.shape[1], quantized)
                row[f"{name} us"] = device_ms(call) * 1e3
                row[f"{name} plan"] = plan
            qmc._libs.update(libs["kernel"])
            pa._geometry.clear()
            real = pa.page_splits
            for splits in args.splits:
                pa.page_splits = lambda *a, n=splits: min(n, tables.shape[1])
                try:
                    row[f"kernel, {splits} splits us"] = device_ms(call) * 1e3
                finally:
                    pa.page_splits = real
            print(json.dumps(row), flush=True)
            del q, k, v, ks, vs
            torch.cuda.empty_cache()
    for entry in ("paged_attention", "paged_attention_geometry"):
        qmc._libs.pop(entry, None)
    pa._geometry.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
