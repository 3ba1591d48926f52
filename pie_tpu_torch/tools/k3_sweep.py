"""K3 (the paged decode attention) beside copies of itself with another
launch geometry or one part taken out, timed at 8 lanes x 2,048-token
contexts on one CUDA card.

    python -m pie_tpu_torch.tools.k3_sweep [--heads 64 128 256] [--splits 1 2 4 8]
        [--extra NAME=file.cu]

Variants, each built from csrc/paged_attention.cu by editing source lines,
each timed on the cases its edit reaches:

- ``kernel``: K3 as it ships;
- ``stages=3`` (D 64 / 128): three cp.async stages per warp in place of
  two;
- ``warps=2`` (D 64 / 128): two warps per block (more blocks per SM where
  shared memory allows);
- ``ring stages=2``, ``ring stages=3``, ``ring stages=6`` (D 256; three and
  six: INT8 pages only): the TMA page ring of each block two, three (two
  blocks an SM) or six pages deep in place of four (bf16: three, all a
  block's shared memory holds);
- ``consumer warps=2`` (D 256): each page's 16-token slices dealt to two
  warps in place of four;
- ``single P``: the probabilities rounded to one bf16 for PV (one mma per
  step in place of the hi + lo pair; its results are less exact);
- ``copies only``: the page walk with no QK, softmax or PV (results wrong
  by design): what the copies, the waits and the merges alone take;
- ``no walk`` (D 256): no page walked at all: what the launch, the
  block's prologue and the two merges alone take.

Each variant's page splits follow ``page_splits`` from its own blocks per
SM; ``--splits`` also times the shipped kernel at each given split count.
Cases: the Llama-3-8B heads (32 / 8, D 128) on INT8 and bf16 pages, the
Llama-3.2-1B heads (32 / 8, D 64) on INT8 pages, and the Gemma-3 4B heads
(8 / 4, D 256) on INT8 and bf16 pages, windowed to 1,024 tokens (its 29
sliding layers) and full (its 5 global ones). Times are device time per
call from a captured CUDA graph over the 4 layers of the pool; each line
carries the card's name and power limit, the bound (the walked bytes over
the data sheet's 3.35 TB/s) and the probe bound (the same bytes over the
read rate B7 measures at the start of the run).
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
from pie_tpu_torch.tools import hbm_peak
from pie_tpu_torch.tools.decode_ab import k3_inputs
from pie_tpu_torch.tools.hbm_peak import HBM_BYTES_PER_S
from pie_tpu_torch.tools.k1_breakdown import build_all
from pie_tpu_torch.tools.prefill_ab import device_ms

# label, Hq, Hkv, D, INT8 pages, window
CASES = [("8B int8", 32, 8, 128, True, 0), ("8B bf16", 32, 8, 128, False, 0),
         ("1B int8", 32, 8, 64, True, 0),
         ("4B int8 window 1024", 8, 4, 256, True, 1024), ("4B int8 full", 8, 4, 256, True, 0),
         ("4B bf16 window 1024", 8, 4, 256, False, 1024), ("4B bf16 full", 8, 4, 256, False, 0)]
LAYERS = 4

# the D 64 / 128 kernel
STAGES = "constexpr int kStages = 2;"
WARPS = "static constexpr int kWarps = (!kQ8 && D == 128) ? 2 : 4;"
LO_MMA = re.compile(r"\n\s*mma_16816\(o\[mt\]\[[^]]*\], alo\[mt\][^;]*;")
COMPUTE = re.compile(r"\n    // scores: tile j.*?\n(    __syncwarp\(\);  // this stage is free)", re.S)
# the D 256 kernel
RING = "constexpr int kRingStages = 4;"
CONSUMERS = "constexpr int kConsumerWarps = 4;"
LO_MMA_256 = re.compile(r"\n\s*mma_16816\(o\[[^]]*\]\[nt\], a, bl\[nt\]\[0\], bl\[nt\]\[1\]\);")
COMPUTE_256 = re.compile(r"\n      // S\^T = K q\^T.*?\n(      // this warp's last slice)", re.S)
WALK_256 = "const int n = max(min(p_hi, pb + per) - pb, 0);"

# the (head dim, INT8 pages) cases each edit reaches
SMALL = ((64, True), (64, False), (128, True), (128, False))
D256 = ((256, True), (256, False))
# name: (cases the edit reaches, [(needle or pattern, replacement, matches)])
VARIANTS = {
    "stages=3": (SMALL, [(STAGES, STAGES.replace("2", "3"), 1)]),
    "warps=2": (SMALL, [(WARPS, "static constexpr int kWarps = 2;", 1)]),
    "ring stages=2": (D256, [(RING, RING.replace("4", "2"), 1)]),
    # bf16's ring holds three 64 KB pages whatever the setting
    "ring stages=3": (((256, True),), [(RING, RING.replace("4", "3"), 1)]),
    "ring stages=6": (((256, True),), [(RING, RING.replace("4", "6"), 1)]),
    "consumer warps=2": (D256, [(CONSUMERS, CONSUMERS.replace("4", "2"), 1)]),
    "single P": (SMALL + D256, [(LO_MMA, "", 3), (LO_MMA_256, "", 2)]),
    "copies only": (SMALL + D256, [(COMPUTE, r"\n\1", 1), (COMPUTE_256, r"\n\1", 1)]),
    "no walk": (D256, [(WALK_256, "const int n = 0;", 1)]),
}


def variant_sources(src: str) -> dict[str, str]:
    """{name: source} of the shipped kernel and each variant; raises when
    the source no longer has the lines a variant edits."""
    out = {"kernel": src}
    for name, (_, edits) in VARIANTS.items():
        text = src
        for pattern, repl, count in edits:
            found = (len(pattern.findall(text)) if isinstance(pattern, re.Pattern)
                     else text.count(pattern))
            if found != count:
                what = pattern.pattern if isinstance(pattern, re.Pattern) else pattern
                raise RuntimeError(f"paged_attention.cu no longer has the lines the "
                                   f"{name!r} variant edits: {count} x {what!r}, found {found}")
            text = (pattern.sub(repl, text) if isinstance(pattern, re.Pattern)
                    else text.replace(pattern, repl))
        out[name] = text
    return out


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
    ap.add_argument("--heads", type=int, nargs="*", default=[64, 128, 256],
                    help="head dims of the cases to time")
    ap.add_argument("--splits", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    sources = variant_sources((qmc.CSRC / "paged_attention.cu").read_text())
    reach = {name: cases for name, (cases, _) in VARIANTS.items()}
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
        reach[name] = SMALL + D256
    qmc.build()
    probe = hbm_peak.measure(hbm_peak.make_buffer(2))["probe_bytes_per_s"]
    torch.cuda.empty_cache()
    print(json.dumps(dict(probe_bytes_per_s=probe, card=card)), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory(dir=qmc.BUILD_ROOT, prefix="k3-variants-") as tmp:
        libs = {name: bind(lib) for name, lib in build_all(sources, Path(tmp)).items()}
        for case, hq, hkv, d, quantized, window in CASES:
            if d not in args.heads:
                continue
            q, k, v, ks, vs, tables, ctx, nbytes = k3_inputs(hq, hkv, d, quantized, LAYERS,
                                                             window=window)
            scale = d ** -0.5
            call = lambda i: pa.paged_attention_decode(q, k, v, ks, vs, i % LAYERS, tables,
                                                       ctx, scale, window)
            row = dict(case=f"K3 {case}, 8 x 2048", card=card, bytes=nbytes,
                       bound_us=nbytes / HBM_BYTES_PER_S * 1e6,
                       probe_bound_us=nbytes / probe * 1e6)
            for name, fns in libs.items():
                if name != "kernel" and (d, quantized) not in reach[name]:
                    continue
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
