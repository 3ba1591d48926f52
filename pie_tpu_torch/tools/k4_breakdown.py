"""Where K4's time goes: the kernel beside copies of itself with one part
taken out or switched, timed at the Llama-3.2-1B decode shapes (and the
8B widths K4 is only recorded at) on one CUDA card.

    python -m pie_tpu_torch.tools.k4_breakdown [--cases 1b-m1 1b-m8 ...]

Variants, each built from csrc/fused_mlp.cu by editing source lines; all
but the first give wrong results by design, and only their times are
read:

- ``kernel``: K4 as it ships.
- ``no consumers``: the consumer warps run no mma and no code conversion;
  the copies, the x rows, the split-K epilogues and the barriers stay.
- ``copies only``: no consumers, and the x warp writes zero rows without
  reading attn, h2 or act: the TMA weight stream, the epilogues and the
  barriers.
- ``no grid barriers``: nobody waits at either grid barrier (the arrivals
  stay).
- ``wo alone``, ``wgu alone``, ``wd alone``: every role walks one phase's
  tasks only, and nobody waits at a grid barrier.
- ``no prefetch``: the producer waits for a phase's grid barrier before
  it issues the phase's first weight copy, as a design without cross-phase
  prefetch must.
- ``stream only``: the weight copies alone: no x rows, no consumers, no
  epilogues, nobody waits at a grid barrier (the floor the TMA stream of
  these tasks sets).
- ``empty``: every role walks no task: the launch, the set-up (mbarriers,
  the ln2 row) and the exit of the cooperative grid.

``--extra NAME=path.cu`` adds another source with K4's C entry points (a
design under study). Times are device time per call from a captured CUDA
graph over 8 rotating weight copies; each line carries the plan and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from pie_tpu_torch.ops import fused_mlp as fm
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.tools.hbm_peak import HBM_BYTES_PER_S
from pie_tpu_torch.tools.k1_breakdown import bind, build_all
from pie_tpu_torch.tools.prefill_ab import ROTATE, device_ms, random_weights

# name: (d, di, M, bits)
CASES = {"1b-m1": (2048, 8192, 1, 4), "1b-m8": (2048, 8192, 8, 4),
         "1b-m8-int8": (2048, 8192, 8, 8), "8b-m8": (4096, 14336, 8, 4)}

CONSUME = "consume_stage<BITS, F32S, G>(smem + s * sbytes, fl, sfl, r4, t, acc, part);"
X_READS = "if (n < M)\n              cp_async16("
BARRIER_WAIT = ("while (ld_acquire(a.counters + 2 * (p - 1) + 1) == gen_seen[p - 1]) "
                "__nanosleep(64);")
PHASES = "#pragma unroll 1\n  for (int p = 0; p < 3; ++p) {"
PRODUCER = "const CUtensorMap* mw = &maps.m[3 * p];"
EPILOGUE = "    // the tile's f32 sums -> Ct[token][feature]"


def variant_sources(src: str) -> dict[str, str]:
    for needle, count in ((CONSUME, 1), (X_READS, 1), (BARRIER_WAIT, 1), (PHASES, 1),
                          (PRODUCER, 1), (EPILOGUE, 1)):
        if src.count(needle) != count:
            raise RuntimeError(f"fused_mlp.cu has not {count} copies of {needle!r}")
    no_consumers = src.replace(CONSUME, "")
    out = {"kernel": src, "no consumers": no_consumers,
           "copies only": no_consumers.replace(X_READS, X_READS.replace("n < M", "false")),
           "no grid barriers": src.replace(BARRIER_WAIT, ";")}
    for p, name in enumerate(("wo", "wgu", "wd")):
        out[f"{name} alone"] = out["no grid barriers"].replace(
            PHASES, PHASES.replace("p = 0; p < 3", f"p = {p}; p < {p + 1}"))
    out["no prefetch"] = src.replace(PRODUCER, "if (p > 0) " + BARRIER_WAIT + "\n" + PRODUCER)
    out["stream only"] = out["copies only"].replace(BARRIER_WAIT, ";").replace(
        EPILOGUE, "    return;\n" + EPILOGUE)
    out["empty"] = src.replace(PHASES, PHASES.replace("p < 3", "p < 0"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=path.cu")
    ap.add_argument("--cases", nargs="*", default=list(CASES), choices=list(CASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    sources = variant_sources((qmc.CSRC / "fused_mlp.cu").read_text())
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    qmc.build()
    with tempfile.TemporaryDirectory(dir=qmc.BUILD_ROOT, prefix="k4-variants-") as tmp:
        libs = build_all(sources, Path(tmp))
        fns = {name: bind(lib, "fused_mlp") for name, lib in libs.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        for case in args.cases:
            d, di, m, bits = CASES[case]
            wo, wgu, wd = (random_weights(k, n, gen, bits=bits)
                           for k, n in ((d, d), (d, 2 * di), (di, d)))
            ln2 = (1 + 0.1 * torch.randn((ROTATE, d), generator=gen, device="cuda")).bfloat16()
            attn, h = (torch.randn((m, d), generator=gen, device="cuda").bfloat16()
                       for _ in range(2))
            nbytes = sum(w.packed[0].numel() * 4 + 2 * w.scales[0].numel() * 2
                         for w in (wo, wgu, wd))
            plan = fm.mlp_plan(m, d, d, di, bits, 64, sms=qmc._device_sms(attn.device),
                               blocks_per_sm=fm._blocks_per_sm(attn.device, bits, 64, 0, d))
            row = dict(case=f"K4 {case}", d=d, di=di, m=m, bits=bits, card=card,
                       bound_us=nbytes / HBM_BYTES_PER_S * 1e6, plan=plan.summary())
            call = lambda i: fm.fused_mlp_stacked(attn, h, ln2, i % ROTATE, wo, wgu, wd, 1e-5)
            for name, fn in fns.items():
                qmc._libs["fused_mlp"] = fn
                row[f"{name} us"] = device_ms(call) * 1e3
            qmc._libs["fused_mlp"] = fns["kernel"]
            print(json.dumps(row), flush=True)
            del wo, wgu, wd
            torch.cuda.empty_cache()
        qmc._libs.pop("fused_mlp", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
