"""Where K2's time goes: the kernel beside copies of itself with one part
taken out, timed at the Llama-3-8B prefill shapes on one CUDA card.

    python -m pie_tpu_torch.tools.k2_breakdown [--extra NAME=path.cu ...]

Variants, each built from csrc/quant_gemm.cu by removing source lines
(their results are wrong by design; only their times are read):

- ``kernel``: K2 as it ships.
- ``no dequant``: the consumers build their register A fragments for
  the first step only, so every wgmma reuses them: TMA, wgmma and the
  barriers.
- ``no wgmma``: the consumers issue no wgmma: TMA, dequantization and the
  barriers.
- ``no dequant, no wgmma``: TMA and the barriers alone.
- ``no TMA``: the producer copies nothing and waits for nothing, and the
  consumers wait for no copy (the stages hold whatever they held):
  dequantization and wgmma from shared memory alone. ``dequant only`` and ``wgmma
  only`` take the other part out of that too.

``--extra`` adds another source with K2's C entry point, timed the same
way (a design under study). ``--splits`` also times the kernel with each
given number of K ranges forced in place of gemm_plan's choice. Times are
device time per call from a captured CUDA graph over 8 rotating weight
copies; each line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.tools.hbm_peak import BF16_FLOP_PER_S
from pie_tpu_torch.tools.prefill_ab import ROTATE, device_ms, random_weights

# the statements the variants remove: the dequantization of every step
# after the first, and the wgmma instructions
DEQUANT = re.compile(r"\n\s*build_frags<BITS, F32S>\(smem \+ s1[^;]*;")
WGMMA = re.compile(r"\n\s*for \(int kk = 0; kk < BK / 16; \+\+kk\) wgmma_rs_m64n\d+k16[^;]*;")

# Llama-3-8B prefill projections: name, K, N, launches per 512-token prefill
SHAPES_8B = [("wqkv", 4096, 6144, 32), ("wo", 4096, 4096, 32),
             ("wgu", 4096, 28672, 32), ("wd", 14336, 4096, 32),
             ("lm_head", 4096, 128256, 1)]


# the producer's copies, its waits for free stages (without copies the
# consumers may run two rounds ahead, and a parity wait would then hang)
# and the consumers' waits for the copies
TMA = re.compile(r"\n\s*(mbar_expect_tx\(bar, tx\)|tma_load_2d\(st \+ [^;]*\)"
                 r"|if \(i >= stages\) mbar_wait\(empty0[^;]*\)|mbar_wait\(full0[^;]*\));")


def variant_sources(src: str) -> dict[str, str]:
    for pattern, count in ((DEQUANT, 1), (WGMMA, 1), (TMA, 8)):
        if len(pattern.findall(src)) != count:
            raise RuntimeError(f"quant_gemm.cu has not {count} matches of {pattern.pattern!r}")
    no_dq = DEQUANT.sub("", src)
    no_tma = TMA.sub("", src)
    return {"kernel": src, "no dequant": no_dq, "no wgmma": WGMMA.sub("", src),
            "no dequant, no wgmma": WGMMA.sub("", no_dq), "no TMA": no_tma,
            "dequant only": WGMMA.sub("", no_tma), "wgmma only": DEQUANT.sub("", no_tma)}


def build_all(sources: dict[str, str], out: Path) -> dict[str, Path]:
    """One nvcc per source, all started together (K2's flags; the csrc
    headers on the include path)."""
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out / f"k2_{i}.cu"
        cu.write_text(text)
        lib = out / f"libk2_{i}.so"
        cmd = [qmc._nvcc(), *qmc.NVCC_FLAGS, "-I", str(qmc.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def bind(lib: Path):
    _, symbol, argtypes = qmc.ENTRY_POINTS["quant_gemm"]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def forced_plan(splits: int):
    """gemm_plan with ``splits`` K ranges (on its split units) in place of
    its own choice."""
    real = qmc.gemm_plan

    def plan(m, n, padded_k, group_size, rope_dim=0, sms=qmc.H100_SMS):
        p = real(m, n, padded_k, group_size, rope_dim, sms)
        unit = max(qmc.GEMM_TILE_K, group_size) // qmc.GEMM_TILE_K
        units = p.steps // unit
        per = -(-units // min(splits, units)) * unit
        return dataclasses.replace(p, splits=-(-p.steps // per), steps_per_split=per)

    return plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=path.cu")
    ap.add_argument("--rows", type=int, nargs="*", default=[512, 40])
    ap.add_argument("--splits", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    sources = variant_sources((qmc.CSRC / "quant_gemm.cu").read_text())
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    qmc.build()
    with tempfile.TemporaryDirectory(dir=qmc.BUILD_ROOT, prefix="k2-variants-") as tmp:
        fns = {name: bind(lib) for name, lib in build_all(sources, Path(tmp)).items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        totals = {name: 0.0 for name in fns}
        for m in args.rows:
            x = torch.randn((m, 4096), generator=gen, device="cuda").bfloat16()
            for shape, k, n, per in SHAPES_8B:
                if m != 512 and shape in ("wgu", "lm_head"):
                    continue
                qt = random_weights(k, n, gen)
                xk = x if k == 4096 else torch.randn((m, k), generator=gen,
                                                     device="cuda").bfloat16()
                row = dict(case=f"8B {shape} M={m}", m=m, k=k, n=n, card=card,
                           plan=qmc.gemm_plan(m, n, k, 64).__dict__)
                for name, fn in fns.items():
                    qmc._libs["quant_gemm"] = fn
                    ms = device_ms(lambda i: qmc.quant_gemm(xk, qt, layer=i % ROTATE))
                    row[f"{name} us"] = ms * 1e3
                    row[f"{name} TFLOP/s"] = 2 * m * k * n / ms / 1e9
                    if m == 512:
                        totals[name] += per * ms
                qmc._libs["quant_gemm"] = fns["kernel"]
                real = qmc.gemm_plan
                for splits in args.splits:
                    qmc.gemm_plan = forced_plan(splits)
                    try:
                        ms = device_ms(lambda i: qmc.quant_gemm(xk, qt, layer=i % ROTATE))
                    finally:
                        qmc.gemm_plan = real
                    row[f"kernel, {splits} K ranges us"] = ms * 1e3
                print(json.dumps(row), flush=True)
                del qt
            torch.cuda.empty_cache()
        qmc._libs.pop("quant_gemm", None)
    if 512 in args.rows:
        print(json.dumps({"case": "K2 per 8B 512-token prefill (129 launches), ms",
                          "card": card, **totals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
