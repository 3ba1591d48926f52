"""Where K1's time goes: the kernel beside copies of itself with one part
taken out, timed at the Llama-3-8B decode shapes on one CUDA card.

    python -m pie_tpu_torch.tools.k1_breakdown [--rows 1 8 32] [--splits 1 4 ...]

Variants, each built from csrc/quant_gemv.cu by editing source lines
(their results are wrong by design; only their times are read):

- ``kernel``: K1 as it ships.
- ``no mma``: each mma.sync becomes one f32 add of its operands' bits,
  so the loads and code conversions stay: TMA, conversion, the fold.
- ``no convert``: the A fragments are the raw packed words (no prmt,
  lop3, bf16 fma): TMA, shared loads, mma, the fold.
- ``no x sums``: the x-sum warp releases each stage without summing.
- ``TMA only``: the consumers run no k step: the copies, the x sums, the
  barriers, the epilogue.
- ``no TMA``: nothing is copied and nobody waits (the stages hold whatever
  they held): the consumers' work from shared memory alone.

``--extra NAME=path.cu`` adds another source with K1's C entry point (a
design under study). ``--splits`` also times the kernel with each given
number of K ranges forced in place of gemv_plan's choice. Times are device
time per call (the ln pre-pass included where the shape has the prologue)
from a captured CUDA graph over 8 rotating weight copies; each line
carries the card's name and power limit.
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
from pie_tpu_torch.ops.rope import make_inv_freq, rope_qkv_cs
from pie_tpu_torch.tools.hbm_peak import HBM_BYTES_PER_S
from pie_tpu_torch.tools.prefill_ab import ROTATE, device_ms, random_weights

# Llama-3-8B decode projections: name, K, N, launches per token, ln, rope
SHAPES_8B = [("wqkv", 4096, 6144, 32, True, True), ("wo", 4096, 4096, 32, False, False),
             ("wgu", 4096, 28672, 32, True, False), ("wd", 14336, 4096, 32, False, False),
             ("lm_head", 4096, 128256, 1, True, False)]

MMA = re.compile(r"\n(\s*)mma_16816\(part\[j\], (a\[[01]\]), (prmt\([^)]*\)), (prmt\([^)]*\))\);")
CONVERT = re.compile(r"= int[48]_pair_w\((w[01]?\.[xy])[^;]*;")
SUMS = re.compile(r"\n\s*v \+= sum8\([^;]*;")
KSTEPS = "for (int kq = 0; kq < KS / 32; ++kq) {"
# the copies, and every wait (without copies a wait could hang)
TMA = re.compile(r"\n\s*(mbar_expect_tx\(bar, tx\)|tma_load_2d\(st[^;]*\)"
                 r"|mbar_wait\((full0|ready0|empty0)[^;]*\));")


def variant_sources(src: str) -> dict[str, str]:
    for pattern, count in ((MMA, 2), (CONVERT, 16), (SUMS, 1), (TMA, 10)):
        if len(pattern.findall(src)) != count:
            raise RuntimeError(f"quant_gemv.cu has not {count} matches of {pattern.pattern!r}")
    if src.count(KSTEPS) != 1:
        raise RuntimeError("quant_gemv.cu: the k-step loop is not found")
    no_mma = MMA.sub(r"\n\1part[j][0] += __uint_as_float(\2[0] ^ \2[1] ^ \2[2] ^ \2[3] ^ \3 ^ \4);",
                     src)
    return {"kernel": src, "no mma": no_mma, "no convert": CONVERT.sub(r"= \1;", src),
            "no x sums": SUMS.sub("", src),
            "TMA only": src.replace(KSTEPS, KSTEPS.replace("kq < KS / 32", "kq < 0")),
            "no TMA": TMA.sub("", src)}


def build_all(sources: dict[str, str], out: Path) -> dict[str, Path]:
    """One nvcc per source, all started together (the kernels' flags; the
    csrc headers on the include path)."""
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out / f"k1_{i}.cu"
        cu.write_text(text)
        lib = out / f"libk1_{i}.so"
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


def bind(lib: Path, entry: str = "quant_gemv"):
    _, symbol, argtypes = qmc.ENTRY_POINTS[entry]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def forced_plan(splits: int):
    """gemv_plan with ``splits`` K ranges in place of its own choice."""
    real = qmc.gemv_plan

    def plan(m, n, padded_k, group_size, rope_dim=0, sms=qmc.H100_SMS):
        p = real(m, n, padded_k, group_size, rope_dim, sms)
        per = -(-p.stages // min(splits, p.stages))
        return dataclasses.replace(p, splits=-(-p.stages // per), stages_per_split=per)

    return plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=path.cu")
    ap.add_argument("--rows", type=int, nargs="*", default=[1, 8, 32])
    ap.add_argument("--splits", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    sources = variant_sources((qmc.CSRC / "quant_gemv.cu").read_text())
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    qmc.build()
    with tempfile.TemporaryDirectory(dir=qmc.BUILD_ROOT, prefix="k1-variants-") as tmp:
        fns = {name: bind(lib) for name, lib in build_all(sources, Path(tmp)).items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        for m in args.rows:
            totals = {name: 0.0 for name in fns}
            nbytes = 0
            for shape, k, n, per, ln, rope in SHAPES_8B:
                qt = random_weights(k, n, gen)
                x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
                kw = {}
                if ln:
                    kw.update(ln_w=(1 + 0.1 * torch.randn((ROTATE, k), generator=gen,
                                                          device="cuda")).bfloat16(),
                              ln_eps=1e-5)
                if rope:
                    inv = torch.from_numpy(make_inv_freq(128, 500000.0)).cuda()
                    pos = torch.arange(m, dtype=torch.int32, device="cuda") + 100
                    kw.update(rope_cs=rope_qkv_cs(pos, inv, 32, 8, 128), rope_dim=128)
                wbytes = k // 8 * n * 4 + 2 * (k // 64) * n * 2
                nbytes += per * wbytes
                row = dict(case=f"8B {shape} M={m}", m=m, k=k, n=n, card=card,
                           bound_us=wbytes / HBM_BYTES_PER_S * 1e6,
                           plan=qmc.gemv_plan(m, n, k, 64, kw.get("rope_dim", 0)).__dict__)
                call = lambda i: qmc.quant_gemv(x, qt, layer=i % ROTATE, **kw)
                for name, fn in fns.items():
                    qmc._libs["quant_gemv"] = fn
                    ms = device_ms(call)
                    row[f"{name} us"] = ms * 1e3
                    totals[name] += per * ms
                qmc._libs["quant_gemv"] = fns["kernel"]
                real = qmc.gemv_plan
                for splits in args.splits:
                    qmc.gemv_plan = forced_plan(splits)
                    try:
                        row[f"kernel, {splits} K ranges us"] = device_ms(call) * 1e3
                    finally:
                        qmc.gemv_plan = real
                print(json.dumps(row), flush=True)
                del qt
                torch.cuda.empty_cache()
            print(json.dumps({"case": f"K1 per 8B decode step at M = {m} (129 launches), ms",
                              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "card": card,
                              **totals}), flush=True)
        qmc._libs.pop("quant_gemv", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
