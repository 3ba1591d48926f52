"""B7: the device-memory read probe, the port's twin of
``benchmarks/hbm_peak.py``, on one CUDA card.

    python -m pie_tpu_torch.tools.hbm_peak [--gb 4] [--sweep]

``stream_read(x, path)`` folds a contiguous 4-byte array ``x [R, n]`` (R a
multiple of 8, n of 4) into ``out [8, n]`` f32, ``out[r, c] = sum_i
f32_bits(x[8i + r, c])``, reading every byte once, with the hand-written
kernel of ``csrc/hbm_read.cu``: ``path="ldg"`` through 16-byte register
loads, ``path="tma"`` through 1-D TMA bulk copies into a shared-memory
ring. The JAX kernel (``benchmarks/hbm_peak.py`` ``stream_read``) adds the
first 8 rows of each ``rows``-row block, and its BlockSpec DMA reads the
rest unused; on a GPU only what a kernel loads moves, so the port's
function is the ``rows = 8`` one, where every row counts.

The CLI times both paths with CUDA events (5 runs of 10 launches after a
warm-up, on a buffer of integer-valued f32 far over the
50 MB L2) and reports the best and the median, each path's plan (grid,
bytes in flight per SM), its result against the plain version, and as
yardsticks ``torch.sum`` over the folded view (one PyTorch call for the
same function) and a device-to-device ``copy_`` (bytes read plus bytes
written). ``--sweep`` walks the buffer size (1-8 GiB), the unroll or the
ring's depth and chunk, and the blocks per SM, one JSON line a setting.
The last line carries the card's name and power limit.

This module is the one home of the data sheet's rates (``HBM_BYTES_PER_S``,
``BF16_FLOP_PER_S``) that every bound in the port divides by.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys

import torch

#: H100 SXM data sheet: HBM3 read rate, dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

PATHS = ("ldg", "tma")
#: kernel launches since the last reset, by path (one per stream_read call
#: on the card; each call also runs the small launch that sums the partials)
launch_counts = {"B7 ldg": 0, "B7 tma": 0}

#: the register-load kernel: 8 warps a block, a 128-float4 column tile
LDG_WARPS, LDG_TILE_F4 = 8, 128
#: the TMA kernel: 256 consumer threads and one producer warp a block
TMA_CONSUMERS = 256
UNROLLS = (1, 2, 4, 8)
CHUNK_KB = (16, 32)
MIN_STAGES, MAX_STAGES = 2, 8
#: KB of ring a block may hold: 227 KB of shared memory less the barriers
MAX_RING_KB = 224
#: the knobs a path takes unless told otherwise (ldg: unroll; tma: chunk_kb,
#: stages); each within 1 % of the sweep's best on the H100 (PERF.md)
DEFAULT_UNROLL, DEFAULT_CHUNK_KB, DEFAULT_STAGES = 2, 16, 4
#: runs of a timing, each of ITERS back-to-back launches
RUNS, ITERS = 5, 10

_occupancy: dict = {}


def reset_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class ReadPlan:
    """One launch of a path: columns cut into tiles, slabs (8-row blocks)
    dealt over slab groups; the grid is tiles x groups blocks, at most
    blocks_per_sm x sms, so every block is resident at once."""

    path: str
    slabs: int
    col4: int  # float4 columns of a slab (2n)
    col_tiles: int
    groups: int
    sms: int
    blocks_per_sm: int
    unroll: int
    chunk_kb: int
    stages: int

    @property
    def grid(self) -> int:
        return self.col_tiles * self.groups

    @property
    def in_flight_per_sm(self) -> int:
        """Bytes a full SM keeps requested: the loads each thread issues
        before it adds any (ldg), or the ring's chunks (tma)."""
        if self.path == "ldg":
            return self.blocks_per_sm * LDG_WARPS * 32 * self.unroll * 4 * 16
        return self.blocks_per_sm * self.stages * self.chunk_kb * 1024

    def summary(self) -> dict:
        knobs = (dict(unroll=self.unroll) if self.path == "ldg"
                 else dict(chunk_kb=self.chunk_kb, stages=self.stages))
        return dict(path=self.path, grid=[self.col_tiles, self.groups], blocks=self.grid,
                    sms=self.sms, blocks_per_sm=self.blocks_per_sm,
                    in_flight_per_sm=self.in_flight_per_sm, **knobs)


def read_plan(rows: int, n: int, path: str, sms: int, blocks_per_sm: int,
              unroll: int = DEFAULT_UNROLL, chunk_kb: int = DEFAULT_CHUNK_KB,
              stages: int = DEFAULT_STAGES) -> ReadPlan:
    """The launch geometry of ``path`` for x [rows, n]: the largest number
    of slab groups whose grid fits blocks_per_sm x sms, and no more groups
    than the slabs give work to."""
    slabs, col4 = rows // 8, 2 * n
    if path == "ldg":
        tile, cap = LDG_TILE_F4, -(-slabs // LDG_WARPS)
    else:
        tile, cap = chunk_kb * 1024 // 16, slabs
    col_tiles = -(-col4 // tile)
    groups = max(1, min(cap, blocks_per_sm * sms // col_tiles))
    return ReadPlan(path, slabs, col4, col_tiles, groups, sms, blocks_per_sm, unroll,
                    chunk_kb, stages)


def _check(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x must lie on the CPU or a CUDA card, got {x.device}")
    if x.element_size() != 4 or x.dtype.is_complex:
        raise ValueError(f"x must have 4-byte elements (float32, int32), got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be [R, n], got shape {tuple(x.shape)}")
    rows, n = x.shape
    if rows < 8 or rows % 8:
        raise ValueError(f"R = {rows} must be a positive multiple of 8")
    if n < 4 or n % 4:
        raise ValueError(f"n = {n} must be a positive multiple of 4")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _knobs(path: str, unroll, chunk_kb, stages) -> tuple[int, int, int]:
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    unroll = DEFAULT_UNROLL if unroll is None else unroll
    chunk_kb = DEFAULT_CHUNK_KB if chunk_kb is None else chunk_kb
    stages = DEFAULT_STAGES if stages is None else stages
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    if chunk_kb not in CHUNK_KB:
        raise ValueError(f"chunk_kb must be one of {CHUNK_KB}, got {chunk_kb}")
    if not MIN_STAGES <= stages <= MAX_STAGES:
        raise ValueError(f"stages must be in [{MIN_STAGES}, {MAX_STAGES}], got {stages}")
    if path == "tma" and stages * chunk_kb > MAX_RING_KB:
        raise ValueError(f"a ring of {stages} x {chunk_kb} KB does not fit {MAX_RING_KB} KB "
                         "of shared memory")
    return unroll, chunk_kb, stages


def max_blocks_per_sm(device, path: str, unroll: int, chunk_kb: int, stages: int) -> int:
    """Blocks of the path's kernel resident on one SM (the CUDA occupancy
    query, cached)."""
    import ctypes

    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    key = (device, path, unroll, chunk_kb, stages)
    if key not in _occupancy:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = qmc.kernel("hbm_read_blocks_per_sm")(
                PATHS.index(path), unroll, chunk_kb, stages, ctypes.addressof(out))
        if err or out.value < 1:
            raise RuntimeError(f"B7 {path}: occupancy query failed (CUDA error {err})")
        _occupancy[key] = out.value
    return _occupancy[key]


def plan_for(x: torch.Tensor, path: str = "ldg", *, unroll=None, chunk_kb=None, stages=None,
             blocks_per_sm=None) -> ReadPlan:
    """The plan ``stream_read`` launches for x on its card."""
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    unroll, chunk_kb, stages = _knobs(path, unroll, chunk_kb, stages)
    most = max_blocks_per_sm(x.device, path, unroll, chunk_kb, stages)
    bps = most if blocks_per_sm is None else blocks_per_sm
    if not 1 <= bps <= most:
        raise ValueError(f"blocks_per_sm must be in [1, {most}], got {bps}")
    return read_plan(*x.shape, path, qmc._device_sms(x.device), bps, unroll, chunk_kb, stages)


def stream_read_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: every 8-row slab of x's f32 bits, summed."""
    return x.view(torch.float32).reshape(-1, 8, x.shape[1]).sum(0)


def stream_read(x: torch.Tensor, path: str = "ldg", *, unroll=None, chunk_kb=None,
                stages=None, blocks_per_sm=None) -> torch.Tensor:
    """out [8, n] f32, out[r, c] = sum_i f32_bits(x[8i + r, c]); on a CUDA
    tensor by B7's ``path`` kernel on the current stream, on a CPU tensor
    by the plain version."""
    _check(x)
    unroll, chunk_kb, stages = _knobs(path, unroll, chunk_kb, stages)
    if x.device.type == "cpu":
        return stream_read_plain(x)
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    plan = plan_for(x, path, unroll=unroll, chunk_kb=chunk_kb, stages=stages,
                    blocks_per_sm=blocks_per_sm)
    rows, n = x.shape
    part = torch.empty((plan.groups, 8, n), dtype=torch.float32, device=x.device)
    out = torch.empty((8, n), dtype=torch.float32, device=x.device)
    err = qmc.kernel("hbm_read")(
        x.data_ptr(), part.data_ptr(), out.data_ptr(), rows, n, PATHS.index(path), unroll,
        chunk_kb, stages, plan.groups, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"B7 {path} launch failed: CUDA error {err}")
    launch_counts[f"B7 {path}"] += 1
    return out


def read_rate(nbytes: float, ms: float) -> float:
    """Bytes per second of nbytes moved in ms; raises above the data sheet's
    rate, where the byte count or the timing must be wrong."""
    if ms <= 0:
        raise ValueError(f"time must be positive, got {ms} ms")
    rate = nbytes / (ms * 1e-3)
    if rate > HBM_BYTES_PER_S:
        raise ValueError(f"{rate / 1e12:.3f} TB/s is over the data sheet's "
                         f"{HBM_BYTES_PER_S / 1e12} TB/s: the bytes or the time are wrong")
    return rate


def make_buffer(gb: float, n: int = 2048, seed: int = 0, device="cuda") -> torch.Tensor:
    """An f32 [R, n] buffer of about ``gb`` GiB (R a multiple of 8) holding
    integers in [-8, 8]: every fold stays far under 2^24, so any order of
    summation gives the same bits."""
    rows = max(8, int(gb * (1 << 30)) // (4 * n) // 8 * 8)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-8, 9, (rows, n), generator=gen, device=device, dtype=torch.float32)


def time_runs(fn, iters: int = ITERS, runs: int = RUNS, warmup: int = 2) -> list[float]:
    """ms per call of each of ``runs`` runs of ``iters`` back-to-back calls
    (CUDA events around each run), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def _timing(ms: list[float], nbytes: int, rate: str = "read_bytes_per_s") -> dict:
    best, med = min(ms), statistics.median(ms)
    return {"ms": best, "median_ms": med, rate: read_rate(nbytes, best),
            f"median_{rate}": read_rate(nbytes, med),
            "share_of_data_sheet": read_rate(nbytes, best) / HBM_BYTES_PER_S}


def measure(x: torch.Tensor) -> dict:
    """The probe: each path's best and median ms over RUNS runs and its read
    rate, with its plan and its last result's max abs error against the
    plain version; the plain version's, ``torch.sum``'s over the folded view
    (the library call) and a same-size ``copy_``'s (read plus write bytes);
    the data sheet's bound; the best path's rate, ``probe_bytes_per_s``."""
    nbytes = x.numel() * 4
    rows, n = x.shape
    res = dict(bytes=nbytes, shape=[rows, n], bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes")
    last = {}
    res["plain"] = _timing(time_runs(
        lambda: last.__setitem__("plain", stream_read_plain(x))), nbytes)
    folded = x.view(torch.float32).view(rows // 8, 8 * n)
    res["library"] = dict(call="torch.sum(x.view(f32).view(R / 8, 8n), dim=0)",
                          **_timing(time_runs(lambda: torch.sum(folded, dim=0)), nbytes))
    for path in PATHS:
        ms = time_runs(lambda: last.__setitem__(path, stream_read(x, path)))
        res[path] = dict(plan=plan_for(x, path).summary(), **_timing(ms, nbytes),
                         max_abs_err=(last[path] - last["plain"]).abs().max().item())
    dst = torch.empty_like(x)
    res["copy"] = dict(bytes=2 * nbytes,
                       **_timing(time_runs(lambda: dst.copy_(x)), 2 * nbytes, "bytes_per_s"))
    del dst
    res["probe_bytes_per_s"] = max(res[p]["read_bytes_per_s"] for p in PATHS)
    return res


def sweep(card: str, sizes=(1, 2, 4, 8)) -> dict:
    """Each path at each buffer size over its knobs and blocks per SM; one
    JSON line a setting. Returns the best setting of each path and size."""
    best = {}
    for gb in sizes:
        x = make_buffer(gb)
        iters = max(4, round(32 / gb))
        want = stream_read_plain(x)
        settings = [("ldg", dict(unroll=u)) for u in UNROLLS]
        settings += [("tma", dict(chunk_kb=c, stages=s)) for c in CHUNK_KB
                     for s in (2, 3, 4, 6, 8) if s * c <= MAX_RING_KB]
        for path, kw in settings:
            most = max_blocks_per_sm(x.device, path, kw.get("unroll", DEFAULT_UNROLL),
                                     kw.get("chunk_kb", DEFAULT_CHUNK_KB),
                                     kw.get("stages", DEFAULT_STAGES))
            for bps in sorted({1, 2, most} & set(range(1, most + 1))):
                out = {}
                ms = time_runs(lambda: out.__setitem__(
                    "y", stream_read(x, path, blocks_per_sm=bps, **kw)), iters)
                row = dict(gb=gb, plan=plan_for(x, path, blocks_per_sm=bps, **kw).summary(),
                           equal=bool(torch.equal(out["y"], want)),
                           **_timing(ms, x.numel() * 4), card=card)
                print(json.dumps(row), flush=True)
                key = f"{path} {gb} GiB"
                if key not in best or row["ms"] < best[key]["ms"]:
                    best[key] = row
        del x, want
        torch.cuda.empty_cache()
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gb", type=float, default=4.0, help="buffer size in GiB")
    ap.add_argument("--sweep", action="store_true",
                    help="walk buffer size, unroll / ring depth and chunk, blocks per SM")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hbm_peak: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.sweep:
        best = sweep(card)
        print(json.dumps(dict(best=best, card=card)))
        return 0
    x = make_buffer(args.gb)
    res = measure(x)
    for path in PATHS:
        if res[path]["max_abs_err"] != 0:
            raise AssertionError(f"B7 {path} differs from the plain version")
    print(json.dumps(dict(res, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
