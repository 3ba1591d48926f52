"""Fused dequantize + matmul on Hopper: two hand-written CUDA kernels and the
plain PyTorch version beside them.

Replaces the TPU kernel family of ``pie_tpu/ops/quant_matmul_pallas.py``
(``quant_matmul_stacked`` and ``quant_matmul_pallas``: ``_kernel`` ->
``_accum_block``):

- **K1** (``csrc/quant_gemv.cu``, M <= 32, the decode branch): a GEMV on
  the tensor cores in the transposed form y^T = W^T x^T (``mma.sync``
  m16n8k16, the exact codes as the A operand, each group's f32 partial
  scaled and offset after the product, as the decode branch does), fed by
  a TMA ring of packed words, scale and bias rows and x, with an optional
  rms-norm prologue (a rows-only pre-pass launched by the same call) and
  an optional rope epilogue. Bound by bytes: packed words plus scales and
  biases over 3.35 TB/s. Where the 128-feature tiles do not fill the card,
  K is split across blocks (``gemv_plan``).
- **K2** (``csrc/quant_gemm.cu``, M > 32, the prefill branch): a Hopper
  GEMM in the transposed form y^T = W^T x^T. A producer thread keeps a
  ring of shared-memory stages filled with TMA copies (x tiles, packed
  words, scale and bias rows) behind ``mbarrier``s; two consumer
  warpgroups dequantize their 64 features' weights straight into
  ``wgmma``'s register A operand for the next step while the tensor cores
  run the current one on 256 tokens of x, then apply the same rope
  epilogue as K1 (the mixed continuous-batching step fuses rope into its
  QKV projection at M = lanes + rider). Where the output tiles fill at
  most half of the SMs, K is split across blocks and the last block of a
  tile sums the partials (``gemm_plan``). Bound by operations from M ~ 300
  up (2*M*K*N over 989 TFLOP/s bf16), by bytes below.

``build`` compiles every source under ``csrc/`` (K1, K2, the paged
attention kernel K3 of ``ops/paged_attention.py``, the fused decode-MLP
kernel K4 of ``ops/fused_mlp.py``, the paged prefill attention K5 of
``ops/prefill_attention.py`` and the read probe B7 of
``tools/hbm_peak.py``) with nvcc for ``sm_90a`` at first use
into ``build/pie_tpu_torch/<hash of the sources and headers>/``;
``kernel`` binds a library's C entry point through ctypes.
A wrapper checks device, dtype, shape and contiguity (the weights' layout
is checked once, where their ``QuantizedTensor`` is built), allocates the
output with ``torch.empty``, launches on the current stream, raises if the
C entry point reports a CUDA error, and adds one to its launch counter.

``quant_matmul_ref`` is the plain version: exactly what the JAX package's
XLA path computes (``pie_tpu/ops/quant.py`` ``quantized_matmul``,
impl="xla"). The CPU path and the kernel checks use it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

from pie_tpu_torch.ops.quant import QuantizedTensor, dequantize

#: the decode/prefill threshold of the TPU kernel (M <= 32 is decode)
DECODE_MAX_M = 32

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pie_tpu_torch"
#: every kernel source under csrc/, by library name
SOURCES = {p.stem: p.name for p in sorted(CSRC.glob("*.cu"))}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: kernel launches since the last reset, by kernel name ("K1 ln": K1's
#: rms-norm pre-pass, one per K1 call with the prologue)
launch_counts = {"K1": 0, "K1 ln": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}

#: K1's block tile: 128 output features (8 warps of 16; a rope head must
#: fit inside it), 128-row K stages in the TMA ring
GEMV_TILE_N, GEMV_STAGE_K = 128, 128
#: K1's blocks resident per SM (its shared-memory ring holds two): the
#: most blocks per SM a K split makes
GEMV_BLOCKS_PER_SM = 2
#: K2's block tile: 256 rows of x (tokens, wgmma's N), 128 output columns
#: (features: two wgmma warpgroups of 64; a rope head must fit inside
#: them), 64-row K steps
GEMM_TILE_M, GEMM_TILE_N, GEMM_TILE_K = 256, 128, 64
#: the most K ranges K2 splits one output tile into
GEMM_MAX_SPLITS = 16
#: gemm_plan's cost model, in 64-row K steps of one block: a block's fixed
#: cost (pipeline fill, epilogue), and writing or reading one 128-row f32
#: partial (set against K2's times at 1, 2, 4 and 8 splits on the H100,
#: pie_tpu_torch/tools/k2_breakdown.py --splits)
_GEMM_BLOCK_OVERHEAD, _GEMM_PARTIAL_COST = 3, 1.2
#: SMs of an H100 SXM; gemm_plan's default
H100_SMS = 132

_libs: dict = {}
_lock = threading.Lock()
_counters: dict = {}  # per (device, kernel): zeroed arrival counters
_sms: dict = {}  # per device: SM count


def reset_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    """Build directory keyed by a hash of the flags, the sources and the
    headers they include (``csrc/*.cuh``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(verbose: bool = False) -> dict[str, Path]:
    """Compile every kernel source into its own shared library, all nvcc
    processes started together; reuse libraries already built from the
    same sources. Returns {name: path}."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: out / f"lib{name}.so" for name in SOURCES}
    procs = []
    for name, src in SOURCES.items():
        if paths[name].exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for name, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc {SOURCES[name]} failed:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


_vp, _ci, _cf, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: C entry points (library, symbol, argument types), all returning int
ENTRY_POINTS = {
    "quant_gemv": ("quant_gemv", "pie_quant_gemv", [_vp] * 11 + [_ci] * 10 + [_cf, _vp]),
    "gemv_ln_rows": ("quant_gemv", "pie_gemv_ln_rows", [_vp] * 3 + [_ci] * 3 + [_cf, _vp]),
    "quant_gemm": ("quant_gemm", "pie_quant_gemm", [_vp] * 9 + [_ci] * 9 + [_vp]),
    "quant_gemm_encode_ns": ("quant_gemm", "pie_quant_gemm_encode_ns",
                             [_vp] * 4 + [_ci] * 7),
    "paged_attention": ("paged_attention", "pie_paged_attention",
                        [_vp] * 10 + [_ci] * 9 + [_cf, _ci, _vp]),
    "paged_attention_geometry": ("paged_attention", "pie_paged_attention_geometry",
                                 [_ci] * 3 + [_vp]),
    "fused_mlp": ("fused_mlp", "pie_fused_mlp", [_vp] * 9 + [_ci] * 16 + [_cf, _cll, _vp]),
    "fused_mlp_encode": ("fused_mlp", "pie_fused_mlp_encode",
                         [_vp] * 3 + [_ci, _cll, _cll] + [_ci] * 5 + [_vp]),
    "fused_mlp_blocks_per_sm": ("fused_mlp", "pie_fused_mlp_blocks_per_sm", [_ci] * 4),
    "prefill_attention": ("paged_prefill_attention", "pie_prefill_attention",
                          [_vp] * 11 + [_cll] * 2 + [_ci] * 8 + [_cf, _vp]),
    "prefill_attention_geometry": ("paged_prefill_attention",
                                   "pie_prefill_attention_geometry", [_vp]),
    "hbm_read": ("hbm_read", "pie_hbm_read", [_vp] * 3 + [_cll] + [_ci] * 6 + [_vp]),
    "hbm_read_blocks_per_sm": ("hbm_read", "pie_hbm_read_blocks_per_sm", [_ci] * 4 + [_vp]),
}


def kernel(name: str):
    """The C entry point ``name``, its library built at first use; each
    kernel entry returns cudaGetLastError() after its launch."""
    with _lock:
        if name not in _libs:
            lib, symbol, argtypes = ENTRY_POINTS[name]
            fn = getattr(ctypes.CDLL(str(build()[lib])), symbol)
            fn.argtypes = argtypes
            fn.restype = _ci
            _libs[name] = fn
        return _libs[name]


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _layer_view(qt: QuantizedTensor, layer) -> QuantizedTensor:
    return qt.layer(int(layer)) if qt.stacked else qt


def _ln_row(ln_w, layer, stacked: bool):
    if ln_w is None:
        return None
    return ln_w[int(layer)] if stacked and ln_w.dim() == 2 else ln_w.reshape(-1)


def quant_matmul_ref(
    x: torch.Tensor,
    qt: QuantizedTensor,
    layer=None,
    rope_cs=None,
    rope_dim: int = 0,
    ln_w: Optional[torch.Tensor] = None,
    ln_eps: float = 0.0,
) -> torch.Tensor:
    """Plain version of K1/K2: normalize in f32 and cast to x's dtype (when
    ``ln_w``), dequantize to bf16, dot with f32 accumulation, cast to
    ``x.dtype``, then the rope epilogue in f32 (when ``rope_dim``)."""
    from pie_tpu_torch.ops.rope import apply_rope_cs

    batch_shape = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    lw = _ln_row(ln_w, layer, qt.stacked)
    if lw is not None:
        xf = xm.to(torch.float32)
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + ln_eps)
        xm = (xf * inv * lw.to(torch.float32)).to(xm.dtype)
    w = dequantize(_layer_view(qt, layer), dtype=torch.bfloat16)
    # bf16 x bf16 products are exact in f32: widening then an f32 matmul is
    # a bf16 dot with f32 accumulation
    y = torch.matmul(
        xm.to(torch.bfloat16).to(torch.float32), w.to(torch.float32)
    ).to(x.dtype)
    if rope_dim:
        y = apply_rope_cs(y, rope_cs[0], rope_cs[1], rope_dim)
    return y.reshape(*batch_shape, qt.shape[1])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _weight_ptrs(qt: QuantizedTensor, layer, device) -> tuple[int, int, int]:
    """Device pointers of layer ``layer``'s packed words, scales and biases:
    offsets into the stacked arrays (no copy). QuantizedTensor checked the
    layout where it was built; a call checks what the kernel adds to it."""
    if qt.packed.device != device:
        raise ValueError(f"weights on {qt.packed.device}, x on {device}")
    if qt.scales.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scales and biases must be bfloat16 or float32, got "
                         f"{qt.scales.dtype}")
    i = int(layer) if qt.stacked else 0
    if qt.stacked and not 0 <= i < qt.packed.shape[0]:
        raise IndexError(f"layer {i} of {qt.packed.shape[0]}")
    ptrs = tuple(t.data_ptr() + i * t.stride(0) * t.element_size() if qt.stacked
                 else t.data_ptr() for t in (qt.packed, qt.scales, qt.biases))
    if any(p % 16 for p in ptrs):
        raise ValueError("weights must be 16-byte aligned")
    return ptrs


def _f32_scales(qt: QuantizedTensor) -> int:
    """1 where the scales and biases are f32 (a tied head quantized from the
    f32 transpose of the embedding, as the JAX package keeps it), else 0
    (bf16)."""
    return int(qt.scales.dtype == torch.float32)


def _ln_ptr(ln_w, layer, qt: QuantizedTensor) -> Optional[int]:
    """Device pointer of the ln weight row for ``layer``."""
    if ln_w is None:
        return None
    row = qt.stacked and ln_w.dim() == 2
    k = qt.shape[0]
    _check(ln_w, "ln_w", torch.bfloat16, (ln_w.shape[0], k) if row else (k,))
    if not row:
        return ln_w.data_ptr()
    i = int(layer)
    if not 0 <= i < ln_w.shape[0]:
        raise IndexError(f"ln_w row {i} of {ln_w.shape[0]}")
    ptr = ln_w.data_ptr() + i * ln_w.stride(0) * ln_w.element_size()
    if ptr % 16:
        raise ValueError("ln_w rows must be 16-byte aligned")
    return ptr


def _x_padded(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    xm = x.reshape(-1, x.shape[-1])
    if xm.shape[-1] != qt.shape[0]:
        raise ValueError(f"x has K={xm.shape[-1]}, weights K={qt.shape[0]}")
    if qt.padded_k != qt.shape[0]:
        xm = torch.nn.functional.pad(xm, (0, qt.padded_k - qt.shape[0]))
    return xm.contiguous()


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """K1's launch for one call: a grid of (n_tiles, splits) blocks, each
    128 output features over ``stages_per_split`` 128-row K stages; with
    ``splits > 1`` an f32 workspace of ``workspace_elems`` values
    ([splits, M, N]) holds the partial sums."""

    m: int
    n: int
    n_tiles: int
    stages: int
    splits: int
    stages_per_split: int

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.splits

    @property
    def workspace_elems(self) -> int:
        return self.splits * self.m * self.n if self.splits > 1 else 0


@functools.lru_cache(maxsize=4096)
def gemv_plan(m: int, n: int, padded_k: int, group_size: int, rope_dim: int = 0,
              sms: int = H100_SMS) -> GemvPlan:
    """K1's tiles and K splits for y[m, n] = x[m, padded_k] @ W, m <= 32.

    128-feature tiles cover the output. Where they do not fill the SMs, K
    is split into ranges of whole 128-row stages (each a whole number of
    groups), as many as keep the grid to one wave of GEMV_BLOCKS_PER_SM
    blocks per SM (a second, partial wave costs more than the split gains,
    and so does splitting a grid that already covers every SM: both
    measured on the H100, pie_tpu_torch/tools/k1_breakdown.py --splits).
    Raises ValueError for shapes K1 does not take (M outside 1..32, N not a
    multiple of 8, g not in 32/64/128, a rope head that does not divide
    the tile or N)."""
    if not 1 <= m <= DECODE_MAX_M:
        raise ValueError(f"K1 takes 1..{DECODE_MAX_M} rows, got {m}")
    if n < 8 or n % 8:
        raise ValueError(f"K1 needs N a positive multiple of 8 (TMA's 16-byte rows), "
                         f"got N={n}")
    if (group_size not in (32, 64, 128) or padded_k % GEMV_STAGE_K
            or padded_k < GEMV_STAGE_K):
        raise ValueError(f"K1 needs g in (32, 64, 128) and K a multiple of "
                         f"{GEMV_STAGE_K}, got g={group_size}, K={padded_k}")
    if rope_dim and (rope_dim % 32 or GEMV_TILE_N % rope_dim or n % rope_dim):
        raise ValueError(f"K1's rope epilogue needs 32 | dh, dh | {GEMV_TILE_N} and "
                         f"dh | N, got dh={rope_dim}, N={n}")
    n_tiles = -(-n // GEMV_TILE_N)
    stages = padded_k // GEMV_STAGE_K
    want = 1 if n_tiles >= sms else max(1, min(stages, GEMV_BLOCKS_PER_SM * sms // n_tiles))
    per = -(-stages // want)
    return GemvPlan(m=m, n=n, n_tiles=n_tiles, stages=stages, splits=-(-stages // per),
                    stages_per_split=per)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """K2's launch for one call: a grid of (m_tiles, n_tiles, splits)
    blocks, each 256 x 128 outputs over ``steps_per_split`` 64-row K steps;
    with ``splits > 1`` an f32 workspace of ``workspace_elems`` values
    ([splits, M, N]) holds the partial sums."""

    m: int
    n: int
    m_tiles: int
    n_tiles: int
    steps: int
    splits: int
    steps_per_split: int

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def workspace_elems(self) -> int:
        return self.splits * self.m * self.n if self.splits > 1 else 0


@functools.lru_cache(maxsize=4096)
def gemm_plan(m: int, n: int, padded_k: int, group_size: int, rope_dim: int = 0,
              sms: int = H100_SMS) -> GemmPlan:
    """K2's tiles and K splits for y[m, n] = x[m, padded_k] @ W.

    Output tiles of 256 x 128 cover the output. Where they fill at most
    half of the card's SMs, K is split on group boundaries (whole
    ``max(64, g)``-row units) into ranges that run in one wave (``tiles *
    splits <= sms``): the split of least estimated time, steps per block
    plus a block's fixed cost, writing its partial and the last block's
    sum over the others. A card more than half full is not split: K2 is
    then bound by what the SMs share (L2 and HBM), so a fuller grid gains
    little and the partials cost more. Raises ValueError for shapes K2
    does not take (N not a multiple of 8, a rope head that does not divide
    the tile)."""
    if m < 1 or n < 8 or n % 8:
        raise ValueError(f"K2 needs M >= 1 and N a positive multiple of 8 (TMA's "
                         f"16-byte rows), got M={m}, N={n}")
    if group_size not in (32, 64, 128) or padded_k % GEMM_TILE_K or padded_k < GEMM_TILE_K:
        raise ValueError(f"K2 needs g in (32, 64, 128) and K a multiple of "
                         f"{GEMM_TILE_K}, got g={group_size}, K={padded_k}")
    if rope_dim and (rope_dim % 32 or GEMM_TILE_N % rope_dim or n % rope_dim):
        raise ValueError(f"K2's rope epilogue needs 32 | dh, dh | {GEMM_TILE_N} and "
                         f"dh | N, got dh={rope_dim}, N={n}")
    m_tiles, n_tiles = -(-m // GEMM_TILE_M), -(-n // GEMM_TILE_N)
    steps = padded_k // GEMM_TILE_K
    unit = max(GEMM_TILE_K, group_size) // GEMM_TILE_K  # steps per split unit
    units = steps // unit
    tiles = m_tiles * n_tiles
    best = (steps, 1)  # (steps per split, splits)
    if 2 * tiles <= sms:
        partial = _GEMM_PARTIAL_COST * min(m, GEMM_TILE_M) / GEMM_TILE_M
        cost = None
        for want in range(1, min(units, GEMM_MAX_SPLITS, sms // tiles) + 1):
            per = -(-units // want) * unit
            splits = -(-steps // per)
            if splits != want:
                continue  # the same split as a smaller `want`
            c = per + _GEMM_BLOCK_OVERHEAD
            if splits > 1:  # each block writes its partial; the last reads the others
                c += splits * partial
            if cost is None or c < cost:
                cost, best = c, (per, splits)
    return GemmPlan(m=m, n=n, m_tiles=m_tiles, n_tiles=n_tiles, steps=steps,
                    splits=best[1], steps_per_split=best[0])


def _arrival_counters(device, kernel_name: str) -> torch.Tensor:
    """A kernel's zeroed arrival counters on ``device`` (each split tile's
    last block resets its own)."""
    key = (device, kernel_name)
    if key not in _counters:
        _counters[key] = torch.zeros(4096, dtype=torch.int32, device=device)
    return _counters[key]


def _device_sms(device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


def _rope_tables(rope_cs, rope_dim: int, m: int, n: int):
    """Checked (cos, sin) [M, N] f32 of the rope epilogue, or (None, None).
    Both kernels pair a head's first-half columns with their partners dh/2
    further on inside one block, so they need 32 | dh and dh | N."""
    if not rope_dim:
        return None, None
    if rope_dim % 32 or n % rope_dim:
        raise ValueError(f"rope epilogue needs 32 | dh and dh | N ({rope_dim}, {n})")
    cos, sin = rope_cs
    _check(cos, "cos", torch.float32, (m, n))
    _check(sin, "sin", torch.float32, (m, n))
    return cos, sin


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def quant_gemv(x, qt, layer=None, rope_cs=None, rope_dim=0, ln_w=None,
               ln_eps=0.0) -> torch.Tensor:
    """K1: ``y = [rms_norm(x)*ln_w] @ dequant(W[layer])`` (+ rope), M <= 32.
    x [M, K] bf16 CUDA; returns [M, N] bf16. N must be a multiple of 8 and
    a rope head must divide 128 (ValueError otherwise)."""
    xm = _x_padded(x, qt)
    m, n = xm.shape[0], qt.shape[1]
    sms = _device_sms(xm.device) if xm.device.type == "cuda" else H100_SMS
    plan = gemv_plan(m, n, qt.padded_k, qt.group_size, rope_dim, sms=sms)
    _check(xm, "x", torch.bfloat16)
    wp, sp, bp = _weight_ptrs(qt, layer, xm.device)
    lw = _ln_ptr(ln_w, layer, qt)
    cos, sin = _rope_tables(rope_cs, rope_dim, m, n)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=xm.device)
    xn = torch.empty_like(xm) if lw is not None else None
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, m, n), dtype=torch.float32, device=xm.device)
        counters = _arrival_counters(xm.device, "K1")
    err = kernel("quant_gemv")(
        xm.data_ptr(), _ptr(xn), wp, sp, bp, lw, _ptr(cos), _ptr(sin), y.data_ptr(),
        _ptr(ws), _ptr(counters), plan.splits, plan.stages_per_split,
        m, qt.shape[0], qt.padded_k, n, qt.bits, qt.group_size, _f32_scales(qt),
        int(rope_dim), float(ln_eps), torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"K1 (quant_gemv) launch failed: CUDA error {err}")
    launch_counts["K1"] += 1
    if lw is not None:
        launch_counts["K1 ln"] += 1
    return y


def gemv_ln_rows(x, qt, layer=None, ln_w=None, ln_eps=0.0) -> torch.Tensor:
    """K1's prologue alone, as ``quant_gemv`` launches it before the GEMV:
    ``bf16(rms_norm(x) * ln_w)`` over the logical K, zero-padded to
    ``qt.padded_k``. x [M, K] bf16 CUDA; returns [M, Kp] bf16."""
    xm = _x_padded(x, qt)
    _check(xm, "x", torch.bfloat16)
    lw = _ln_ptr(ln_w, layer, qt)
    if lw is None:
        raise ValueError("gemv_ln_rows needs ln_w")
    xn = torch.empty_like(xm)
    err = kernel("gemv_ln_rows")(
        xm.data_ptr(), lw, xn.data_ptr(), xm.shape[0], qt.shape[0], qt.padded_k,
        float(ln_eps), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1's ln pre-pass launch failed: CUDA error {err}")
    launch_counts["K1 ln"] += 1
    return xn


def quant_gemm(x, qt, layer=None, rope_cs=None, rope_dim=0) -> torch.Tensor:
    """K2: ``y = x @ bf16(dequant(W[layer]))`` (+ rope, with K1's head
    pairing), M > 32. x [M, K] bf16 CUDA; returns [M, N] bf16. N must be a
    multiple of 8 and a rope head must divide 128 (ValueError otherwise)."""
    m, n = x.numel() // x.shape[-1], qt.shape[1]
    sms = _device_sms(x.device) if x.device.type == "cuda" else H100_SMS
    plan = gemm_plan(m, n, qt.padded_k, qt.group_size, rope_dim, sms=sms)
    xm = _x_padded(x, qt)
    _check(xm, "x", torch.bfloat16)
    wp, sp, bp = _weight_ptrs(qt, layer, xm.device)
    cos, sin = _rope_tables(rope_cs, rope_dim, m, n)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=xm.device)
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, m, n), dtype=torch.float32, device=xm.device)
        counters = _arrival_counters(xm.device, "K2")
    err = kernel("quant_gemm")(
        xm.data_ptr(), wp, sp, bp, _ptr(cos), _ptr(sin), y.data_ptr(), _ptr(ws),
        _ptr(counters), plan.splits, plan.steps_per_split,
        m, qt.padded_k, n, qt.bits, qt.group_size, _f32_scales(qt), int(rope_dim),
        torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"K2 (quant_gemm) launch failed: CUDA error {err}")
    launch_counts["K2"] += 1
    return y


def gemm_encode_ns(x, qt, layer=None, reps: int = 1000) -> int:
    """Mean host nanoseconds K2 spends encoding the four TMA tensor maps of
    a call like ``quant_gemm(x, qt, layer)`` (x [M, K] bf16 CUDA)."""
    xm = _x_padded(x, qt)
    _check(xm, "x", torch.bfloat16)
    wp, sp, bp = _weight_ptrs(qt, layer, xm.device)
    ns = kernel("quant_gemm_encode_ns")(
        xm.data_ptr(), wp, sp, bp, xm.shape[0], qt.padded_k, qt.shape[1], qt.bits,
        qt.group_size, _f32_scales(qt), int(reps))
    if ns < 0:
        raise RuntimeError("K2's tensor maps did not encode")
    return ns


def quant_matmul_cuda(x, qt, layer=None, rope_cs=None, rope_dim=0, ln_w=None,
                      ln_eps=0.0) -> torch.Tensor:
    """Route a CUDA matmul to K1 (M <= 32) or K2 (M > 32); x [..., K]. The
    rope epilogue runs at any M; the ln prologue is decode-only (K1)."""
    batch_shape = x.shape[:-1]
    m = x.numel() // x.shape[-1]
    if m <= DECODE_MAX_M:
        y = quant_gemv(x, qt, layer=layer, rope_cs=rope_cs,
                       rope_dim=rope_dim, ln_w=ln_w, ln_eps=ln_eps)
    else:
        if ln_w is not None:
            raise ValueError("the ln prologue is decode-only (M <= 32)")
        y = quant_gemm(x, qt, layer=layer, rope_cs=rope_cs, rope_dim=rope_dim)
    return y.reshape(*batch_shape, qt.shape[1])
