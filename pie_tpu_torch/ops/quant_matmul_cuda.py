"""Fused dequantize + matmul on Hopper: two hand-written CUDA kernels and the
plain PyTorch version beside them.

Replaces the TPU kernel family of ``pie_tpu/ops/quant_matmul_pallas.py``
(``quant_matmul_stacked`` and ``quant_matmul_pallas``: ``_kernel`` ->
``_accum_block``):

- **K1** (``csrc/quant_gemv.cu``, M <= 32, the decode branch): a GEMV that
  streams the packed weights once with the exact affine dequantization,
  an optional rms-norm prologue and an optional rope epilogue. Bound by
  bytes: packed words plus scales and biases over 3.35 TB/s. Its first
  design splits K across the 8 warps of a block (and across blocks where
  N is narrow), stages x in shared memory, and turns codes into floats
  with one shift and one logic op.
- **K2** (``csrc/quant_gemm.cu``, M > 32, the prefill branch): a tiled GEMM
  that dequantizes each 64x128 weight tile to bf16 in shared memory and
  multiplies on the tensor cores with ``wmma``, with the same rope
  epilogue as K1 (the mixed continuous-batching step fuses rope into its
  QKV projection at M = lanes + rider). Bound by operations: 2*M*K*N over
  989 TFLOP/s bf16. Its first design double-buffers the tiles through
  registers; no TMA or ``wgmma`` yet.

``build`` compiles every source under ``csrc/`` (K1, K2, the paged
attention kernel K3 of ``ops/paged_attention.py`` and the fused decode-MLP
kernel K4 of ``ops/fused_mlp.py``) with nvcc for ``sm_90a`` at first use
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

#: kernel launches since the last reset, by kernel name
launch_counts = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

#: K1 splits K across blocks until about this many blocks are in flight
#: (4 per SM of an H100)
GEMV_TARGET_BLOCKS = 4 * 132
_GEMV_TILE_K = 512
_GEMM_TILE_N = 128  # K2's output tile width: a rope head must fit inside it

_libs: dict = {}
_lock = threading.Lock()
_counters: dict = {}  # per device: K1's zeroed arrival counters


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
#: C entry point and argument types of each library
ENTRY_POINTS = {
    "quant_gemv": ("pie_quant_gemv", [_vp] * 10 + [_ci] * 9 + [_cf, _vp]),
    "quant_gemm": ("pie_quant_gemm", [_vp] * 7 + [_ci] * 7 + [_vp]),
    "paged_attention": ("pie_paged_attention",
                        [_vp] * 10 + [_ci] * 9 + [_cf, _ci, _vp]),
    "fused_mlp": ("pie_fused_mlp", [_vp] * 15 + [_ci] * 7 + [_cf, _cll, _vp]),
}


def kernel(name: str):
    """The C entry point of library ``name``, built at first use; each
    returns cudaGetLastError() after its launch."""
    with _lock:
        if name not in _libs:
            symbol, argtypes = ENTRY_POINTS[name]
            fn = getattr(ctypes.CDLL(str(build()[name])), symbol)
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


def gemv_splits(n: int, padded_k: int) -> int:
    """Blocks per 32-column range of K1: split K until the grid has about
    GEMV_TARGET_BLOCKS blocks, each keeping whole 512-row tiles."""
    tiles = padded_k // _GEMV_TILE_K
    want = min(tiles, max(1, -(-GEMV_TARGET_BLOCKS // -(-n // 32))))
    per = -(-tiles // want)
    return -(-tiles // per)


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
    x [M, K] bf16 CUDA; returns [M, N] bf16."""
    xm = _x_padded(x, qt)
    m, n = xm.shape[0], qt.shape[1]
    if not 1 <= m <= DECODE_MAX_M:
        raise ValueError(f"K1 takes 1..{DECODE_MAX_M} rows, got {m}")
    _check(xm, "x", torch.bfloat16)
    wp, sp, bp = _weight_ptrs(qt, layer, xm.device)
    lw = _ln_ptr(ln_w, layer, qt)
    cos, sin = _rope_tables(rope_cs, rope_dim, m, n)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=xm.device)
    splits = gemv_splits(n, qt.padded_k)
    ws = counters = None
    if splits > 1:
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=xm.device)
        counters = _counters.get(xm.device)
        if counters is None:
            counters = torch.zeros(4096, dtype=torch.int32, device=xm.device)
            _counters[xm.device] = counters
    err = kernel("quant_gemv")(
        xm.data_ptr(), wp, sp, bp, lw, _ptr(cos), _ptr(sin), y.data_ptr(),
        _ptr(ws), _ptr(counters), splits,
        m, qt.shape[0], qt.padded_k, n, qt.bits, qt.group_size, _f32_scales(qt),
        int(rope_dim), float(ln_eps), torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"K1 (quant_gemv) launch failed: CUDA error {err}")
    launch_counts["K1"] += 1
    return y


def quant_gemm(x, qt, layer=None, rope_cs=None, rope_dim=0) -> torch.Tensor:
    """K2: ``y = x @ bf16(dequant(W[layer]))`` (+ rope, with K1's head
    pairing), M > 32. x [M, K] bf16 CUDA; returns [M, N] bf16."""
    xm = _x_padded(x, qt)
    m, n = xm.shape[0], qt.shape[1]
    _check(xm, "x", torch.bfloat16)
    wp, sp, bp = _weight_ptrs(qt, layer, xm.device)
    cos, sin = _rope_tables(rope_cs, rope_dim, m, n)
    if rope_dim and _GEMM_TILE_N % rope_dim:
        raise ValueError(f"K2's rope epilogue needs dh | {_GEMM_TILE_N}, got {rope_dim}")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=xm.device)
    err = kernel("quant_gemm")(
        xm.data_ptr(), wp, sp, bp, _ptr(cos), _ptr(sin), y.data_ptr(),
        m, qt.padded_k, n, qt.bits, qt.group_size, _f32_scales(qt), int(rope_dim),
        torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"K2 (quant_gemm) launch failed: CUDA error {err}")
    launch_counts["K2"] += 1
    return y


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
