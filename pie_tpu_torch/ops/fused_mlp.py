"""The decode MLP block in one launch: a hand-written CUDA kernel (K4) and
the plain PyTorch version beside it.

Replaces the TPU kernel ``pie_tpu/ops/fused_mlp_pallas.py``
``fused_mlp_stacked``: ``h2 = h + attn @ wo``, ``x = rms_norm(h2) * ln2``,
``g, u = x @ wgu``, ``out = h2 + (silu(g) * u) @ wd`` for M <= 8 rows and
group-wise quantized weights stacked over layers.

- ``fused_mlp_supported`` is a copy of the JAX package's gate, tile
  divisibility terms included, so the port takes the fused path exactly
  where the reference does.
- ``fused_mlp_ref`` is the plain version, with the reference kernel's
  rounding points: the residual adds in bf16, the norm statistic in f32,
  bf16 ``gu`` and ``act``; each dot is the port's ``quant_matmul_ref``.
- ``fused_mlp_cuda`` launches K4 (``csrc/fused_mlp.cu``): one cooperative
  launch per call, three weight-streaming GEMV phases with grid-wide
  barriers between them. Bound by bytes: one layer's packed words plus
  scales and biases of wo, wgu and wd over 3.35 TB/s.
- ``fused_mlp_stacked`` routes: a CPU tensor to the plain version, a CUDA
  tensor to K4, which launches or raises.
"""

from __future__ import annotations

import threading

import torch

from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.ops.quant import QuantizedTensor

# the JAX kernel's tiles, which its gate asks the dims to divide into
BN = 2048
BK_O = 1024   # wo K tile
BK_G = 2048   # wgu / wd K tile
#: rows K4 takes (the decode batch of the reference's gate)
MAX_M = 8
#: K rows of one weight tile of K4's GEMV phases (kTileK, csrc/quant_tile.cuh)
TILE_K = 512

_lock = threading.Lock()
_workspaces: dict = {}  # per device: K4's scratch (partial sums, h2, act)
_barriers: dict = {}  # per device: K4's grid-barrier words, zero between calls


def fused_mlp_supported(qt_wo, qt_wgu, qt_wd, m: int) -> bool:
    """Static gate: decode-sized batch, tile-divisible dims, stacked
    weights with a shared group size (the JAX package's rule)."""
    try:
        d_attn, d = qt_wo.shape
        d2, di2 = qt_wgu.shape
        di, d3 = qt_wd.shape
        stacked = qt_wo.packed.dim() == 3
    except (AttributeError, TypeError, ValueError):
        return False
    return (
        m <= MAX_M
        and stacked
        and d == d2 == d3
        and di2 == 2 * di
        and d % BN == 0 and di2 % BN == 0 and di % BK_G == 0
        and d_attn % BK_O == 0 and d % BK_G == 0
        and qt_wo.padded_k == d_attn and qt_wgu.padded_k == d
        and qt_wd.padded_k == di
        and qt_wo.group_size == qt_wgu.group_size == qt_wd.group_size
        and qt_wo.bits == qt_wgu.bits == qt_wd.bits
        and qt_wo.group_size <= BK_O
    )


def fused_mlp_ref(attn, h_in, ln2_w, layer, wo: QuantizedTensor,
                  wgu: QuantizedTensor, wd: QuantizedTensor, eps: float = 1e-5):
    """Plain version of K4; attn [M, d_attn], h_in [M, d], ln2_w [d] or
    [L, d] -> [M, d] in h_in's dtype. ``quant_matmul_ref`` of an f32 input
    that holds bf16 values returns its f32 accumulation unrounded."""
    bf, f32 = torch.bfloat16, torch.float32
    dot = lambda x, qt: qmc.quant_matmul_ref(x.to(bf).to(f32), qt, layer=layer)
    h2 = (h_in.to(f32) + dot(attn, wo).to(bf).to(f32)).to(bf)
    hf = h2.to(f32)
    inv = torch.rsqrt((hf * hf).sum(-1, keepdim=True) / hf.shape[-1] + eps)
    xg = (hf * inv * qmc._ln_row(ln2_w, layer, True).to(f32)).to(bf)
    gu = dot(xg, wgu).to(bf).to(f32)
    di = gu.shape[-1] // 2
    g, u = gu[..., :di], gu[..., di:]
    act = (g * torch.sigmoid(g) * u).to(bf)
    return h2.to(h_in.dtype) + dot(act, wd).to(h_in.dtype)


def workspace_bytes(m: int, d_attn: int, d: int, di: int) -> int:
    """K4's scratch: f32 partial sums of every K split of the three
    phases, then h2 [M, d] and act [M, di] in bf16 (csrc/fused_mlp.cu)."""
    t = TILE_K
    parts = d_attn // t * d + d // t * 2 * di + di // t * d
    return 4 * m * parts + 2 * m * (d + di)


def _scratch(device: torch.device, nbytes: int):
    """The device's K4 workspace (grown as needed) and barrier words: kept
    between calls, which run one at a time on the current stream."""
    with _lock:
        ws = _workspaces.get(device)
        if ws is None or ws.numel() < nbytes:
            ws = torch.empty(nbytes, dtype=torch.uint8, device=device)
            _workspaces[device] = ws
        bar = _barriers.get(device)
        if bar is None:
            bar = torch.zeros(2, dtype=torch.int32, device=device)
            _barriers[device] = bar
        return ws, bar


def fused_mlp_cuda(attn, h_in, ln2_w, layer, wo: QuantizedTensor,
                   wgu: QuantizedTensor, wd: QuantizedTensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """K4: one launch of the decode MLP block; attn [M, d_attn] and h_in
    [M, d] bf16 CUDA, M <= 8; stacked weights of one format; returns
    [M, d] bf16. The layer is a pointer offset into the weights and into
    ``ln2_w`` ([d] row or [L, d] table)."""
    if attn.dim() != 2 or h_in.dim() != 2:
        raise ValueError(f"attn and h_in must be [M, *], got {tuple(attn.shape)}, "
                         f"{tuple(h_in.shape)}")
    m, d_attn = attn.shape
    d = h_in.shape[1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"K4 takes 1..{MAX_M} rows, got {m}")
    for name, qt in (("wo", wo), ("wgu", wgu), ("wd", wd)):
        if not isinstance(qt, QuantizedTensor) or not qt.stacked:
            raise ValueError(f"K4 needs stacked quantized {name}")
        if qt.padded_k != qt.shape[0] or qt.shape[0] % TILE_K:
            raise ValueError(f"{name}: K = {qt.shape[0]} must be a multiple of "
                             f"{TILE_K} with no padding")
    if not (wo.bits == wgu.bits == wd.bits
            and wo.group_size == wgu.group_size == wd.group_size):
        raise ValueError("K4 needs one bit width and one group size for wo, wgu, wd")
    if not wo.scales.dtype == wgu.scales.dtype == wd.scales.dtype:
        raise ValueError("K4 needs one scale dtype for wo, wgu, wd")
    di = wd.shape[0]
    if (wo.shape != (d_attn, d) or wgu.shape != (d, 2 * di)
            or wd.shape != (di, d)):
        raise ValueError(f"shapes wo {wo.shape}, wgu {wgu.shape}, wd {wd.shape} "
                         f"do not chain from attn [{m}, {d_attn}], h [{m}, {d}]")
    qmc._check(attn, "attn", torch.bfloat16)
    qmc._check(h_in, "h_in", torch.bfloat16, (m, d))
    dev = attn.device
    ptrs = [p for qt in (wo, wgu, wd) for p in qmc._weight_ptrs(qt, layer, dev)]
    lw = qmc._ln_ptr(ln2_w, layer, wgu)
    out = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    nbytes = workspace_bytes(m, d_attn, d, di)
    ws, bar = _scratch(dev, nbytes)
    err = qmc.kernel("fused_mlp")(
        attn.data_ptr(), h_in.data_ptr(), lw, *ptrs, out.data_ptr(),
        ws.data_ptr(), bar.data_ptr(), m, d_attn, d, di, wo.bits, wo.group_size,
        qmc._f32_scales(wo), float(eps), ws.numel(),
        torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"K4 (fused_mlp) launch failed: CUDA error {err}")
    qmc.launch_counts["K4"] += 1
    return out


def fused_mlp_stacked(attn, h_in, ln2_w, layer, wo: QuantizedTensor,
                      wgu: QuantizedTensor, wd: QuantizedTensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """The decode MLP block of layer ``layer`` (the JAX package's argument
    order): the plain version for CPU tensors, K4 for CUDA tensors."""
    if attn.device.type == "cpu":
        return fused_mlp_ref(attn, h_in, ln2_w, layer, wo, wgu, wd, eps)
    if attn.device.type != "cuda":
        raise ValueError(f"no fused MLP block for device {attn.device}")
    return fused_mlp_cuda(attn, h_in, ln2_w, layer, wo, wgu, wd, eps)
