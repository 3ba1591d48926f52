"""Group-wise affine weight-only quantization (INT4 / INT8) in PyTorch.

Same contract as the JAX package's ``pie_tpu/ops/quant.py``: weights are
stored **[K, N]** (contraction dim leading, ``y = x @ W``), quantization
groups of 32/64/128 run along K, ``w = q * scale + bias`` with unsigned
codes ``q`` in ``[0, 2**bits - 1]``, and K is zero-padded to a multiple of
``PACK_TILE_K`` so shapes match the JAX tensors one for one.

The packing differs on purpose. The JAX package pairs code planes for a
TPU bitcast; the port packs **natural K-major words**: word ``[k // ep, n]``
holds rows ``ep * (k // ep) + i`` at bits ``bits * i``, LSB first
(``ep = 32 // bits``). A warp then reads 32 neighbouring columns of one
word row as 128 contiguous bytes. Words are stored as int32 (torch has few
uint32 ops); the bit pattern is the uint32 one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# K rows covered by one packing tile of the JAX layout; the port keeps the
# same K padding so padded shapes (and the scales' group count) agree.
PACK_TILE_K = 512

SUPPORTED_BITS = (4, 8)
SUPPORTED_GROUPS = (32, 64, 128)


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A group-wise affine quantized matrix in KN layout.

    packed:  int32 [..., Kp // (32//bits), N] — natural K-major words.
    scales:  [..., Kp // group_size, N] — per-(group, out-feature) scale.
    biases:  [..., Kp // group_size, N] — per-(group, out-feature) bias.
    shape:   logical (K, N) before K padding.
    A leading layer axis ([L, ...]) makes a stacked tensor.

    The layout is checked once, here, wherever a tensor is built, sliced or
    moved; the kernel wrappers then only check what a call adds.
    """

    packed: torch.Tensor
    scales: torch.Tensor
    biases: torch.Tensor
    bits: int
    group_size: int
    shape: tuple[int, int]

    def __post_init__(self):
        _check_format(self.bits, self.group_size)
        p, s, b = self.packed, self.scales, self.biases
        k, n = self.shape
        kp = p.shape[-2] * (32 // self.bits) if p.dim() >= 2 else 0
        want_s = tuple(p.shape[:-2]) + (kp // self.group_size, n)
        problems = []
        if p.dtype != torch.int32 or p.dim() not in (2, 3):
            problems.append(f"packed must be int32 [(L,) Kp/ep, N], got "
                            f"{p.dtype} {tuple(p.shape)}")
        elif p.shape[-1] != n or kp < k or kp % PACK_TILE_K:
            problems.append(f"packed {tuple(p.shape)} does not hold K={k} "
                            f"(padded to {PACK_TILE_K}), N={n}")
        if tuple(s.shape) != want_s or tuple(b.shape) != want_s:
            problems.append(f"scales {tuple(s.shape)} / biases {tuple(b.shape)}, "
                            f"want {want_s}")
        if b.dtype != s.dtype or not s.is_floating_point():
            problems.append(f"scales {s.dtype} / biases {b.dtype}")
        if not (p.device == s.device == b.device):
            problems.append(f"on {p.device}, {s.device}, {b.device}")
        if not (p.is_contiguous() and s.is_contiguous() and b.is_contiguous()):
            problems.append("not contiguous")
        if problems:
            raise ValueError("QuantizedTensor: " + "; ".join(problems))

    @property
    def el_per_int(self) -> int:
        return 32 // self.bits

    @property
    def padded_k(self) -> int:
        return self.packed.shape[-2] * self.el_per_int

    @property
    def stacked(self) -> bool:
        return self.packed.dim() == 3

    def layer(self, i: int) -> "QuantizedTensor":
        """Layer ``i`` of a stacked tensor as views (no copy)."""
        return dataclasses.replace(
            self, packed=self.packed[i], scales=self.scales[i],
            biases=self.biases[i],
        )

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(
            self, packed=self.packed.to(device), scales=self.scales.to(device),
            biases=self.biases.to(device),
        )


def _pad_k(w: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-w.shape[-2]) % multiple
    if pad == 0:
        return w
    return torch.nn.functional.pad(w, (0, 0, 0, pad))


def compute_qparams(
    w: torch.Tensor, group_size: int, bits: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``w`` [..., K, N] along K in groups; returns (q, scales,
    biases): q int32 codes in [0, 2**bits - 1], scales/biases [..., K//g, N]
    rounded to ``w.dtype`` (as the JAX package does)."""
    k, n = w.shape[-2], w.shape[-1]
    assert k % group_size == 0, (k, group_size)
    g = group_size
    wf = w.to(torch.float32)
    grp = wf.reshape(*w.shape[:-2], k // g, g, n)
    wmax = grp.amax(dim=-2)
    wmin = grp.amin(dim=-2)
    n_bins = (1 << bits) - 1
    delta = (wmax - wmin) / n_bins
    # degenerate (constant) groups: scale 1, all codes 0, bias reproduces it
    scale = torch.where(delta > 1e-8, delta, torch.ones_like(delta))
    q = torch.clamp(
        torch.round((grp - wmin.unsqueeze(-2)) / scale.unsqueeze(-2)),
        0, n_bins,
    ).to(torch.int32)
    q = q.reshape(*w.shape[:-2], k, n)
    return q, scale.to(w.dtype), wmin.to(w.dtype)


def _to_int32_words(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def pack_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Natural K-major pack of int codes [..., K, N] -> int32 [..., K//ep, N]."""
    ep = 32 // bits
    k, n = q.shape[-2], q.shape[-1]
    assert k % ep == 0, (k, ep)
    qw = q.to(torch.int64).reshape(*q.shape[:-2], k // ep, ep, n)
    word = torch.zeros(qw.shape[:-2] + (n,), dtype=torch.int64, device=q.device)
    for i in range(ep):
        word |= qw[..., i, :] << (bits * i)
    return _to_int32_words(word)


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes` -> int32 codes [..., K, N]."""
    ep = 32 // bits
    mask = (1 << bits) - 1
    kp, n = packed.shape[-2], packed.shape[-1]
    p = packed.to(torch.int64) & 0xFFFFFFFF
    parts = [(p >> (bits * i)) & mask for i in range(ep)]
    q = torch.stack(parts, dim=-2)  # [..., Kp/ep, ep, N]
    return q.reshape(*packed.shape[:-2], kp * ep, n).to(torch.int32)


def _unpack4_planes_np(word: np.ndarray) -> np.ndarray:
    """numpy copy of the JAX package's int4 plane-paired unpack:
    [.., T, 64, N] uint32 -> [.., T, 512, N] codes (plane j covers tile
    rows [128j, 128j+128); word row r holds rows 128j + 2r (bits 4j) and
    128j + 2r + 1 (bits 16 + 4j))."""
    lead = word.shape[:-3]
    t, n = word.shape[-3], word.shape[-1]
    parts = []
    for j in range(4):
        for h in range(2):
            parts.append(((word >> np.uint32(4 * j + 16 * h)) & np.uint32(0xF))
                         .astype(np.int32))
    q = np.stack(parts, axis=-2)  # [.., t, 64, 8, n], index 2j + h
    q = q.reshape(*lead, t, 64, 4, 2, n)  # [.., r, j, h, n]
    q = np.moveaxis(q, -3, -4)  # [.., t, j, r, h, n]
    return q.reshape(*lead, t, PACK_TILE_K, n)


def unpack_tpu_codes_np(packed: np.ndarray, bits: int) -> np.ndarray:
    """Codes [.., K, N] int32 from the JAX package's plane-paired packing
    (own numpy copy of its ``unpack_codes``; used to carry weights over)."""
    packed = np.asarray(packed).astype(np.uint32)
    ep = 32 // bits
    kp, n = packed.shape[-2], packed.shape[-1]
    kpt = PACK_TILE_K // ep
    t = kp // kpt
    lead = packed.shape[:-2]
    word = packed.reshape(*lead, t, kpt, n)
    if bits == 4:
        q = _unpack4_planes_np(word)
    else:  # int8: lo nibble plane rows [0, 64), hi nibble plane [64, 128)
        q = _unpack4_planes_np(word[..., :64, :]) | (
            _unpack4_planes_np(word[..., 64:, :]) << 4
        )
    return q.reshape(*lead, t * PACK_TILE_K, n)


def _check_format(bits: int, group_size: int):
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    if group_size not in SUPPORTED_GROUPS:
        raise ValueError(
            f"group_size must be one of {SUPPORTED_GROUPS}, got {group_size}"
        )


def quantize(
    w: torch.Tensor, group_size: int = 64, bits: int = 4
) -> QuantizedTensor:
    """Quantize ``w`` [K, N] (or stacked [L, K, N]) along K."""
    _check_format(bits, group_size)
    k, n = w.shape[-2], w.shape[-1]
    wp = _pad_k(w, PACK_TILE_K)
    q, scales, biases = compute_qparams(wp, group_size, bits)
    return QuantizedTensor(
        packed=pack_codes(q, bits), scales=scales, biases=biases,
        bits=bits, group_size=group_size, shape=(k, n),
    )


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the full weight [..., K, N] (un-padded): ``q*s + b`` in
    f32, then cast (the JAX package's order)."""
    q = unpack_codes(qt.packed, qt.bits).to(torch.float32)
    g = qt.group_size
    s = qt.scales.to(torch.float32).repeat_interleave(g, dim=-2)
    b = qt.biases.to(torch.float32).repeat_interleave(g, dim=-2)
    w = q * s + b
    return w[..., : qt.shape[0], :].to(dtype)


def from_mlx_layout(
    packed_nk: torch.Tensor,
    scales_nk: torch.Tensor,
    biases_nk: torch.Tensor,
    group_size: int,
    bits: int,
) -> QuantizedTensor:
    """Convert MLX-layout quantized weights ([N, K//ep] packed along K,
    consecutive LSB-first) into the port's KN layout (no re-quantizing)."""
    _check_format(bits, group_size)
    ep = 32 // bits
    mask = (1 << bits) - 1
    n, kp = packed_nk.shape[-2], packed_nk.shape[-1]
    k = kp * ep
    p = packed_nk.to(torch.int64) & 0xFFFFFFFF
    parts = [(p >> (bits * i)) & mask for i in range(ep)]
    q_nk = torch.stack(parts, dim=-1).reshape(*packed_nk.shape[:-1], k)
    q_kn = q_nk.transpose(-1, -2)
    pad = (-k) % PACK_TILE_K
    scales_kn = scales_nk.transpose(-1, -2)
    biases_kn = biases_nk.transpose(-1, -2)
    if pad:
        q_kn = torch.nn.functional.pad(q_kn, (0, 0, 0, pad))
        scales_kn = torch.nn.functional.pad(scales_kn, (0, 0, 0, pad // group_size))
        biases_kn = torch.nn.functional.pad(biases_kn, (0, 0, 0, pad // group_size))
    return QuantizedTensor(
        packed=pack_codes(q_kn, bits),
        scales=scales_kn.contiguous(),
        biases=biases_kn.contiguous(),
        bits=bits, group_size=group_size, shape=(k, n),
    )


def quantized_matmul(
    x: torch.Tensor,
    qt: QuantizedTensor,
    layer: Optional[int] = None,
    rope_cs=None,
    rope_dim: int = 0,
    ln_w: Optional[torch.Tensor] = None,
    ln_eps: float = 0.0,
) -> torch.Tensor:
    """``y = x @ W`` with W group-wise quantized in KN layout; x [..., K].

    Dispatch by where x lies: a CPU tensor takes the plain PyTorch version
    (``quant_matmul_ref``); a CUDA tensor launches the decode GEMV kernel
    (M <= 32) or the prefill GEMM kernel (M > 32), or raises. ``layer``
    selects a layer of stacked weights as a pointer offset; ``rope_cs`` /
    ``rope_dim`` is the fused-QKV rope epilogue and ``ln_w`` / ``ln_eps`` the
    rms-norm prologue, as in the JAX package.
    """
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    if qt.stacked and layer is None:
        raise ValueError("stacked QuantizedTensor needs a layer index")
    if x.device.type == "cpu":
        return qmc.quant_matmul_ref(
            x, qt, layer=layer, rope_cs=rope_cs, rope_dim=rope_dim,
            ln_w=ln_w, ln_eps=ln_eps,
        )
    if x.device.type != "cuda":
        raise ValueError(f"no quantized matmul for device {x.device}")
    return qmc.quant_matmul_cuda(
        x, qt, layer=layer, rope_cs=rope_cs, rope_dim=rope_dim,
        ln_w=ln_w, ln_eps=ln_eps,
    )
