"""Rotary position embeddings with Llama-3 frequency scaling (PyTorch).

Same math as the JAX package's ``pie_tpu/ops/rope.py``: split-half rotation
(rotate_half, HF Llama weights), cos/sin computed in f32 from positions,
and the fused-QKV epilogue rows of :func:`rope_qkv_cs` that the decode
GEMV kernel applies to its f32 accumulator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RopeScalingConfig:
    rope_type: str = "default"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192

    @classmethod
    def from_dict(cls, d: Optional[dict[str, Any]]) -> "RopeScalingConfig":
        if not d:
            return cls()
        return cls(
            rope_type=d.get("rope_type", d.get("type", "default")),
            factor=float(d.get("factor", 1.0)),
            low_freq_factor=float(d.get("low_freq_factor", 1.0)),
            high_freq_factor=float(d.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                d.get("original_max_position_embeddings", 8192)
            ),
        )


def make_inv_freq(
    head_dim: int,
    base: float = 10000.0,
    scaling: Optional[RopeScalingConfig] = None,
) -> np.ndarray:
    """Inverse frequencies [head_dim // 2] f32 (numpy, host)."""
    inv_freq = 1.0 / (
        base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if scaling is not None and scaling.rope_type in ("llama3",):
        # Llama-3 wavelength-dependent rescale
        orig = scaling.original_max_position_embeddings
        low_wl = orig / scaling.low_freq_factor
        high_wl = orig / scaling.high_freq_factor
        wl = 2 * np.pi / inv_freq
        smooth = (orig / wl - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor
        )
        smoothed = (1 - smooth) * inv_freq / scaling.factor + smooth * inv_freq
        inv_freq = np.where(
            wl > low_wl,
            inv_freq / scaling.factor,
            np.where(wl < high_wl, inv_freq, smoothed),
        )
    return inv_freq.astype(np.float32)


def rope_tables(
    positions: torch.Tensor, inv_freq: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, T, 1, D/2] for ``positions`` [B, T]."""
    freqs = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(freqs)[..., None, :], torch.sin(freqs)[..., None, :]


def apply_rope_tables(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate q or k [B, T, H, D] with precomputed tables."""
    d2 = x.shape[-1] // 2
    x1 = x[..., :d2].to(torch.float32)
    x2 = x[..., d2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_qkv_cs(
    positions: torch.Tensor, inv_freq: torch.Tensor, hq: int, hkv: int,
    dh: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, S) [B, (hq + 2*hkv) * dh] f32 such that
    ``apply_rope_cs(y, C, S, dh)`` rotates the q and k column groups of a
    fused QKV projection and leaves v untouched (C=1, S=0). The
    rotate-half sign lives in S. positions: [B]."""
    b = positions.shape[0]
    freqs = positions[:, None].to(torch.float32) * inv_freq  # [B, dh/2]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    cos_h = torch.cat([cos, cos], dim=-1)
    sin_h = torch.cat([-sin, sin], dim=-1)
    nrot = hq + hkv
    dev = positions.device
    ones = torch.ones((b, hkv * dh), dtype=torch.float32, device=dev)
    zeros = torch.zeros((b, hkv * dh), dtype=torch.float32, device=dev)
    c = torch.cat([cos_h.repeat(1, nrot), ones], dim=-1)
    s = torch.cat([sin_h.repeat(1, nrot), zeros], dim=-1)
    return c, s


def apply_rope_cs(
    y: torch.Tensor, c: torch.Tensor, s: torch.Tensor, dh: int
) -> torch.Tensor:
    """Plain epilogue for :func:`rope_qkv_cs`: ``y*C + roll_half(y)*S`` per
    dh-sized head group, in f32, cast back to y.dtype. y, c, s: [B, N]."""
    half = dh // 2
    yf = y.to(torch.float32)
    lane = torch.arange(y.shape[-1], device=y.device)
    r = torch.where(
        lane % dh < half,
        torch.roll(yf, -half, dims=-1),
        torch.roll(yf, half, dims=-1),
    )
    return (yf * c + r * s).to(y.dtype)
