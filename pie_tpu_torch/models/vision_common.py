"""Ops the vision towers share (Qwen2-VL's ViT and Gemma-3's SigLIP): a
product in the promoted dtype, LayerNorm, the host-array conversion the
checkpoint loaders use, and the scatter of projected image rows over a
prompt's placeholders."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def matmul_promoted(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w + b`` in the promoted dtype of x and w (JAX's promotion:
    bf16 weights on f32 pixels compute in f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(dt), w.to(dt))
    return y if b is None else y + b.to(dt)


def layer_norm(x, w, b, eps):
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def scatter_image_features(h: torch.Tensor, input_ids: torch.Tensor,
                           feats: torch.Tensor, image_ids) -> torch.Tensor:
    """Token embeddings h [B, T, D] with the merged vision features [N, D]
    written over the image / video placeholders in order (a cumsum
    scatter, no host read)."""
    is_img = torch.zeros_like(input_ids, dtype=torch.bool)
    for tid in image_ids:
        is_img |= input_ids == tid
    idx = torch.clamp(torch.cumsum(is_img.reshape(-1).to(torch.int64), 0) - 1,
                      0, feats.shape[0] - 1)
    img = feats[idx].reshape(h.shape).to(h.dtype)
    return torch.where(is_img[..., None], img, h)
