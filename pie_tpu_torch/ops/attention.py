"""Attention ops: GQA scaled-dot-product attention and masks (plain PyTorch).

Same contract and cast points as the JAX package's
``pie_tpu/ops/attention.py``: fixed-capacity KV with position-based
validity masks, f32 scores and softmax, the JAX einsums written out with
``torch.einsum``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_mask(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    window_size: Optional[int] = None,
) -> torch.Tensor:
    """Boolean mask [B, Tq, Skv]: True = attend. kv position -1 = empty."""
    q = q_positions[:, :, None]
    kv = kv_positions[:, None, :]
    mask = (kv >= 0) & (kv <= q)
    if window_size is not None:
        mask &= kv > (q - window_size)
    return mask


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with f32 accumulation (``preferred_element_type=f32``):
    bf16 operands are widened first, so products are exact and sums f32."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def sdpa_quantized(
    q: torch.Tensor,
    kq: torch.Tensor,  # [B, Skv, Hkv, D] int8
    ks: torch.Tensor,  # [B, Skv, Hkv, 1] f32 per-(token, head) scales
    vq: torch.Tensor,
    vs: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """GQA attention directly over int8 KV: the K scale factors out of the
    score dot, the V scale folds into the probabilities."""
    b, tq, hq, d = q.shape
    hkv = kq.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, tq, hkv, rep, d).to(torch.bfloat16)
    scores = _f32_einsum("bthrd,bshd->bhrts", qg, kq.to(torch.bfloat16))
    scores = scores * (scale * ks[..., 0].permute(0, 2, 1))[:, :, None, None, :]
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    pv = probs * vs[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    out = _f32_einsum(
        "bhrts,bshd->bthrd", pv.to(torch.bfloat16), vq.to(torch.bfloat16)
    )
    return out.reshape(b, tq, hq, d).to(q.dtype)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention. q [B, Tq, Hq, D]; k, v [B, Skv, Hkv, D]; mask
    [B, Tq, Skv]. Returns [B, Tq, Hq, D] in q.dtype; softmax in f32."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, tq, hkv, rep, d)
    scores = _f32_einsum("bthrd,bshd->bhrts", qg, k) * scale
    if logit_softcap is not None:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _f32_einsum("bhrts,bshd->bthrd", probs.to(v.dtype), v)
    return out.reshape(b, tq, hq, d).to(q.dtype)
