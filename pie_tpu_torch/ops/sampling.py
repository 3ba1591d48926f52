"""Batched sampling and logits processing (plain PyTorch).

Port of the JAX package's ``pie_tpu/ops/sampling.py``: one batched sampler
whose per-sequence parameters are tensors [B] (disabled filters encoded as
neutral values: top_k <= 0, top_p >= 1, min_p <= 0), Gumbel-max sampling,
and the repetition / presence / frequency / DRY / logit-bias processors.
Random numbers come from an explicit ``torch.Generator``; they are not the
JAX package's bits, so sampled paths agree in distribution only. Every
draw is a ``torch.rand`` on that generator, which a CUDA graph can capture
(``engine/graphs.py`` registers the generator with each graph that
samples). A sampler given ``rows`` (a dp rank's slice of the batch) draws
the whole batch's numbers and keeps its rows: each lane gets the draws it
would get unsharded, and every rank's generator advances alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-sequence sampling parameters, batched [B]."""

    temperature: torch.Tensor
    top_p: torch.Tensor
    min_p: torch.Tensor
    top_k: torch.Tensor
    xtc_probability: Optional[torch.Tensor] = None
    xtc_threshold: Optional[torch.Tensor] = None

    def __post_init__(self):
        t = self.temperature
        if self.xtc_probability is None:
            object.__setattr__(self, "xtc_probability", torch.zeros_like(t))
        if self.xtc_threshold is None:
            object.__setattr__(self, "xtc_threshold", torch.full_like(t, 0.1))

    @classmethod
    def make(
        cls, batch: int, temperature: float = 1.0, top_p: float = 1.0,
        min_p: float = 0.0, top_k: int = -1, xtc_probability: float = 0.0,
        xtc_threshold: float = 0.1, *, device,
    ) -> "SamplingParams":
        full = lambda v, dt: torch.full((batch,), v, dtype=dt, device=device)
        return cls(
            temperature=full(temperature, torch.float32),
            top_p=full(top_p, torch.float32),
            min_p=full(min_p, torch.float32),
            top_k=full(top_k, torch.int32),
            xtc_probability=full(xtc_probability, torch.float32),
            xtc_threshold=full(xtc_threshold, torch.float32),
        )


def _uniform(shape, logits: torch.Tensor, gen, rows=None) -> torch.Tensor:
    if rows is None:
        return torch.rand(shape, generator=gen, device=logits.device,
                          dtype=torch.float32)
    b, own = rows
    return _uniform((b,) + tuple(shape[1:]), logits, gen)[own]


def _gumbel(shape, logits: torch.Tensor, gen, rows=None) -> torch.Tensor:
    u = _uniform(shape, logits, gen, rows).clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample_sorted(logits, params, gen, rows=None):
    """Full path: one descending sort serves top-k, top-p, min-p and XTC."""
    b, v = logits.shape
    scaled = logits / torch.clamp(params.temperature[:, None], min=1e-6)
    coin = _uniform((b, 1), logits, gen, rows)
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, -1, sort_idx)
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    ranks = torch.arange(v, device=logits.device)[None, :]
    # top-k: keep ranks < k (k <= 0 disables)
    tk = params.top_k[:, None].to(torch.int64)
    k = torch.where(tk <= 0, torch.full_like(tk, v), tk)
    keep = ranks < k
    # top-p: exclusive cumulative prob < top_p; rank 0 always kept
    cum_excl = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    keep &= cum_excl < params.top_p[:, None]
    # min-p: prob >= max_prob * min_p, rank 0 always kept
    keep &= (sorted_probs >= sorted_probs[:, :1] * params.min_p[:, None]) | (
        ranks == 0
    )
    # XTC: with probability xtc_probability drop every token above the
    # threshold except the least probable of them (needs >= 2 above). On
    # top of top-k/top-p this can empty the keep set; the argmax below then
    # returns rank 0 (a defect of the reference, mirrored here)
    above = sorted_probs > params.xtc_threshold[:, None]
    n_above = above.sum(dim=-1, keepdim=True)
    xtc_on = (
        (params.xtc_probability[:, None] > 0.0)
        & (coin < params.xtc_probability[:, None])
        & (n_above >= 2)
    )
    keep &= ~(xtc_on & (ranks < n_above - 1))
    masked = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, NEG_INF))
    pick_rank = torch.argmax(masked + _gumbel((b, v), logits, gen, rows), dim=-1)
    sampled = torch.gather(sort_idx, -1, pick_rank[:, None])[:, 0]
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(params.temperature <= 0.0, greedy, sampled).to(torch.int32)


def _sample_nofilter(logits, params, gen, rows=None):
    """No filter active anywhere in the batch: temperature + Gumbel-max."""
    b, v = logits.shape
    scaled = logits / torch.clamp(params.temperature[:, None], min=1e-6)
    sampled = torch.argmax(scaled + _gumbel((b, v), logits, gen, rows), dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(params.temperature <= 0.0, greedy, sampled).to(torch.int32)


def _sample_greedy(logits, params, gen, rows=None):
    return torch.argmax(logits, dim=-1).to(torch.int32)


SAMPLER_KINDS = {
    "greedy": _sample_greedy,
    "categorical": _sample_nofilter,
    "filtered": _sample_sorted,
}


def sampler_kind_for(temperature, top_p, min_p, top_k, xtc_probability=0.0) -> str:
    """Host-side choice of the cheapest sampler that covers the batch."""
    t = np.asarray(temperature)
    active = t > 0.0
    if not active.any():
        return "greedy"
    if (
        ((np.asarray(top_k) > 0) & active).any()
        or ((np.asarray(top_p) < 1.0) & active).any()
        or ((np.asarray(min_p) > 0.0) & active).any()
        or ((np.asarray(xtc_probability) > 0.0) & active).any()
    ):
        return "filtered"
    return "categorical"


def sample(logits: torch.Tensor, params: SamplingParams, gen,
           kind: str = "auto", rows: Optional[tuple] = None) -> torch.Tensor:
    """Batched sampler: logits [B, V] f32 -> token ids [B] int32.
    ``kind`` picks the path ("greedy" / "categorical" / "filtered"); "auto"
    decides from the parameters, which it reads back to the host, so a
    decode step (a captured graph) is always given a kind resolved on the
    host (``sampler_kind_for``). The draws come from ``gen``; a graph that
    samples registers it, so each replay draws anew. ``rows`` (B, slice):
    ``logits`` are that slice of a batch of B, whose draws are taken whole
    (``MeshOps.batch_rows``)."""
    if kind == "auto":
        kind = sampler_kind_for(
            params.temperature.cpu().numpy(), params.top_p.cpu().numpy(),
            params.min_p.cpu().numpy(), params.top_k.cpu().numpy(),
            params.xtc_probability.cpu().numpy(),
        )
        if kind == "greedy":
            kind = "categorical"  # temperature <= 0 lanes stay greedy in it
    return SAMPLER_KINDS[kind](logits, params, gen, rows)


# ---------------------------------------------------------------------------
# logits processors (batched)
# ---------------------------------------------------------------------------


def _history_ids(history: torch.Tensor):
    valid = history >= 0
    return valid, torch.where(valid, history, torch.zeros_like(history)).long()


def repetition_penalty(logits, history, penalty):
    """Divide positive / multiply negative logits of tokens in ``history``
    [B, C] (pad -1); penalty [B] (1.0 = off)."""
    b, v = logits.shape
    valid, ids = _history_ids(history)
    seen = torch.zeros((b, v), dtype=torch.float32, device=logits.device)
    seen = seen.scatter_reduce(1, ids, valid.to(torch.float32), reduce="amax") > 0
    pen = penalty[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen & (pen != 1.0), penalized, logits)


def presence_frequency_penalty(logits, history, presence, frequency):
    """OpenAI-style presence / frequency penalties."""
    b, v = logits.shape
    valid, ids = _history_ids(history)
    counts = torch.zeros((b, v), dtype=torch.float32, device=logits.device)
    counts = counts.scatter_add(1, ids, valid.to(torch.float32))
    return (
        logits
        - presence[:, None] * (counts > 0).to(torch.float32)
        - frequency[:, None] * counts
    )


def dry_penalty(logits, history, multiplier, base, allowed_length):
    """DRY sequence-repetition penalty over the rolling history window (see
    the JAX package for the semantics): token t is penalized by
    ``multiplier * base**(L - allowed_length)`` where L is the longest
    suffix match whose earlier occurrence was followed by t."""
    b, v = logits.shape
    c = history.shape[1]
    dev = logits.device
    valid = history >= 0
    tail = torch.flip(history, dims=[1])  # tail[:, i] = history[:, c-1-i]
    ar = torch.arange(c, device=dev)
    src_idx = ar[None, :] - 1 - ar[:, None]  # [i, j] -> j - 1 - i
    in_bounds = src_idx >= 0
    gathered = history[:, torch.clamp(src_idx, 0, c - 1)]  # [B, C(i), C(j)]
    cmp = (
        (gathered == tail[:, :, None])
        & in_bounds[None]
        & valid[:, None, :]
        & (gathered >= 0)
    )
    run = torch.cumprod(cmp.to(torch.int32), dim=1)
    m = run.sum(dim=1)  # [B, C]
    m = torch.where(valid, m, torch.zeros_like(m))
    ids = torch.where(valid, history, torch.zeros_like(history)).long()
    L = torch.zeros((b, v), dtype=m.dtype, device=dev)
    L = L.scatter_reduce(1, ids, m, reduce="amax")
    allowed = allowed_length[:, None].to(L.dtype)
    fire = (L >= allowed) & (multiplier[:, None] > 0.0)
    pen = multiplier[:, None] * torch.pow(
        base[:, None], (L - allowed).to(torch.float32)
    )
    return torch.where(fire, logits - pen, logits)


def apply_logit_bias(logits, bias_ids, bias_vals):
    """Sparse per-sequence logit bias: bias_ids [B, NB] (pad -1)."""
    valid = bias_ids >= 0
    ids = torch.where(valid, bias_ids, torch.zeros_like(bias_ids)).long()
    vals = torch.where(valid, bias_vals, torch.zeros_like(bias_vals))
    return logits.scatter_add(1, ids, vals.to(logits.dtype))


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


def top_logprobs(logprobs: torch.Tensor, k: int):
    """Top-k (values, token ids int32) per row."""
    vals, idx = torch.topk(logprobs, k, dim=-1)
    return vals, idx.to(torch.int32)
