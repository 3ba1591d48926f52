"""EngineCore: prefill and chunked decode for one model + batch geometry.

Port of the JAX package's ``pie_tpu/engine/core.py``. The compiled
``lax.scan`` over decode steps becomes a Python loop of ``num_steps`` model
calls: PyTorch queues the device work of a whole chunk without waiting for
it, and the host reads the chunk's tokens once, when it drains it. Per-
sequence sampling parameters, penalties and stop tokens are tensors, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pie_tpu_torch.cache.kv_cache import make_kv_cache
from pie_tpu_torch.ops.sampling import (
    SamplingParams,
    apply_logit_bias,
    dry_penalty,
    log_softmax,
    presence_frequency_penalty,
    repetition_penalty,
    sample,
    top_logprobs,
)
from pie_tpu_torch.utils.device import resolve_device

PAD_TOKEN = -1


@dataclasses.dataclass(frozen=True)
class PenaltyParams:
    """Per-sequence logits-processor parameters [B]."""

    repetition: torch.Tensor
    presence: torch.Tensor
    frequency: torch.Tensor
    dry_multiplier: Optional[torch.Tensor] = None
    dry_base: Optional[torch.Tensor] = None
    dry_allowed: Optional[torch.Tensor] = None

    def __post_init__(self):
        r = self.repetition
        if self.dry_multiplier is None:
            object.__setattr__(self, "dry_multiplier", torch.zeros_like(r))
        if self.dry_base is None:
            object.__setattr__(self, "dry_base", torch.full_like(r, 1.75))
        if self.dry_allowed is None:
            object.__setattr__(
                self, "dry_allowed", torch.full_like(r, 2, dtype=torch.int32)
            )

    @classmethod
    def make(
        cls, batch: int, repetition: float = 1.0, presence: float = 0.0,
        frequency: float = 0.0, dry_multiplier: float = 0.0,
        dry_base: float = 1.75, dry_allowed: int = 2, *, device,
    ) -> "PenaltyParams":
        f32 = lambda v: torch.full((batch,), v, dtype=torch.float32, device=device)
        return cls(
            repetition=f32(repetition), presence=f32(presence),
            frequency=f32(frequency), dry_multiplier=f32(dry_multiplier),
            dry_base=f32(dry_base),
            dry_allowed=torch.full((batch,), dry_allowed, dtype=torch.int32,
                                   device=device),
        )


@dataclasses.dataclass(frozen=True)
class DecodeState:
    """Carried state of the decode loop (one slot per batch lane)."""

    cache: object
    last_token: torch.Tensor  # [B] int32
    lengths: torch.Tensor  # [B] int32 — current length == next position
    history: torch.Tensor  # [B, H] recent tokens for penalties (-1 pad)
    done: torch.Tensor  # [B] bool
    key: torch.Generator


class EngineCore:
    """Prefill/decode for one model + fixed batch geometry on one device."""

    #: recent tokens kept for the repetition / presence / DRY penalties
    history_len = 64

    def __init__(
        self,
        model,
        params,
        batch_size: int = 1,
        max_seq_len: int = 2048,
        kv_dtype=torch.bfloat16,
        kv_quantized: bool = False,
        logprobs_k: int = 8,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        self.kv_dtype = kv_dtype
        self.kv_quantized = kv_quantized
        self.logprobs_k = logprobs_k

    def new_state(self, seed: int = 0) -> DecodeState:
        cfg = self.model.config
        cache = make_kv_cache(
            cfg.num_hidden_layers, self.batch_size, self.max_seq_len,
            cfg.num_key_value_heads, cfg.resolved_head_dim,
            dtype=self.kv_dtype, quantized=self.kv_quantized,
            device=self.device,
        )
        b, dev = self.batch_size, self.device
        return DecodeState(
            cache=cache,
            last_token=torch.zeros((b,), dtype=torch.int32, device=dev),
            lengths=torch.zeros((b,), dtype=torch.int32, device=dev),
            history=torch.full((b, self.history_len), PAD_TOKEN,
                               dtype=torch.int32, device=dev),
            done=torch.ones((b,), dtype=torch.bool, device=dev),
            key=torch.Generator(device=dev).manual_seed(seed),
        )

    # ------------------------------------------------------------------

    def _process_logits(self, logits, history, penalties, bias_ids,
                        bias_vals, allowed_mask):
        logits = apply_logit_bias(logits, bias_ids, bias_vals)
        logits = repetition_penalty(logits, history, penalties.repetition)
        logits = presence_frequency_penalty(
            logits, history, penalties.presence, penalties.frequency
        )
        logits = dry_penalty(
            logits, history, penalties.dry_multiplier, penalties.dry_base,
            penalties.dry_allowed,
        )
        if allowed_mask is not None:
            logits = torch.where(allowed_mask, logits,
                                 torch.full_like(logits, -1e30))
        return logits

    def _push_history(self, history, token, active):
        new = torch.where(active, token, torch.full_like(token, PAD_TOKEN))
        return torch.cat([history[:, 1:], new[:, None]], dim=1)

    def _logprobs(self, proc, token):
        lp = log_softmax(proc)
        chosen = torch.gather(lp, 1, token[:, None].long())[:, 0]
        tv, ti = top_logprobs(lp, self.logprobs_k)
        return chosen, tv, ti

    @torch.no_grad()
    def _prefill(
        self,
        params,
        state: DecodeState,
        input_ids,  # [B, Tpad]
        prompt_lens,  # [B]
        first_pos,  # [B] start position (prefix-cache reuse offset)
        sampling: SamplingParams,
        penalties: PenaltyParams,
        bias_ids,
        bias_vals,
        allowed_mask=None,
        return_logprobs: bool = False,
        sampler_kind: str = "auto",
    ):
        """Run the prompt through the model, sample the first new token."""
        b, t = input_ids.shape
        dev = input_ids.device
        positions = first_pos[:, None] + torch.arange(t, dtype=torch.int32,
                                                      device=dev)[None, :]
        cache = state.cache.advance(first_pos, t, valid_lens=prompt_lens)
        logits, cache = self.model(params, input_ids, cache, positions,
                                   valid_lens=prompt_lens)
        cache = cache.trim_to(first_pos + prompt_lens)

        # logits of the LAST real prompt token, per sequence
        last_idx = torch.clamp(prompt_lens - 1, 0, t - 1).long()
        last_logits = torch.gather(
            logits, 1,
            last_idx[:, None, None].expand(b, 1, logits.shape[-1]),
        )[:, 0]

        # seed history with the tail of the prompt
        h = self.history_len
        hist_idx = prompt_lens[:, None] - h + torch.arange(h, device=dev)[None, :]
        hist = torch.where(
            hist_idx >= 0,
            torch.gather(input_ids, 1, torch.clamp(hist_idx, 0, t - 1).long()),
            torch.full_like(hist_idx, PAD_TOKEN),
        ).to(torch.int32)

        proc = self._process_logits(last_logits, hist, penalties, bias_ids,
                                    bias_vals, allowed_mask)
        token = sample(proc, sampling, state.key, kind=sampler_kind)
        new_state = DecodeState(
            cache=cache,
            last_token=token,
            lengths=(first_pos + prompt_lens).to(torch.int32),
            history=self._push_history(
                hist, token, torch.ones((b,), dtype=torch.bool, device=dev)
            ),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
            key=state.key,
        )
        aux = self._logprobs(proc, token) if return_logprobs else None
        return new_state, token, aux

    @torch.no_grad()
    def _decode(
        self,
        params,
        state: DecodeState,
        sampling: SamplingParams,
        penalties: PenaltyParams,
        bias_ids,
        bias_vals,
        stop_ids,  # [NS] int32, -1 padded
        allowed_mask=None,
        num_steps: int = 8,
        return_logprobs: bool = False,
        sampler_kind: str = "auto",
        kv_bucket: int = 0,
    ):
        """``num_steps`` decode steps; done lanes emit PAD and freeze.

        kv_bucket: the chunk attends over a [.., :kv_bucket] view of the
        cache (every position it touches is < kv_bucket), then merges the
        metadata back. Returns (state, outs) with outs[0] the emitted
        tokens [num_steps, B] (+ chosen, top values, top ids with logprobs).
        """
        full_cache = None
        cache0 = state.cache
        if (kv_bucket and getattr(cache0, "window", None) is None
                and kv_bucket < cache0.capacity):
            full_cache = cache0
            state = dataclasses.replace(state, cache=cache0.trim_capacity(kv_bucket))

        outs = []
        for _ in range(num_steps):
            active = ~state.done
            cache = state.cache.advance(state.lengths, 1)
            logits, cache = self.model(params, state.last_token[:, None], cache,
                                       state.lengths[:, None])
            logits = logits[:, 0]
            proc = self._process_logits(logits, state.history, penalties,
                                        bias_ids, bias_vals, allowed_mask)
            if sampler_kind == "greedy":
                token = sample(proc, sampling, state.key, kind=sampler_kind)
            elif bool(active.any()):
                # random draws only while some lane samples: a speculative
                # chunk after every lane froze leaves the generator as it
                # was (the host reads the flags here, off the greedy path)
                token = sample(proc, sampling, state.key, kind=sampler_kind)
            else:
                token = state.last_token
            token = torch.where(active, token, state.last_token)
            # stop ids are -1 padded; real tokens are >= 0 so pads never match
            hit_stop = (token[:, None] == stop_ids[None, :]).any(dim=1)
            emitted = torch.where(active, token, torch.full_like(token, PAD_TOKEN))
            state = DecodeState(
                cache=cache,
                last_token=token,
                lengths=torch.where(active, state.lengths + 1, state.lengths),
                history=self._push_history(state.history, token, active),
                done=state.done | hit_stop,
                key=state.key,
            )
            if return_logprobs:
                outs.append((emitted, *self._logprobs(proc, token)))
            else:
                outs.append((emitted,))
        stacked = tuple(torch.stack(col) for col in zip(*outs))
        if full_cache is not None:
            state = dataclasses.replace(
                state, cache=full_cache.merge_trimmed(state.cache)
            )
        return state, stacked
