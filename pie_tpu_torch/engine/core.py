"""EngineCore: prefill and chunked decode for one model + batch geometry.

Port of the JAX package's ``pie_tpu/engine/core.py``. Its two ``jax.jit``
programs become steps run through ``StepGraphs`` (``engine/graphs.py``):
on the card a CUDA graph per static key, captured at the key's first use
and replayed after; on the CPU the same step function, called directly.

- The prefill (``_prefill``): one graph per (prompt bucket, sampler kind,
  logprobs, bias width, mask on, embeds on, M-RoPE streams on). The
  prompt's ids, lengths and first positions (the prompt cache's offset),
  the constrained mask, and an image prompt's embeddings [B, bucket, D]
  and M-RoPE streams [3, B, bucket] are copied into static buffers, so one
  graph serves every prompt length, offset, mask and image of its bucket.
- The compiled ``lax.scan`` over decode steps becomes ``num_steps`` runs
  of one decode step, one graph per (KV bucket, sampler kind, logprobs,
  penalties on, bias on). A ``uses_mrope`` model's step turns rope at
  lengths - pos_delta, read from a static [B] buffer (``set_pos_delta``:
  zeros for text, an image prompt's offset), so one graph serves both.

Both steps read and write the core's one ``DecodeState``, whose tensors
are static buffers (``new_state`` resets them in place); a chunk's
sampling, penalty, bias and stop inputs are copied into static buffers
before its first step. PyTorch queues the device work without waiting for
it, and the host reads a prefill's token, or a chunk's tokens once, when
it drains them. Per-sequence sampling parameters, penalties and stop
tokens are tensors, as in the JAX package.

The steps cover the contiguous KV cache in bf16 (the single-stream
default) and in INT8, whose writes take ``scatter_drop``'s path without a
host read at any chunk length, and a model's own cache
(``model.make_cache``: Gemma-3's DualKVCache, whose rotating slot the step
computes on the device). ``maybe_quantize`` reads the cache's length on
the host: it runs between requests, never inside a step, and the INT8
cache it makes replaces the static one through ``set_cache`` (the graphs
over the old one go, the prefill graphs with them).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from pie_tpu_torch.cache.kv_cache import (
    cache_kind,
    cache_tensors,
    copy_metadata,
    make_kv_cache,
    reset_metadata,
)
from pie_tpu_torch.engine.graphs import StepGraphs
from pie_tpu_torch.ops.sampling import (
    SAMPLER_KINDS,
    SamplingParams,
    apply_logit_bias,
    dry_penalty,
    log_softmax,
    presence_frequency_penalty,
    repetition_penalty,
    sample,
    top_logprobs,
)
from pie_tpu_torch.utils.device import resolve_device, upload

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
    """Carried state of the decode loop (one slot per batch lane). The
    core's state is updated in place: ``_prefill`` and ``_decode`` return
    the very state they were given, which a later call changes again."""

    cache: object
    last_token: torch.Tensor  # [B] int32
    lengths: torch.Tensor  # [B] int32 — current length == next position
    history: torch.Tensor  # [B, H] recent tokens for penalties (-1 pad)
    done: torch.Tensor  # [B] bool
    key: torch.Generator


@dataclasses.dataclass(frozen=True)
class _StepInputs:
    """Static buffers of a chunk's per-sequence inputs."""

    sampling: SamplingParams
    penalties: PenaltyParams
    bias_ids: torch.Tensor  # [B, NB] int32 (-1 pad)
    bias_vals: torch.Tensor  # [B, NB] f32
    stop_ids: torch.Tensor  # [NS] int32 (-1 pad)


def _copy_fields(dst, src) -> None:
    """Copy every tensor field of dataclass ``src`` into ``dst``'s."""
    for f in dataclasses.fields(dst):
        d = getattr(dst, f.name)
        if isinstance(d, torch.Tensor):
            d.copy_(getattr(src, f.name))


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
        self._gen = torch.Generator(device=self.device)
        #: the decode step's graphs (jax.jit's cache of compiled programs)
        self.graphs = StepGraphs(self.device, self._gen)
        self._state: Optional[DecodeState] = None
        self._made_kind: Optional[tuple] = None  # what new_state builds
        # (bias width, stop width) -> static chunk inputs
        self._inputs: dict = {}
        # prompt bucket -> static prefill inputs; the static [B, V] mask
        self._prefill_in: dict = {}
        self._allowed: Optional[torch.Tensor] = None
        # (shape, dtype) -> static image-prompt embeddings; bucket -> static
        # M-RoPE streams
        self._embeds_in: dict = {}
        self._pos3_in: dict = {}
        #: M-RoPE decode offsets [B] (a uses_mrope model's steps read them)
        self.pos_delta = torch.zeros((batch_size,), dtype=torch.int32,
                                     device=self.device)
        # a prefill checks no stop ids: its inputs' stop width is 0
        self._no_stop = torch.full((0,), PAD_TOKEN, dtype=torch.int32,
                                   device=self.device)

    def new_state(self, seed: int = 0) -> DecodeState:
        """The core's decode state, reset, with its generator seeded. The
        first call makes the static buffers; later calls reset them in
        place, so the graphs captured over them stay valid. ``_prefill``
        and ``_decode`` take and return this very state."""
        self._gen.manual_seed(seed)
        st = self._state
        if st is not None and cache_kind(st.cache) == self._made_kind:
            reset_metadata(st.cache)
            st.last_token.zero_()
            st.lengths.zero_()
            st.history.fill_(PAD_TOKEN)
            st.done.fill_(True)
            return st
        cfg = self.model.config
        if hasattr(self.model, "make_cache"):
            # the model's own layout (Gemma-3's bounded sliding/global groups)
            cache = self.model.make_cache(
                self.batch_size, self.max_seq_len, dtype=self.kv_dtype,
                quantized=self.kv_quantized, device=self.device)
        else:
            cache = make_kv_cache(
                cfg.num_hidden_layers, self.batch_size, self.max_seq_len,
                cfg.num_key_value_heads, cfg.resolved_head_dim,
                dtype=self.kv_dtype, quantized=self.kv_quantized,
                device=self.device,
            )
        self._made_kind = cache_kind(cache)
        b, dev = self.batch_size, self.device
        if st is not None:  # the INT8 cache goes: so do its graphs
            self.graphs = StepGraphs(self.device, self._gen)
        self._state = DecodeState(
            cache=cache,
            last_token=torch.zeros((b,), dtype=torch.int32, device=dev),
            lengths=torch.zeros((b,), dtype=torch.int32, device=dev),
            history=torch.full((b, self.history_len), PAD_TOKEN,
                               dtype=torch.int32, device=dev),
            done=torch.ones((b,), dtype=torch.bool, device=dev),
            key=self._gen,
        )
        return self._state

    def set_cache(self, cache) -> DecodeState:
        """Put ``cache`` (a prompt-cache load, an INT8 conversion) in the
        static state: copied in place when it matches the static cache in
        kind, shapes and dtypes (every group of a DualKVCache), so the
        graphs stay valid; else it becomes the static cache and the graphs
        over the old one go."""
        st = self._adopt(self._state)
        old, new = cache_tensors(st.cache), cache_tensors(cache)
        if cache_kind(cache) == cache_kind(st.cache) and all(
                new[n].shape == t.shape and new[n].dtype == t.dtype
                for n, t in old.items()):
            for n, t in old.items():
                t.copy_(new[n])
        else:
            self._state = st = dataclasses.replace(st, cache=cache)
            self.graphs = StepGraphs(self.device, self._gen)
        return st

    def _adopt(self, state: DecodeState) -> DecodeState:
        """``state``, checked to be the core's static state."""
        if state is None or state is not self._state:
            raise ValueError("not this core's decode state: new_state() makes "
                             "it, set_cache() swaps its cache")
        return state

    def _step_inputs(self, sampling, penalties, bias_ids, bias_vals,
                     stop_ids) -> _StepInputs:
        """The static input buffers of this width, holding these values
        (copied, queued on the stream)."""
        shape = (bias_ids.shape[1], stop_ids.shape[0])
        inp = self._inputs.get(shape)
        if inp is None:
            inp = self._inputs[shape] = _StepInputs(
                sampling=SamplingParams(**{
                    f.name: getattr(sampling, f.name).clone()
                    for f in dataclasses.fields(sampling)}),
                penalties=PenaltyParams(**{
                    f.name: getattr(penalties, f.name).clone()
                    for f in dataclasses.fields(penalties)}),
                bias_ids=bias_ids.clone(), bias_vals=bias_vals.clone(),
                stop_ids=stop_ids.clone(),
            )
            return inp
        _copy_fields(inp.sampling, sampling)
        _copy_fields(inp.penalties, penalties)
        inp.bias_ids.copy_(bias_ids)
        inp.bias_vals.copy_(bias_vals)
        inp.stop_ids.copy_(stop_ids)
        return inp

    # ------------------------------------------------------------------

    def _process_logits(self, logits, history, penalties, bias_ids,
                        bias_vals, allowed_mask):
        """Bias, then the penalties; ``penalties`` or ``bias_ids`` None
        leaves that processor out (with neutral values it changes nothing)."""
        if bias_ids is not None:
            logits = apply_logit_bias(logits, bias_ids, bias_vals)
        if penalties is not None:
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

    def _prefill_buffers(self, bucket: int) -> tuple:
        """The static prefill inputs of this bucket: ids [B, bucket],
        prompt lengths [B] and first positions [B] (the prompt cache's
        offset, a device value as JAX traces it), made at first use."""
        bufs = self._prefill_in.get(bucket)
        if bufs is None:
            b, dev = self.batch_size, self.device
            bufs = self._prefill_in[bucket] = (
                torch.zeros((b, bucket), dtype=torch.int32, device=dev),
                torch.zeros((b,), dtype=torch.int32, device=dev),
                torch.zeros((b,), dtype=torch.int32, device=dev))
        return bufs

    def set_pos_delta(self, delta) -> None:
        """Copy the sequences' M-RoPE decode offsets [B] into the static
        buffer the decode steps read (queued on the stream)."""
        upload(self.pos_delta, delta)

    def _image_buffers(self, bucket: int, inputs_embeds, positions3) -> tuple:
        """The static image-prompt inputs of this bucket, holding these
        values (device copies on the stream): embeddings [B, bucket, D] and
        M-RoPE streams [3, B, bucket] (a host array, uploaded), each None
        when not given."""
        emb = p3 = None
        if inputs_embeds is not None:
            key = (tuple(inputs_embeds.shape), inputs_embeds.dtype)
            emb = self._embeds_in.get(key)
            if emb is None:
                emb = self._embeds_in[key] = torch.empty_like(inputs_embeds)
            emb.copy_(inputs_embeds)
        if positions3 is not None:
            p3 = self._pos3_in.get(bucket)
            if p3 is None:
                p3 = self._pos3_in[bucket] = torch.zeros(
                    (3, self.batch_size, bucket), dtype=torch.int32, device=self.device)
            upload(p3, positions3)
        return emb, p3

    def _mask_buffer(self, allowed_mask) -> torch.Tensor:
        """The static [B, V] allowed-token mask holding ``allowed_mask``
        (a host array, uploaded from pinned memory, or a tensor), made at
        the first masked prefill."""
        if self._allowed is None:
            self._allowed = torch.ones(tuple(allowed_mask.shape), dtype=torch.bool,
                                       device=self.device)
        upload(self._allowed, allowed_mask)
        return self._allowed

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
        inputs_embeds=None,  # [B, Tpad, D] an image prompt's embeddings
        positions3=None,  # [3, B, Tpad] its M-RoPE streams (host array)
    ):
        """Run the prompt through the model, sample the first new token.

        The prompt's ids, lengths and first positions (host arrays or
        tensors), the mask and an image prompt's embeddings and M-RoPE
        streams are copied into static buffers, then the prefill step runs
        through ``self.graphs`` keyed by (bucket, sampler kind, logprobs,
        bias width, mask on, embeds on, streams on, params), as ``jax.jit``
        keys the JAX prefill by its static arguments and shapes: on the
        card a CUDA graph per key, on the CPU the step itself. sampler_kind is
        resolved on the host ("auto" is refused). The step writes the
        result into the static state. Returns (state, token, aux), the
        token and the logprobs aux (chosen, top values, top ids) tensors of
        their own."""
        if sampler_kind not in SAMPLER_KINDS:
            raise ValueError(f"sampler kind {sampler_kind!r}: resolve it on the host "
                             f"(one of {sorted(SAMPLER_KINDS)})")
        st = self._adopt(state)
        bucket = input_ids.shape[1]
        bufs = self._prefill_buffers(bucket)
        for buf, src in zip(bufs, (input_ids, prompt_lens, first_pos)):
            upload(buf, src)
        mask = None if allowed_mask is None else self._mask_buffer(allowed_mask)
        image = self._image_buffers(bucket, inputs_embeds, positions3)
        inp = self._step_inputs(sampling, penalties, bias_ids, bias_vals,
                                self._no_stop)
        key = ("prefill", bucket, sampler_kind, return_logprobs, bias_ids.shape[1],
               mask is not None, image[0] is not None, image[1] is not None,
               id(params))
        step = functools.partial(self._prefill_step, params, st, inp, bufs, mask,
                                 sampler_kind, return_logprobs, image)
        res = self.graphs(key, step, samples=sampler_kind != "greedy")
        token = res[0].clone()
        aux = tuple(r.clone() for r in res[2:]) if return_logprobs else None
        return st, token, aux

    def _prefill_step(self, params, st: DecodeState, inp: _StepInputs, bufs,
                      allowed_mask, sampler_kind: str, return_logprobs: bool,
                      image: tuple = (None, None)):
        """The prefill over the static state and buffers (a graph's body):
        the prompt's KV written in place, the first token sampled from the
        last real prompt position's processed logits. Penalties always
        apply, as in the JAX prefill. ``image``: the static embeddings and
        M-RoPE streams of an image prompt (None each when off). Returns
        (token [B], processed logits [B, V]) plus (chosen, top values, top
        ids) with logprobs."""
        input_ids, prompt_lens, first_pos = bufs
        b, t = input_ids.shape
        dev = input_ids.device
        positions = first_pos[:, None] + torch.arange(t, dtype=torch.int32,
                                                      device=dev)[None, :]
        cache = st.cache.advance(first_pos, t, valid_lens=prompt_lens)
        extra = {} if image[1] is None else {"positions3": image[1]}
        logits, cache = self.model(params, input_ids, cache, positions,
                                   inputs_embeds=image[0], valid_lens=prompt_lens,
                                   **extra)
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

        proc = self._process_logits(last_logits, hist, inp.penalties, inp.bias_ids,
                                    inp.bias_vals, allowed_mask)
        token = sample(proc, inp.sampling, st.key, kind=sampler_kind)
        copy_metadata(st.cache, cache)
        st.last_token.copy_(token)
        st.lengths.copy_(first_pos + prompt_lens)
        st.history.copy_(self._push_history(
            hist, token, torch.ones((b,), dtype=torch.bool, device=dev)))
        st.done.fill_(False)
        out = (token, proc)
        if return_logprobs:
            out += self._logprobs(proc, token)
        return out

    def _decode_step(self, params, st: DecodeState, inp: _StepInputs,
                     bucket: int, sampler_kind: str, return_logprobs: bool,
                     use_penalties: bool, use_bias: bool):
        """One decode step over the static state (the graph's body): done
        lanes emit PAD and freeze. Returns (emitted [B], processed logits
        [B, V]) plus (chosen, top values, top ids) with logprobs."""
        full = st.cache
        cache = full.trim_capacity(bucket) if bucket < full.capacity else full
        active = ~st.done
        adv = cache.advance(st.lengths, 1)
        extra = {}
        if getattr(self.model, "uses_mrope", False):
            # M-RoPE: rope turns pos_delta behind the KV slot (text: 0)
            rope = (st.lengths - self.pos_delta)[:, None]
            extra["positions3"] = rope[None].expand(3, *rope.shape)
        logits, _ = self.model(params, st.last_token[:, None], adv,
                               st.lengths[:, None], **extra)
        proc = self._process_logits(
            logits[:, 0], st.history, inp.penalties if use_penalties else None,
            inp.bias_ids if use_bias else None, inp.bias_vals, None)
        token = sample(proc, inp.sampling, st.key, kind=sampler_kind)
        token = torch.where(active, token, st.last_token)
        # stop ids are -1 padded; real tokens are >= 0 so pads never match
        hit_stop = (token[:, None] == inp.stop_ids[None, :]).any(dim=1)
        emitted = torch.where(active, token, torch.full_like(token, PAD_TOKEN))
        out = (emitted, proc)
        if return_logprobs:
            out += self._logprobs(proc, token)
        lengths = torch.where(active, st.lengths + 1, st.lengths)
        history = self._push_history(st.history, token, active)
        done = st.done | hit_stop
        # carry the state into the static buffers (k / v were written in
        # place through the bucket's view, which shares the full length)
        copy_metadata(cache, adv)
        st.last_token.copy_(token)
        st.lengths.copy_(lengths)
        st.history.copy_(history)
        st.done.copy_(done)
        return out

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
        num_steps: int = 8,
        return_logprobs: bool = False,
        sampler_kind: str = "greedy",
        kv_bucket: int = 0,
        use_penalties: bool = True,
        use_bias: bool = True,
    ):
        """``num_steps`` decode steps; done lanes emit PAD and freeze.

        kv_bucket: every step attends over a [.., :kv_bucket] view of the
        cache (every position the chunk touches is < kv_bucket).
        sampler_kind is resolved on the host ("greedy" / "categorical" /
        "filtered"); use_penalties / use_bias False leave those processors
        out of the step. Every step draws its random numbers, whether or
        not a lane is still live (as the JAX scan splits its key on every
        step). Returns (state, outs) with outs[0] the emitted tokens
        [num_steps, B] (+ chosen, top values, top ids with logprobs): this
        chunk's own tensors, which later chunks leave alone.
        """
        if sampler_kind not in SAMPLER_KINDS:
            raise ValueError(f"sampler kind {sampler_kind!r}: resolve it on the host "
                             f"(one of {sorted(SAMPLER_KINDS)})")
        st = self._adopt(state)
        inp = self._step_inputs(sampling, penalties, bias_ids, bias_vals, stop_ids)
        bucket = st.cache.capacity
        if kv_bucket and getattr(st.cache, "window", None) is None:
            bucket = min(kv_bucket, bucket)
        key = ("decode", bucket, sampler_kind, return_logprobs, use_penalties,
               use_bias, bias_ids.shape[1], stop_ids.shape[0],
               id(params))
        step = functools.partial(self._decode_step, params, st, inp, bucket,
                                 sampler_kind, return_logprobs, use_penalties,
                                 use_bias)
        b, k, dev = self.batch_size, self.logprobs_k, self.device
        outs = [torch.empty((num_steps, b), dtype=torch.int32, device=dev)]
        if return_logprobs:
            outs += [torch.empty((num_steps, b), dtype=torch.float32, device=dev),
                     torch.empty((num_steps, b, k), dtype=torch.float32, device=dev),
                     torch.empty((num_steps, b, k), dtype=torch.int32, device=dev)]
        for s in range(num_steps):
            res = self.graphs(key, step, samples=sampler_kind != "greedy")
            outs[0][s].copy_(res[0])
            for o, r in zip(outs[1:], res[2:]):
                o[s].copy_(r)
        return st, tuple(outs)
