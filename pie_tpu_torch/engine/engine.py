"""InferenceEngine: host-side orchestration around EngineCore (PyTorch).

Port of the single-stream engine of the JAX package's
``pie_tpu/engine/engine.py``: bucketed prefill, chunked decode with a
bounded lookahead of queued chunks, stop tokens, max tokens, logprobs,
logit bias and penalties, the prompt cache, and the INT8 KV threshold;
constrained decoding (``generate_constrained``: one masked, bucketed
prefill per choice point, forced runs encoded on the host); the chat API
(``_chat_run`` / ``_chat``, structured requests included); prompts split
into head chunks for a model that bounds its prefill chunk (Gemma-3:
``_prefill_head_chunks``); loading a checkpoint (``model_path``:
``models/loader.py`` and the snapshot's tokenizer); image prompts
(``pixel_values``, with ``image_kwargs={"grid_thw": ...}`` for Qwen2-VL,
or images attached to chat messages): the vision tower runs eagerly over
the whole prompt, then the prompt's embeddings (and a Qwen2-VL prompt's
M-RoPE streams) ride the captured prefill, every head chunk of a Gemma-3
prompt longer than its window included, and a Qwen2-VL prompt's decode
steps turn rope at its offset (``pos_delta``). Every prefill (the
prompt, its head chunks, ``cache_prompt``, each constrained extend) runs
through the core's prefill step, a captured CUDA graph per bucket on the
card (``EngineCore._prefill``). An image prompt skips the prompt cache
and leaves it claiming nothing. Refused with ``InferenceError``:
constrained decoding on an image prompt.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from pie_tpu_torch.cache.kv_cache import cache_kind, cache_tensors
from pie_tpu_torch.engine.core import PAD_TOKEN, EngineCore, PenaltyParams
from pie_tpu_torch.errors import InferenceError
from pie_tpu_torch.ops.sampling import SamplingParams, sampler_kind_for
from pie_tpu_torch.utils.device import host_tensor, resolve_device

logger = logging.getLogger(__name__)

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
#: decode chunks queued ahead of the one the host drains
LOOKAHEAD = 3


def tower_kwargs(model, image_kwargs) -> dict:
    """``embed_with_images``' keyword arguments for an image request on
    ``model``: a Qwen2-VL (M-RoPE) model's ``grid_thw``, which it needs;
    Gemma-3's tower takes none."""
    if getattr(model, "vision", None) is None:
        raise InferenceError("image inputs need a model with a vision tower")
    grid = (image_kwargs or {}).get("grid_thw")
    mrope = getattr(model, "uses_mrope", False)
    if mrope != (grid is not None):
        raise InferenceError("an M-RoPE model's (Qwen2-VL) image inputs need "
                             "image_kwargs={'grid_thw': ...}; other towers take "
                             "no grid_thw")
    return {"grid_thw": grid} if mrope else {}


@dataclasses.dataclass
class TokenLogprob:
    token_id: int
    logprob: float
    top: list[tuple[int, float]]


@dataclasses.dataclass
class StreamedToken:
    token_id: int
    logprob: Optional[TokenLogprob] = None


@dataclasses.dataclass
class GenerationResult:
    token_ids: list[int]
    finish_reason: str  # "stop" | "length"
    prompt_tokens: int
    completion_tokens: int
    logprobs: Optional[list[TokenLogprob]] = None
    text: Optional[str] = None


def _decode_steps(chunk: int, remaining: int) -> int:
    """Decode-chunk length for ``remaining`` tokens from the ladder
    {chunk, chunk/2, ..., 8}."""
    steps = chunk
    while steps > 8 and steps > remaining:
        steps //= 2
    return steps


def _pow2_width(n: int) -> int:
    """The width of a padded per-request list of ``n`` entries: a power of
    two, at least 8."""
    w = 8
    while w < n:
        w *= 2
    return w


def forced_run(machine) -> str:
    """The characters a constraint machine fixes from its current state:
    followed while exactly one character is allowed (never the FreeString
    wildcard), up to completion or 4,096 characters. Empty for a machine
    without ``allowed_chars``."""
    from pie_tpu_torch.structured.token_masks import ANY_CHAR

    if not hasattr(machine, "allowed_chars"):
        return ""
    chars: list[str] = []
    probe = machine.copy()
    while len(chars) < 4096:
        allowed = probe.allowed_chars()
        if len(allowed) != 1:
            break
        ch = next(iter(allowed))
        if ch == ANY_CHAR or not probe.advance(ch):
            break
        chars.append(ch)
        if probe.is_complete:
            break
    return "".join(chars)


def masked_text(masker, ids) -> str:
    """The text of token ids the masker can decode (the others skipped)."""
    return "".join(masker.token_strs[t] for t in ids
                   if t < masker.vocab_size and masker.token_strs[t] is not None)


def _bucket(n: int, buckets=PREFILL_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise InferenceError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


class InferenceEngine:
    """Single-stream engine (one request at a time) on one device."""

    def __init__(
        self,
        model=None,
        params=None,
        tokenizer=None,
        model_path: Optional[str] = None,
        max_seq_len: int = 2048,
        kv_dtype=torch.bfloat16,
        kv_quantized: bool = False,
        decode_chunk: int = 16,
        logprobs_k: int = 8,
        seed: int = 0,
        prompt_cache: bool = True,
        prompt_cache_dir=None,
        kv_quantize_threshold: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if model is None:
            if model_path is None:
                raise ValueError("need model+params or model_path")
            from pie_tpu_torch.models.loader import load_model

            model, params = load_model(model_path, device=self.device)
            if tokenizer is None:
                from pie_tpu_torch.tokenizer import load_tokenizer

                tokenizer = load_tokenizer(model_path)
        self.model = model
        self.params = params
        self.tokenizer = tokenizer
        self.decode_chunk = decode_chunk
        self.core = EngineCore(
            model, params, batch_size=1, max_seq_len=max_seq_len,
            kv_dtype=kv_dtype, kv_quantized=kv_quantized,
            logprobs_k=logprobs_k, device=self.device,
        )
        self.state = self.core.new_state(seed)
        from pie_tpu_torch.cache.prompt_cache import PromptCache

        self.prompt_cache = PromptCache(prompt_cache_dir) if prompt_cache else None
        # convert the contiguous KV cache to INT8 once a sequence crosses
        # this many tokens; None disables
        self.kv_quantize_threshold = kv_quantize_threshold
        self._empty_bias = (
            torch.full((1, 0), PAD_TOKEN, dtype=torch.int32, device=self.device),
            torch.zeros((1, 0), dtype=torch.float32, device=self.device),
        )
        from pie_tpu_torch.vision.utils import make_image_processor

        self.image_processor = make_image_processor(model)

    # ------------------------------------------------------------------

    def _ids(self, a) -> torch.Tensor:
        return host_tensor(np.asarray(a, np.int32), self.device)

    @staticmethod
    def _one(v: int) -> np.ndarray:
        """A prefill's [1] length or first position, uploaded by the core
        into its static buffer."""
        return np.full((1,), v, np.int32)

    def _sampling(self, kw: dict[str, Any]) -> SamplingParams:
        return SamplingParams.make(
            1,
            temperature=float(kw.get("temperature", 1.0)),
            top_p=float(kw.get("top_p", 1.0)),
            min_p=float(kw.get("min_p", 0.0)),
            top_k=int(kw.get("top_k", -1)),
            xtc_probability=float(kw.get("xtc_probability", 0.0)),
            xtc_threshold=float(kw.get("xtc_threshold", 0.1)),
            device=self.device,
        )

    def _penalties(self, kw: dict[str, Any]) -> PenaltyParams:
        return PenaltyParams.make(
            1,
            repetition=float(kw.get("repetition_penalty", 1.0)),
            presence=float(kw.get("presence_penalty", 0.0)),
            frequency=float(kw.get("frequency_penalty", 0.0)),
            dry_multiplier=float(kw.get("dry_multiplier", 0.0)),
            dry_base=float(kw.get("dry_base", 1.75)),
            dry_allowed=int(kw.get("dry_allowed_length", 2)),
            device=self.device,
        )

    def _bias(self, kw):
        logit_bias = kw.get("logit_bias")
        if not logit_bias:
            return self._empty_bias
        n = _pow2_width(len(logit_bias))  # one decode graph per width
        ids = np.full((1, n), PAD_TOKEN, np.int32)
        vals = np.zeros((1, n), np.float32)
        for i, (tid, b) in enumerate(sorted(logit_bias.items())):
            ids[0, i] = int(tid)
            vals[0, i] = float(b)
        return self._ids(ids), host_tensor(vals, self.device)

    def _prefill_bucket(self, n: int) -> int:
        return _bucket(
            n, [b for b in PREFILL_BUCKETS if b <= self.core.max_seq_len]
            or [self.core.max_seq_len],
        )

    # ------------------------------------------------------------------

    def generate_stream(
        self,
        prompt_ids: Sequence[int],
        max_completion_tokens: int = 256,
        stop_token_ids: Sequence[int] = (),
        logprobs: bool = False,
        pixel_values=None,
        image_kwargs: Optional[dict] = None,
        **kwargs,
    ) -> Iterator[StreamedToken]:
        """Yield tokens one at a time; the GenerationResult is the
        generator's return value (StopIteration.value). ``pixel_values``
        (the image processor's patches, a host array or tensor) with
        ``image_kwargs={"grid_thw": [n, 3]}``: the prompt's image
        placeholders take the vision tower's features."""
        result = yield from self._run(
            list(prompt_ids), max_completion_tokens, list(stop_token_ids),
            logprobs, kwargs, pixel_values, image_kwargs,
        )
        return result

    def generate(
        self,
        prompt_ids: Sequence[int],
        max_completion_tokens: int = 256,
        stop_token_ids: Sequence[int] = (),
        logprobs: bool = False,
        pixel_values=None,
        **kwargs,
    ) -> GenerationResult:
        gen = self.generate_stream(
            prompt_ids, max_completion_tokens, stop_token_ids, logprobs,
            pixel_values=pixel_values, **kwargs,
        )
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value

    def cache_prompt(self, prompt_ids: Sequence[int]):
        """Prefill ``prompt_ids`` and persist the resulting KV to the
        prompt-cache directory. Returns the saved path, or None when no
        ``prompt_cache_dir`` is configured."""
        if self.prompt_cache is None:
            raise InferenceError("prompt cache disabled")
        prompt_ids = list(prompt_ids)
        if len(prompt_ids) > self.core.max_seq_len:
            raise InferenceError("prompt exceeds engine max_seq_len")
        first_pos = self._reuse_prefix(prompt_ids)
        suffix, first_pos, _ = self._prefill_head_chunks(
            prompt_ids[first_pos:], first_pos, self._sampling({}),
            self._penalties({}), *self._empty_bias, "greedy")
        slen = len(suffix)
        ids = np.zeros((1, self._prefill_bucket(slen)), np.int32)
        ids[0, :slen] = suffix
        state, _, _ = self.core._prefill(
            self.params, self.state, ids, self._one(slen),
            self._one(first_pos), self._sampling({}), self._penalties({}),
            *self._empty_bias, sampler_kind="greedy",
        )
        self.state = state
        self.prompt_cache.update(prompt_ids)
        return self.prompt_cache.save_prompt(prompt_ids, state.cache)

    def _reuse_prefix(self, prompt_ids) -> int:
        """The prompt cache's reusable prefix, or 0 where the cache's
        rotating sliding store (Gemma-3's DualKVCache) has evicted a token
        that the next query's window needs: the store keeps the last
        ``capacity`` positions written, so a sequence written past the
        window and past the prefix has lost the window before the prefix's
        end. (The JAX engine reuses such a prefix all the same; ROADMAP C.)
        Reads the store's last position on the host, between requests."""
        first_pos = self.prompt_cache.reuse_prefix(prompt_ids)
        sliding = getattr(self.state.cache, "sliding", None)
        if sliding is not None and first_pos > 0:
            last = int(sliding.slot_positions.max())
            if last > max(sliding.capacity - 1, first_pos):
                return 0
        return first_pos

    def _prefill_head_chunks(self, suffix, first_pos, sampling, penalties,
                             bias_ids, bias_vals, skind, embeds=None):
        """Split a long prompt into sequential prefill chunks when the model
        bounds how many tokens one forward may write (Gemma-3's rotating
        sliding-window store: a longer chunk would evict KV its own earlier
        queries need; ``prefill_chunk_bound``). Runs every chunk but the
        tail, whose sampling the caller owns, each at the largest prefill
        bucket within the bound (the bound itself when no bucket fits), and
        returns the tail, its first position and its embeddings: an image
        prompt's ``embeds`` [1, len(suffix), D] are sliced per chunk, which
        replays the prefill keyed "embeds on"."""
        bound = getattr(self.model, "prefill_chunk_bound", None)
        if bound is None or len(suffix) <= bound:
            return suffix, first_pos, embeds
        csize = max((b for b in PREFILL_BUCKETS if b <= bound), default=bound)
        off = 0
        while len(suffix) - off > csize:
            self.state, _, _ = self.core._prefill(
                self.params, self.state,
                np.asarray([suffix[off:off + csize]], np.int32),
                self._one(csize), self._one(first_pos + off), sampling,
                penalties, bias_ids, bias_vals, sampler_kind=skind,
                inputs_embeds=None if embeds is None else embeds[:, off:off + csize],
            )
            off += csize
        return suffix[off:], first_pos + off, None if embeds is None else embeds[:, off:]

    def _cache_compatible(self, loaded) -> bool:
        """A disk hit is keyed by token ids only; a file from another model
        or geometry must fall back to recomputation."""
        cur, new = cache_tensors(self.state.cache), cache_tensors(loaded)
        return cache_kind(loaded) == cache_kind(self.state.cache) and all(
            n in new and new[n].shape == t.shape and new[n].dtype == t.dtype
            for n, t in cur.items())

    # ------------------------------------------------------------------

    def _image_embeds(self, prompt_ids, pixel_values, image_kwargs) -> torch.Tensor:
        """The whole prompt's embeddings [1, len, D] with the vision tower's
        features over its placeholders (the tower runs eagerly, now). A
        Qwen2-VL model needs ``image_kwargs={"grid_thw": ...}``; Gemma-3's
        tower takes no grid."""
        kw = tower_kwargs(self.model, image_kwargs)
        px = torch.as_tensor(pixel_values).to(self.device)
        return self.model.embed_with_images(self.params, self._ids([prompt_ids]), px, **kw)

    def _run(self, prompt_ids, max_tokens, stop_token_ids, logprobs, kw,
             pixel_values=None, image_kwargs=None):
        if not prompt_ids:
            raise InferenceError("empty prompt")
        image = pixel_values is not None
        plen = len(prompt_ids)
        if plen + max_tokens > self.core.max_seq_len:
            max_tokens = max(0, self.core.max_seq_len - plen)
        if self.kv_quantize_threshold is not None:
            from pie_tpu_torch.cache.kv_cache import maybe_quantize

            qc = maybe_quantize(self.state.cache, self.kv_quantize_threshold)
            if qc is not self.state.cache:
                self.state = self.core.set_cache(qc)
        # prompt-cache prefix reuse: prefill only the un-cached suffix. An
        # image prompt skips it (placeholder ids do not identify the image)
        # and overwrites the cache from slot 0, so the cache then claims
        # nothing (the JAX engine keeps its old claim: ROADMAP C)
        first_pos = 0
        if self.prompt_cache is not None and image:
            self.prompt_cache.update([])
        elif self.prompt_cache is not None:
            first_pos = self._reuse_prefix(prompt_ids)
            if first_pos == 0 and self.prompt_cache.cache_dir:
                try:
                    hit = self.prompt_cache.load_prompt(prompt_ids, self.device)
                except Exception:
                    logger.warning(
                        "prompt cache: unreadable cache file, recomputing",
                        exc_info=True,
                    )
                    hit = None
                if hit is not None and self._cache_compatible(hit[0]):
                    cache, computed = hit
                    self.state = self.core.set_cache(cache)
                    self.prompt_cache.update(computed)
                    first_pos = self._reuse_prefix(prompt_ids)
        sampling = self._sampling(kw)
        penalties = self._penalties(kw)
        bias_ids, bias_vals = self._bias(kw)
        # host values; xtc_probability is not passed, as in the reference
        # engine (a known defect there: an XTC-only request samples
        # unfiltered), so both engines pick the same sampler
        skind = sampler_kind_for(
            kw.get("temperature", 1.0), kw.get("top_p", 1.0),
            kw.get("min_p", 0.0), kw.get("top_k", -1),
        )
        # an image prompt is embedded whole (first_pos is 0): its head chunks
        # and its tail take their slices
        embeds = (self._image_embeds(prompt_ids, pixel_values, image_kwargs)
                  if image else None)
        suffix, first_pos, embeds = self._prefill_head_chunks(
            prompt_ids[first_pos:], first_pos, sampling, penalties, bias_ids,
            bias_vals, skind, embeds)
        slen = len(suffix)
        ids = np.zeros((1, self._prefill_bucket(slen)), np.int32)
        ids[0, :slen] = suffix
        positions3 = None
        delta = 0
        mrope = getattr(self.model, "uses_mrope", False)
        if image:
            embeds = torch.nn.functional.pad(embeds, (0, 0, 0, ids.shape[1] - slen))
            if mrope:
                from pie_tpu_torch.models.qwen2_vl import image_positions

                positions3, delta = image_positions(self.model, ids,
                                                    image_kwargs["grid_thw"], slen)
        if mrope:
            self.core.set_pos_delta(self._one(delta))
        stop = np.full((_pow2_width(len(stop_token_ids)),), PAD_TOKEN, np.int32)
        stop[:len(stop_token_ids)] = list(stop_token_ids)
        stop = self._ids(stop)
        # penalties / bias on: host values, static arguments of the step
        use_pen = (float(kw.get("repetition_penalty", 1.0)) != 1.0
                   or float(kw.get("presence_penalty", 0.0)) != 0.0
                   or float(kw.get("frequency_penalty", 0.0)) != 0.0
                   or float(kw.get("dry_multiplier", 0.0)) > 0.0)
        use_bias = bool(kw.get("logit_bias"))

        state, token, aux = self.core._prefill(
            self.params, self.state, ids, self._one(slen),
            self._one(first_pos), sampling, penalties, bias_ids, bias_vals,
            return_logprobs=logprobs, sampler_kind=skind, inputs_embeds=embeds,
            positions3=positions3,
        )

        out_tokens: list[int] = []
        out_logprobs: list[TokenLogprob] = []
        finish = "length"

        def emit(tid, chosen=None, tv=None, ti=None):
            out_tokens.append(tid)
            tl = None
            if logprobs and chosen is not None:
                tl = TokenLogprob(
                    tid, float(chosen),
                    list(zip(np.asarray(ti).tolist(),
                             np.asarray(tv, np.float64).tolist())),
                )
                out_logprobs.append(tl)
            return StreamedToken(tid, tl)

        first = int(token[0])
        if logprobs and aux is not None:
            chosen, tv, ti = (a.cpu().numpy() for a in aux)
            yield emit(first, chosen[0], tv[0], ti[0])
        else:
            yield emit(first)

        def _finalize(reason):
            self.state = state
            if self.prompt_cache is not None and not image:
                self.prompt_cache.update(list(prompt_ids) + out_tokens)
            return self._result(prompt_ids, out_tokens, out_logprobs, reason,
                                logprobs)

        if first in stop_token_ids:
            return _finalize("stop")
        if max_tokens <= 1:
            return _finalize("length")

        produced = 1
        planned = 1
        pending: list[tuple] = []  # queued-but-undrained chunks

        def dispatch_next():
            """Queue one more decode chunk: PyTorch returns before the
            device has run it, so the device works on chunk k+1 while the
            host drains chunk k. The chunk's inputs were queued to the
            card already (pinned copies); ``_decode`` copies them into its
            static buffers on the stream, and the chunk's tokens land in
            tensors of its own, which later chunks leave alone."""
            nonlocal state, planned
            steps = _decode_steps(self.decode_chunk, max_tokens - planned)
            # capacity-bucketed attention: round the positions this chunk
            # touches up to a power-of-two bucket
            need = plen + planned + steps
            kvb = 256
            while kvb < need:
                kvb *= 2
            kvb = min(kvb, self.core.max_seq_len)
            state, outs = self.core._decode(
                self.params, state, sampling, penalties, bias_ids, bias_vals,
                stop, num_steps=steps, return_logprobs=logprobs,
                sampler_kind=skind, kv_bucket=kvb, use_penalties=use_pen,
                use_bias=use_bias,
            )
            planned += steps
            pending.append(outs)

        stopped = False
        while (pending or planned < max_tokens) and not stopped:
            while planned < max_tokens and len(pending) <= LOOKAHEAD:
                dispatch_next()
            outs = pending.pop(0)
            if logprobs:
                emitted, chosen, tv, ti = (o.cpu().numpy() for o in outs[:4])
                emitted = emitted[:, 0]
                chosen, tv, ti = chosen[:, 0], tv[:, 0], ti[:, 0]
            else:
                emitted = outs[0].cpu().numpy()[:, 0]  # [steps]
            for s, tid in enumerate(emitted.tolist()):
                if tid == PAD_TOKEN:
                    stopped = True
                    break
                if produced >= max_tokens:
                    break  # bucket overshoot: discard extras, finish "length"
                if logprobs:
                    yield emit(int(tid), chosen[s], tv[s], ti[s])
                else:
                    yield emit(int(tid))
                produced += 1
                if int(tid) in stop_token_ids:
                    stopped = True
                    break
            if stopped:
                finish = "stop"
                break
        self.state = state
        if self.prompt_cache is not None and not image:
            self.prompt_cache.update(list(prompt_ids) + out_tokens)
        return self._result(prompt_ids, out_tokens, out_logprobs, finish, logprobs)

    # -- constrained decoding (structured generation) -------------------

    @property
    def token_masker(self):
        """The vocabulary index for constrained decoding, built at first use."""
        if getattr(self, "_token_masker", None) is None:
            from pie_tpu_torch.structured.token_masks import TokenMasker

            if self.tokenizer is None:
                raise InferenceError("constrained decoding requires a tokenizer")
            self._token_masker = TokenMasker(self.tokenizer)
        return self._token_masker

    EXTEND_BUCKETS = (8, 16, 32, 64, 128, 256)

    def generate_constrained(
        self,
        prompt_ids,
        machine,
        max_completion_tokens: int = 1024,
        stop_token_ids=(),
        logprobs: bool = False,
        **kwargs,
    ):
        """Generation under a character-machine constraint: mask, sample,
        advance, with one device program per choice point.

        - The prompt prefill is the first choice point: one bucketed
          ``_prefill`` that samples under the mask, after the head chunks
          of a model that bounds its prefill chunk (Gemma-3).
        - Every later choice point is one bucketed extend
          (``EXTEND_BUCKETS``) that writes the KV of the pending run and
          samples the next token under the mask.
        - Forced tokens: a run of characters the machine fixes is encoded on
          the host (``encode_longest``), emitted with no device work, and
          its KV rides the next extend.
        - A freeform sub-state that admits any token samples unmasked.
        - Per-state sampler overrides (``state_kwargs``, keyed by the
          machine's ``active_names()``) at each choice point.
        - ``stop_token_ids`` and ``logprobs`` (a forced token reports 0.0).

        The mask is built on the host, padded to the model's vocabulary and
        copied to the device from pinned memory, one [1, V] bool per choice
        point; the only read back is the sampled token (with its logprobs).
        The KV this writes replaces the prompt cache's claim: afterwards the
        cache claims the prompt and the output tokens whose KV was written.

        Returns (GenerationResult, text).
        """
        masker = self.token_masker
        machine = machine.copy()
        v = self.model.config.vocab_size
        prompt_ids = list(prompt_ids)
        plen = len(prompt_ids)
        state_kwargs = kwargs.pop("state_kwargs", None) or {}
        sampling = self._sampling(kwargs)
        penalties = self._penalties(kwargs)
        bias_ids, bias_vals = self._bias(kwargs)
        stop_set = set(stop_token_ids)

        def host_kind(kw):
            return sampler_kind_for(
                kw.get("temperature", 1.0), kw.get("top_p", 1.0),
                kw.get("min_p", 0.0), kw.get("top_k", -1),
                kw.get("xtc_probability", 0.0),
            )

        skind = host_kind(kwargs)

        def resolve_params():
            """Sampler parameters for the machine's current state: a
            composite machine (reasoning + tool call) keys its per-state
            overrides off active_names() at each choice point."""
            if not state_kwargs or not hasattr(machine, "active_names"):
                return sampling, skind
            kw = dict(kwargs)
            for n in sorted(machine.active_names()):
                if n in state_kwargs:
                    kw.update(state_kwargs[n])
            return self._sampling(kw), host_kind(kw)

        def build_mask():
            """The [1, V] mask as a host array (the core uploads it into
            its static mask buffer), or None while a freeform sub-state
            accepts any token. ANY_CHAR alone is not enough: a JSON
            FreeString allows any character but still rejects undecodable
            and control tokens."""
            if getattr(machine, "is_unconstrained", lambda: False)():
                return None
            m = masker.build_mask(machine)
            full = np.zeros((1, v), bool)
            full[0, :m.shape[0]] = m
            return full

        out_tokens: list[int] = []
        out_logprobs: list[TokenLogprob] = []
        finish = "length"

        def dispatch(ids, first_pos, mask, bucket):
            """One prefill of ``ids`` padded to ``bucket`` from ``first_pos``
            that samples the next token under ``mask``; the token (and its
            logprobs) read back in one copy."""
            n = len(ids)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = ids
            sp, sk = resolve_params()
            _, token, aux = self.core._prefill(
                self.params, self.state, padded, self._one(n),
                self._one(first_pos), sp, penalties, bias_ids, bias_vals,
                allowed_mask=mask, return_logprobs=logprobs, sampler_kind=sk,
            )
            if aux is None:
                return int(token.cpu()[0]), None
            k = aux[1].shape[1]
            row = torch.cat([token.float(), aux[0], aux[1][0],
                             aux[2][0].float()]).cpu().numpy()
            return int(row[0]), (float(row[1]), row[2:2 + k],
                                 row[2 + k:].astype(np.int64))

        def emit_sampled(tok, aux):
            if logprobs and aux is not None:
                chosen, tv, ti = aux
                out_logprobs.append(TokenLogprob(
                    tok, chosen,
                    list(zip(ti.tolist(), np.asarray(tv, np.float64).tolist()))))
            out_tokens.append(tok)

        if plen > self.core.max_seq_len - 1:
            raise InferenceError("prompt exceeds engine max_seq_len")
        # the prompt prefill is the first choice point
        head, head_pos, _ = self._prefill_head_chunks(
            prompt_ids, 0, sampling, penalties, bias_ids, bias_vals, skind)
        tok, aux = dispatch(head, head_pos, build_mask(),
                            self._prefill_bucket(len(head)))
        cur_len = plen  # tokens whose KV is in the cache

        def extend(pending, mask):
            """Write the KV of ``pending`` and sample under ``mask``."""
            nonlocal cur_len
            out = dispatch(pending, cur_len, mask,
                           _bucket(len(pending), self.EXTEND_BUCKETS))
            cur_len += len(pending)
            return out

        while True:
            if tok in stop_set:
                finish = "stop"
                break
            tstr = masker.token_strs[tok] if tok < masker.vocab_size else None
            unconstrained = getattr(machine, "is_unconstrained", lambda: False)()
            if tstr is None and unconstrained:
                # an undecodable (partial UTF-8) token in a freeform phase:
                # emitted without advancing the character machine
                emit_sampled(tok, aux)
                if len(out_tokens) >= max_completion_tokens:
                    break
                if cur_len + 1 >= self.core.max_seq_len:
                    break
                tok, aux = extend([tok], build_mask())
                continue
            if tstr is None or not machine.advance(tstr):
                logger.warning("constrained decoding: token %d (%r) rejected by "
                               "the machine", tok, tstr)
                finish = "error: constrained decoding produced invalid token"
                break
            emit_sampled(tok, aux)
            if machine.is_complete:
                finish = "stop"
                break
            if len(out_tokens) >= max_completion_tokens:
                break
            if cur_len + 1 >= self.core.max_seq_len:
                break

            # forced fast path: the machine fixes a run of characters; its
            # greedy tokenization is emitted here and its KV rides along in
            # the next extend
            pending = [tok]
            forced = forced_run(machine)
            if forced:
                budget = min(max_completion_tokens - len(out_tokens),
                             self.core.max_seq_len - cur_len - len(pending))
                for fid in masker.encode_longest(forced)[:budget]:
                    if not machine.advance(masker.token_strs[fid]):
                        # a token whose multi-character advance the machine
                        # rejects: drop it and resume at the choice point
                        break
                    out_tokens.append(fid)
                    if logprobs:
                        out_logprobs.append(TokenLogprob(fid, 0.0, []))
                    pending.append(fid)
                    if machine.is_complete:
                        finish = "stop"
                        break
            if finish == "stop":
                break
            mask = build_mask()
            if len(out_tokens) >= max_completion_tokens:
                break
            if cur_len + len(pending) >= self.core.max_seq_len:
                break
            tok, aux = extend(pending, mask)

        if self.prompt_cache is not None:
            self.prompt_cache.update(prompt_ids + out_tokens[:cur_len - plen])
        return self._result(prompt_ids, out_tokens, out_logprobs, finish,
                            logprobs), masked_text(masker, out_tokens)

    def _result(self, prompt_ids, out_tokens, out_logprobs, finish, logprobs):
        return GenerationResult(
            token_ids=out_tokens,
            finish_reason=finish,
            prompt_tokens=len(prompt_ids),
            completion_tokens=len(out_tokens),
            logprobs=out_logprobs if logprobs else None,
        )


# ---------------------------------------------------------------------------
# chat-level API
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChatDelta:
    """One streamed chat event."""

    text: str = ""
    logprob: Optional[TokenLogprob] = None


def _chat_run(
    engine: "InferenceEngine",
    interactions,
    tools=None,
    response_format=None,
    tool_choice="auto",
    parallel_tool_calls: bool = False,
    stop=None,
    max_completion_tokens: int = 1024,
    logprobs: bool = False,
    reasoning: bool = False,
    **sampling_kwargs,
):
    """Generator: yields ChatDelta, returns the assistant Interaction."""
    from pie_tpu_torch.engine.text import (
        IncrementalDecoder,
        StopSequenceMatcher,
        parse_tool_calls,
    )
    from pie_tpu_torch.interaction import Content, Interaction, InteractionRole
    from pie_tpu_torch.structured import RootStateMachine

    tok = engine.tokenizer
    if tok is None:
        raise InferenceError("chat API requires a tokenizer")
    # images attached to the messages, in message order: preprocessed on
    # the host, each expanded into a placeholder run the prefill scatters
    # the vision tower's features over
    sources = []
    for it in interactions:
        sources.extend((it.get("images") if isinstance(it, dict) else it.images) or [])
    image_token_id, tokens_per_image, image = None, 0, {}
    if sources:
        proc = getattr(engine, "image_processor", None)
        cfg = engine.model.config
        image_token_id = getattr(cfg, "image_token_id", None)
        if proc is None or image_token_id is None:
            raise InferenceError("image inputs need a model with a vision tower")
        try:
            pixels = proc.batch(sources)
        except Exception as e:
            raise InferenceError(f"unreadable image: {e}") from e
        if getattr(proc, "returns_grid", False):  # Qwen2-VL: patches and their grid
            pixels, grid = pixels
            image = {"pixel_values": pixels, "image_kwargs": {"grid_thw": grid}}
            tokens_per_image = proc.tokens_per_image
        else:  # Gemma-3: square images, mm_tokens_per_image placeholders each
            image = {"pixel_values": pixels}
            tokens_per_image = cfg.mm_tokens_per_image

    prompt_ids = tok.apply_chat_template(
        interactions, add_generation_prompt=True, tools=tools,
        image_token_id=image_token_id, tokens_per_image=tokens_per_image,
    )

    # structured generation: the request may pin the output shape
    root = RootStateMachine(tok.control_tokens)
    st = root.configure(
        response_format=response_format,
        tools=tools,
        tool_choice=tool_choice,
        parallel_tool_calls=parallel_tool_calls,
        stop=[stop] if isinstance(stop, str) else (stop or []),
        reasoning=reasoning,
    )
    if st.machine is not None:
        if image:
            raise InferenceError("constrained decoding on an image prompt is not "
                                 "supported")
        merged = dict(sampling_kwargs)
        merged.update(st.generation_kwargs)
        if st.state_kwargs:
            merged["state_kwargs"] = st.state_kwargs
        result, text = engine.generate_constrained(
            prompt_ids, st.machine, max_completion_tokens, **merged
        )
        yield ChatDelta(text=text)
        reasoning_content, visible = RootStateMachine.split_reasoning(st, text)
        label, value = RootStateMachine.labeled_output(st, text)
        content = []
        finish = result.finish_reason
        if label == "tool_calls":
            for c in value:
                content.append(Content.tool_call_content(c["name"], c["arguments"]))
            finish = "tool_calls"
        else:
            content.append(Content.text_content(visible))
            if finish.startswith("error"):
                finish = "stop"
        return Interaction(
            role=InteractionRole.ASSISTANT,
            content=content,
            metadata={
                "finish_reason": finish,
                "prompt_tokens": result.prompt_tokens,
                "completion_tokens": result.completion_tokens,
                "logprobs": None,
                "token_ids": result.token_ids,
                "reasoning_content": reasoning_content,
            },
        )
    stop_strings = [stop] if isinstance(stop, str) else list(stop or [])
    dec = IncrementalDecoder(tok)
    matcher = StopSequenceMatcher(stop_strings)

    gen = engine.generate_stream(
        prompt_ids,
        max_completion_tokens=max_completion_tokens,
        stop_token_ids=tok.stop_tokens,
        logprobs=logprobs,
        **image,
        **sampling_kwargs,
    )
    result = None
    lps = []
    while True:
        try:
            st = next(gen)
        except StopIteration as e:
            result = e.value
            break
        if st.token_id in tok.stop_tokens:
            continue  # don't surface control tokens as text
        piece = dec.push(st.token_id)
        if st.logprob:
            lps.append(st.logprob)
        out = matcher.push(piece)
        if out or st.logprob:
            yield ChatDelta(text=out, logprob=st.logprob)
        if matcher.stopped:
            gen.close()
            result = GenerationResult(
                token_ids=[], finish_reason="stop",
                prompt_tokens=len(prompt_ids), completion_tokens=0,
            )
            # approximate usage from what was actually produced
            result.completion_tokens = len(dec.ids)
            break

    text = dec.text
    if stop_strings:
        for s in stop_strings:
            i = text.find(s)
            if i != -1:
                text = text[:i]
                break
    finish = result.finish_reason
    content = []
    tool_calls = parse_tool_calls(text) if tools else None
    if tool_calls:
        for c in tool_calls:
            content.append(Content.tool_call_content(c["name"], c["arguments"]))
        finish = "tool_calls"
    else:
        content.append(Content.text_content(text))
    return Interaction(
        role=InteractionRole.ASSISTANT,
        content=content,
        metadata={
            "finish_reason": finish,
            "prompt_tokens": result.prompt_tokens,
            "completion_tokens": result.completion_tokens,
            "logprobs": lps if logprobs else None,
            "token_ids": result.token_ids,
        },
    )


def _chat(engine, interactions, **kw):
    gen = _chat_run(engine, interactions, **kw)
    while True:
        try:
            next(gen)
        except StopIteration as e:
            return e.value


InferenceEngine.chat_stream = _chat_run
InferenceEngine.chat = _chat
