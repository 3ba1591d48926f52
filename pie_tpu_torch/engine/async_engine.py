"""Batching engine service: a background scheduler thread and per-request
streaming, with the generate / chat surface of InferenceEngine, so the
server can serve many concurrent requests with continuous batching.

Port of the JAX package's ``pie_tpu/engine/async_engine.py`` with its
Python scheduler. Requests from any thread go through a thread-safe queue
into the shared ``Scheduler``; tokens stream back per request; a checkpoint
(``model_path``) loads through ``models/loader.py``; a constrained request
(``generate_constrained``, a structured chat) carries its machine into the
scheduler, which decodes it beside the other lanes. Only the scheduler
thread touches CUDA: it runs every device program, so the step graphs are
captured there (a request thread only queues and reads host objects, and
``capture_error_mode="thread_local"`` would let it touch CUDA anyway). An
image request (``pixel_values``, with ``image_kwargs={"grid_thw": ...}`` for
Qwen2-VL, or images attached to chat messages) computes a Qwen2-VL
prompt's M-RoPE streams and decode offset on the request thread (host
arrays); the scheduler thread runs the vision tower (Qwen2-VL's or
Gemma-3's SigLIP) before it queues the sequence, whose embeddings then
prefill as rider slices beside the other lanes.

``scheduler_impl="native"`` runs the C++ host runtime instead
(``runtime/native_scheduler.py``: admission, page tables and stop checks in
``native/``, one decode step per token over ``PagedEngine``'s native
programs), on the same scheduler thread (``_native_loop``). As in the JAX
package it serves text requests, constrained ones included, and refuses
image prompts and logit bias with an error finish; it also refuses XTC and
DRY, which its C ABI cannot carry (the JAX package drops them silently).
"""

from __future__ import annotations

import functools
import logging
import queue
import threading
import time
from typing import Iterator, Optional, Sequence as Seq

import torch

from pie_tpu_torch.engine.engine import (
    GenerationResult,
    InferenceError,
    StreamedToken,
    _chat_run,
    masked_text,
    tower_kwargs,
)
from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler, SeqStatus, Sequence
from pie_tpu_torch.utils import profiling
from pie_tpu_torch.utils.device import resolve_device
from pie_tpu_torch.utils.metrics import get_metrics

logger = logging.getLogger(__name__)

_SENTINEL = object()


class BatchedInferenceEngine:
    """Engine with continuous batching underneath: the public surface of
    InferenceEngine (generate / generate_stream / chat / chat_stream),
    safe for concurrent callers, whose requests decode together."""

    def __init__(
        self,
        model=None,
        params=None,
        tokenizer=None,
        model_path: Optional[str] = None,
        num_lanes: int = 8,
        num_pages: int = 1024,
        max_pages_per_seq: int = 64,
        prefill_chunk: int = 256,
        kv_dtype=torch.bfloat16,
        kv_quantized: bool = False,
        decode_steps: int = 8,
        seed: int = 0,
        scheduler_impl: str = "python",
        device="cuda",
    ):
        self.device = resolve_device(device)
        if scheduler_impl not in ("python", "native"):
            raise ValueError(f"scheduler_impl={scheduler_impl!r}: 'python' or 'native'")
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
        from pie_tpu_torch.vision.utils import make_image_processor

        self.image_processor = make_image_processor(model)
        self.core = PagedEngine(
            model, params, num_lanes=num_lanes, num_pages=num_pages,
            max_pages_per_seq=max_pages_per_seq, prefill_chunk=prefill_chunk,
            kv_dtype=kv_dtype, kv_quantized=kv_quantized, seed=seed,
            device=self.device,
        )
        self.scheduler_impl = scheduler_impl
        if scheduler_impl == "native":
            from pie_tpu_torch.runtime.native_scheduler import NativeScheduler

            self.scheduler = NativeScheduler(self.core)
        else:
            self.scheduler = Scheduler(self.core, decode_steps=decode_steps)
        self._submit_q: queue.Queue = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start_lock = threading.Lock()
        self._id_lock = threading.Lock()
        self._id_counter = 0

    # -- lifecycle -------------------------------------------------------

    def start(self):
        with self._start_lock:
            if self._thread is not None:
                return
            loop = self._native_loop if self.scheduler_impl == "native" else self._loop
            self._thread = threading.Thread(target=loop, name="pie-scheduler",
                                            daemon=True)
            self._thread.start()

    def shutdown(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self):
        sched = self.scheduler
        while not self._stop.is_set():
            try:
                while True:
                    seq = self._submit_q.get_nowait()
                    if seq.image_inputs is None or self._embed_images(seq):
                        sched.waiting.append(seq)
            except queue.Empty:
                pass
            if not sched.has_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                sched.step()
            except Exception:
                logger.exception("scheduler step failed")
                # fail every sequence, freeing its lane and pages, so its
                # caller unblocks and the engine goes on serving
                sched._inflight.clear()
                sched._chained = False
                for seq in list(sched.running.values()) + list(sched.waiting):
                    sched._finish(seq, "error: scheduler failure")
                sched.waiting.clear()

    def _native_loop(self):
        """The scheduler thread over the C++ host runtime: admission, the
        sequence lifecycle, page tables and stop checks run in native code;
        this thread runs the device programs and bridges each request's
        tokens and finish to its ``Sequence``."""
        sched = self.scheduler
        live: list = []  # (NativeRequest, Sequence) pairs in flight

        def refuse(seq: Sequence, reason: str) -> None:
            seq.finish_reason = f"error: {reason}"
            if seq.on_finish:
                seq.on_finish(seq)

        while not self._stop.is_set():
            try:
                while True:
                    seq = self._submit_q.get_nowait()
                    if seq.image_inputs is not None or seq.logit_bias:
                        refuse(seq, "the native scheduler serves text requests "
                               "only (use scheduler_impl='python' for images or "
                               "logit bias)")
                        continue
                    if seq.xtc_probability > 0.0 or seq.dry_multiplier > 0.0:
                        refuse(seq, "the native scheduler has no XTC or DRY (its C "
                               "ABI carries neither; use scheduler_impl='python')")
                        continue
                    req = sched.add_request(
                        seq.prompt_ids, max_new_tokens=seq.max_new_tokens,
                        stop_token_ids=seq.stop_token_ids,
                        temperature=seq.temperature, top_p=seq.top_p,
                        min_p=seq.min_p, top_k=seq.top_k,
                        repetition_penalty=seq.repetition_penalty,
                        presence_penalty=seq.presence_penalty,
                        frequency_penalty=seq.frequency_penalty,
                        machine=seq.machine, masker=seq.masker,
                        state_kwargs=seq.state_kwargs,
                    )
                    req.on_token = functools.partial(_native_token, seq)
                    req.on_finish = functools.partial(_native_finish, seq)
                    live.append((req, seq))
            except queue.Empty:
                pass
            for req, seq in live:
                if seq.cancelled and not req.done:
                    sched.cancel(req)
            live = [(r, s) for r, s in live if not r.done]
            if not sched.has_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                sched.step()
            except Exception:
                logger.exception("native scheduler step failed")
                # finish every sequence in the core (freeing its lane and
                # pages) so that its caller unblocks and the engine serves on
                for req, seq in live:
                    sched.core.finish_external(req.seq_id, 3)  # as cancelled
                    sched.core.release(req.seq_id)
                    sched.requests.pop(req.seq_id, None)
                    refuse(seq, "scheduler failure")
                live.clear()
                sched.core.pop_finished(cap=max(64, sched.core.num_lanes * 8))

    def _embed_images(self, seq: Sequence) -> bool:
        """On the scheduler thread: run the vision tower over a sequence's
        pixel inputs, eagerly, and keep the prompt's embeddings [plen, D]
        on the device for its rider slices. False (and the sequence
        finished with an error) when the tower fails."""
        pixels, kw = seq.image_inputs
        seq.image_inputs = None
        try:
            ids = torch.as_tensor(seq.prompt_ids, dtype=torch.int32,
                                  device=self.device)[None]
            with torch.no_grad():
                seq.prompt_embeds = self.model.embed_with_images(
                    self.params, ids, torch.as_tensor(pixels).to(self.device), **kw)[0]
        except Exception as e:
            logger.exception("vision tower failed")
            self.scheduler._finish(seq, f"error: image inputs: {e}")
            return False
        return True

    # -- request path ----------------------------------------------------

    def _next_id(self) -> int:
        with self._id_lock:
            self._id_counter += 1
            return self._id_counter

    def generate_stream(
        self,
        prompt_ids: Seq[int],
        max_completion_tokens: int = 256,
        stop_token_ids: Seq[int] = (),
        logprobs: bool = False,
        pixel_values=None,
        image_kwargs=None,
        **kwargs,
    ) -> Iterator[StreamedToken]:
        """Same contract as InferenceEngine.generate_stream (StopIteration
        value = GenerationResult). Logprobs are not reported on the batched
        path, as in the JAX package. ``pixel_values`` with
        ``image_kwargs={"grid_thw": ...}``: an image prompt (module
        docstring)."""
        if not prompt_ids:
            raise InferenceError("empty prompt")
        image = None
        if pixel_values is not None:
            image = self._image_request(prompt_ids, pixel_values, image_kwargs)
        self.start()
        out_q: queue.Queue = queue.Queue()
        seq = Sequence(
            seq_id=self._next_id(),
            prompt_ids=list(prompt_ids),
            max_new_tokens=max_completion_tokens,
            stop_token_ids=tuple(stop_token_ids),
            temperature=float(kwargs.get("temperature", 1.0)),
            top_p=float(kwargs.get("top_p", 1.0)),
            min_p=float(kwargs.get("min_p", 0.0)),
            top_k=int(kwargs.get("top_k", -1)),
            repetition_penalty=float(kwargs.get("repetition_penalty", 1.0)),
            presence_penalty=float(kwargs.get("presence_penalty", 0.0)),
            frequency_penalty=float(kwargs.get("frequency_penalty", 0.0)),
            logit_bias=dict(kwargs.get("logit_bias") or {}),
        )
        if image is not None:
            seq.image_inputs, seq.positions3, seq.pos_delta = image
        if self.scheduler_impl == "native":
            # carried so that the native loop can refuse them
            seq.xtc_probability = float(kwargs.get("xtc_probability", 0.0))
            seq.dry_multiplier = float(kwargs.get("dry_multiplier", 0.0))
        seq.on_token = lambda s, t: out_q.put(t)

        def on_finish(s):
            out_q.put(_SENTINEL)
            _observe(s)

        seq.on_finish = on_finish
        self._submit(seq)
        try:
            while True:
                tok = out_q.get()
                if tok is _SENTINEL:
                    break
                yield StreamedToken(int(tok))
        except GeneratorExit:
            seq.cancelled = True
            raise
        if seq.finish_reason and seq.finish_reason.startswith("error"):
            raise InferenceError(seq.finish_reason)
        return GenerationResult(
            token_ids=list(seq.output_ids),
            finish_reason=seq.finish_reason or "length",
            prompt_tokens=len(seq.prompt_ids),
            completion_tokens=len(seq.output_ids),
        )

    def _submit(self, seq: Sequence) -> None:
        """Stamp a request, register it with the tracer (while one records)
        and queue it for the scheduler thread."""
        seq.t_submit = time.perf_counter_ns()
        profiling.request(seq)
        self._submit_q.put(seq)
        self._wake.set()

    def _image_request(self, prompt_ids, pixel_values, image_kwargs) -> tuple:
        """((pixel_values, the tower's keyword arguments), positions3
        [3, plen], pos_delta) of an image request, on the host: a Qwen2-VL
        one carries its grid, streams and offset; a Gemma-3 one none."""
        kw = tower_kwargs(self.model, image_kwargs)
        if not kw:
            return (pixel_values, kw), None, 0
        from pie_tpu_torch.models.qwen2_vl import image_positions

        p3, delta = image_positions(self.model, [list(prompt_ids)], kw["grid_thw"],
                                    len(prompt_ids))
        return (pixel_values, kw), p3[:, 0], delta

    def generate(self, prompt_ids, **kw) -> GenerationResult:
        gen = self.generate_stream(prompt_ids, **kw)
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value

    # -- constrained decoding (structured generation) --------------------

    _token_masker = None

    @property
    def token_masker(self):
        """The vocabulary index for constrained decoding, built at first use."""
        if self._token_masker is None:
            from pie_tpu_torch.structured.token_masks import TokenMasker

            if self.tokenizer is None:
                raise InferenceError("constrained decoding requires a tokenizer")
            self._token_masker = TokenMasker(self.tokenizer)
        return self._token_masker

    def generate_constrained(
        self,
        prompt_ids,
        machine,
        max_completion_tokens: int = 1024,
        stop_token_ids=(),
        logprobs: bool = False,
        **kwargs,
    ):
        """Constrained generation under continuous batching: the sequence
        carries its character machine into the scheduler, which masks its
        choice points chunk by chunk and sends forced-token runs through
        the prefill rider (``Scheduler._emit_constrained``), while the
        other lanes go on decoding. Returns (GenerationResult, text), as
        ``InferenceEngine.generate_constrained``; ``logprobs`` is accepted
        and not reported on the batched path."""
        if not prompt_ids:
            raise InferenceError("empty prompt")
        state_kwargs = kwargs.pop("state_kwargs", None) or {}
        masker = self.token_masker
        self.start()
        done = threading.Event()
        seq = Sequence(
            seq_id=self._next_id(),
            prompt_ids=list(prompt_ids),
            max_new_tokens=max_completion_tokens,
            stop_token_ids=tuple(stop_token_ids),
            temperature=float(kwargs.get("temperature", 1.0)),
            top_p=float(kwargs.get("top_p", 1.0)),
            min_p=float(kwargs.get("min_p", 0.0)),
            top_k=int(kwargs.get("top_k", -1)),
            repetition_penalty=float(kwargs.get("repetition_penalty", 1.0)),
            presence_penalty=float(kwargs.get("presence_penalty", 0.0)),
            frequency_penalty=float(kwargs.get("frequency_penalty", 0.0)),
            logit_bias=dict(kwargs.get("logit_bias") or {}),
            machine=machine.copy(),
            masker=masker,
            state_kwargs=state_kwargs,
        )

        def on_finish(s):
            done.set()
            _observe(s)

        seq.on_finish = on_finish
        self._submit(seq)
        done.wait()
        finish = seq.finish_reason or "length"
        if finish.startswith("error") and "constrained" not in finish:
            raise InferenceError(finish)
        return GenerationResult(
            token_ids=list(seq.output_ids),
            finish_reason=finish,
            prompt_tokens=len(seq.prompt_ids),
            completion_tokens=len(seq.output_ids),
        ), masked_text(masker, seq.output_ids)

    # chat surface shared with InferenceEngine
    def chat_stream(self, interactions, **kw):
        return _chat_run(self, interactions, **kw)

    def chat(self, interactions, **kw):
        gen = _chat_run(self, interactions, **kw)
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value


def _observe(seq: Sequence) -> None:
    """A finished request's queue wait (submit to lane) and time to its
    first token, from its stamps, into the serving metrics."""
    m = get_metrics()
    if seq.t_admit:
        m.observe_queue_wait((seq.t_admit - seq.t_submit) / 1e9)
    if seq.t_first:
        m.observe_ttft((seq.t_first - seq.t_submit) / 1e9)


def _native_token(seq: Sequence, req, tok: int) -> None:
    """A native request's token, handed to its ``Sequence``."""
    if not seq.output_ids:
        seq.t_first = time.perf_counter_ns()
    seq.output_ids.append(int(tok))
    if seq.on_token:
        try:
            seq.on_token(seq, int(tok))
        except Exception:  # pragma: no cover
            logger.exception("on_token callback failed")


def _native_finish(seq: Sequence, req) -> None:
    """A native request's finish, handed to its ``Sequence``."""
    seq.finish_reason = req.finish_reason or "stop"
    seq.status = SeqStatus.COMPLETED
    if seq.on_finish:
        try:
            seq.on_finish(seq)
        except Exception:  # pragma: no cover
            logger.exception("on_finish callback failed")
