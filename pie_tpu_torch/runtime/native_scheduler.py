"""The native C++ continuous-batching scheduler, bound through ctypes, and
its Python loop over the port's device programs.

Port of the JAX package's ``pie_tpu/runtime/native_scheduler.py``. The host
side of serving (admission, the sequence lifecycle, page tables,
chunked-prefill cursors, per-sequence sampling and penalty parameters,
penalty histories, stop checks) runs in ``native/src/scheduler.cpp``,
built by ``runtime/native.py``; Python moves the core's lane arrays to the
device and runs ``PagedEngine``'s three native programs, each a captured
graph on the card: ``_prefill_logits`` per staged prompt chunk,
``_sample_first`` for a prompt's first token, and ``_decode`` for one
batched step. A step reads the device once, for the step's [B] tokens
(plus one token for each prompt whose prefill it finished).

Every array handed to C is a contiguous numpy buffer the core owns.
Constrained requests follow the JAX design: the loop is per token, so each
token of a constrained lane is sampled under its machine's mask, built on
the host, and the first token after the prefill under the same mask.
XTC and DRY have no fields in the C ABI; ``BatchedInferenceEngine``
refuses such requests on this path (the JAX package drops them).
"""

from __future__ import annotations

import ctypes
import logging
from typing import Callable, Optional

import numpy as np

from pie_tpu_torch.runtime.native import load

logger = logging.getLogger(__name__)

_FINISH_REASONS = {
    0: None,
    1: "stop",
    2: "length",
    3: "cancelled",
    4: "error: out of pages",
    5: "error: constrained decoding produced invalid token",
}


def _bind_scheduler(lib) -> None:
    """The scheduler's C prototypes (``native/src/capi_scheduler.cpp``)."""
    c = ctypes
    p_i32 = c.POINTER(c.c_int32)
    p_u8 = c.POINTER(c.c_uint8)
    p_u32 = c.POINTER(c.c_uint32)
    p_u64 = c.POINTER(c.c_uint64)
    p_f32 = c.POINTER(c.c_float)
    lib.pie_sched_create.restype = c.c_void_p
    lib.pie_sched_create.argtypes = [c.c_uint32] * 5
    lib.pie_sched_destroy.argtypes = [c.c_void_p]
    lib.pie_sched_submit.restype = c.c_uint64
    lib.pie_sched_submit.argtypes = [
        c.c_void_p, p_i32, c.c_uint32, c.c_uint32, p_i32, c.c_uint32,
        c.c_float, c.c_float, c.c_float, c.c_int32, c.c_float, c.c_float,
        c.c_float, c.c_uint64,
    ]
    lib.pie_sched_cancel.restype = c.c_int32
    lib.pie_sched_cancel.argtypes = [c.c_void_p, c.c_uint64]
    lib.pie_sched_finish_external.restype = c.c_int32
    lib.pie_sched_finish_external.argtypes = [c.c_void_p, c.c_uint64, c.c_uint8]
    lib.pie_sched_begin_step.restype = c.c_uint32
    lib.pie_sched_begin_step.argtypes = [c.c_void_p]
    lib.pie_sched_next_prefill.restype = c.c_int32
    lib.pie_sched_next_prefill.argtypes = [
        c.c_void_p, p_u32, p_u64, p_i32, p_u32, p_u32, p_u32, p_u8,
    ]
    lib.pie_sched_commit_first.argtypes = [c.c_void_p, c.c_uint32, c.c_int32]
    lib.pie_sched_decode_view.restype = c.c_uint32
    lib.pie_sched_decode_view.argtypes = [
        c.c_void_p, p_i32, p_i32, p_i32, p_u8, p_i32, p_f32, p_f32, p_f32,
        p_i32, p_f32, p_f32, p_f32,
    ]
    lib.pie_sched_commit_decode.argtypes = [c.c_void_p, p_i32]
    lib.pie_sched_pop_finished.restype = c.c_uint32
    lib.pie_sched_pop_finished.argtypes = [c.c_void_p, p_u64, p_u8, c.c_uint32]
    lib.pie_sched_seq_output.restype = c.c_uint32
    lib.pie_sched_seq_output.argtypes = [c.c_void_p, c.c_uint64, p_i32, c.c_uint32]
    lib.pie_sched_release.argtypes = [c.c_void_p, c.c_uint64]
    lib.pie_sched_has_work.restype = c.c_int32
    lib.pie_sched_has_work.argtypes = [c.c_void_p]
    lib.pie_sched_num_waiting.restype = c.c_uint32
    lib.pie_sched_num_waiting.argtypes = [c.c_void_p]
    lib.pie_sched_num_running.restype = c.c_uint32
    lib.pie_sched_num_running.argtypes = [c.c_void_p]
    lib.pie_sched_num_free_pages.restype = c.c_uint32
    lib.pie_sched_num_free_pages.argtypes = [c.c_void_p]
    lib.pie_sched_lane_seqs.argtypes = [c.c_void_p, p_u64]
    for void in (lib.pie_sched_destroy, lib.pie_sched_commit_first,
                 lib.pie_sched_commit_decode, lib.pie_sched_release,
                 lib.pie_sched_lane_seqs):
        void.restype = None


def _ptr(arr: np.ndarray, ctype):
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("the C ABI takes contiguous arrays")
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeSchedulerCore:
    """Thin, array-oriented binding over the C ABI. ``decode_view`` fills
    the lane arrays below (the core's own contiguous buffers) in place."""

    def __init__(self, num_lanes: int, num_pages: int, max_pages_per_seq: int,
                 prefill_chunk: int, history_len: int):
        lib = load()
        _bind_scheduler(lib)
        self._lib = lib
        self._h = ctypes.c_void_p(lib.pie_sched_create(
            num_lanes, num_pages, max_pages_per_seq, prefill_chunk, history_len))
        if not self._h:
            raise MemoryError("failed to create the native scheduler")
        self.num_lanes = num_lanes
        self.max_pages_per_seq = max_pages_per_seq
        self.prefill_chunk = prefill_chunk
        self.history_len = history_len
        b = num_lanes
        self.last_tokens = np.zeros((b,), np.int32)
        self.context_lens = np.zeros((b,), np.int32)
        self.block_tables = np.zeros((b, max_pages_per_seq), np.int32)
        self.active = np.zeros((b,), np.uint8)
        self.histories = np.zeros((b, history_len), np.int32)
        self.temperature = np.zeros((b,), np.float32)
        self.top_p = np.zeros((b,), np.float32)
        self.min_p = np.zeros((b,), np.float32)
        self.top_k = np.zeros((b,), np.int32)
        self.rep_pen = np.zeros((b,), np.float32)
        self.presence = np.zeros((b,), np.float32)
        self.frequency = np.zeros((b,), np.float32)
        self._chunk_ids = np.zeros((prefill_chunk,), np.int32)
        self._lane_seqs = np.zeros((b,), np.uint64)

    def submit(self, prompt_ids, max_new_tokens: int = 256, stop_token_ids=(),
               temperature: float = 1.0, top_p: float = 1.0, min_p: float = 0.0,
               top_k: int = -1, repetition_penalty: float = 1.0,
               presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
               rng_seed: int = 0) -> int:
        prompt = np.ascontiguousarray(prompt_ids, np.int32)
        stops = np.ascontiguousarray(list(stop_token_ids), np.int32)
        return int(self._lib.pie_sched_submit(
            self._h, _ptr(prompt, ctypes.c_int32), len(prompt), max_new_tokens,
            _ptr(stops, ctypes.c_int32), len(stops), temperature, top_p, min_p,
            top_k, repetition_penalty, presence_penalty, frequency_penalty,
            rng_seed))

    def cancel(self, seq_id: int) -> bool:
        return self._lib.pie_sched_cancel(self._h, seq_id) == 0

    def finish_external(self, seq_id: int, reason: int) -> bool:
        """Finish a live sequence from Python (1 = STOP for a completed
        machine, 5 = MACHINE_ERROR); a no-op if it already finished."""
        return self._lib.pie_sched_finish_external(self._h, seq_id, reason) == 0

    def begin_step(self) -> int:
        return int(self._lib.pie_sched_begin_step(self._h))

    def next_prefill(self):
        """(lane, seq_id, ids, start_pos, context_len, is_last), or None when
        this step's staged chunks are drained."""
        lane = ctypes.c_uint32()
        seq_id = ctypes.c_uint64()
        n = ctypes.c_uint32()
        start = ctypes.c_uint32()
        ctx = ctypes.c_uint32()
        last = ctypes.c_uint8()
        ok = self._lib.pie_sched_next_prefill(
            self._h, ctypes.byref(lane), ctypes.byref(seq_id),
            _ptr(self._chunk_ids, ctypes.c_int32), ctypes.byref(n),
            ctypes.byref(start), ctypes.byref(ctx), ctypes.byref(last))
        if not ok:
            return None
        return (lane.value, seq_id.value, self._chunk_ids[:n.value].copy(),
                start.value, ctx.value, bool(last.value))

    def commit_first(self, lane: int, token: int) -> None:
        self._lib.pie_sched_commit_first(self._h, lane, token)

    def decode_view(self) -> int:
        """Refresh the lane arrays; returns the number of decoding lanes."""
        return int(self._lib.pie_sched_decode_view(
            self._h,
            _ptr(self.last_tokens, ctypes.c_int32),
            _ptr(self.context_lens, ctypes.c_int32),
            _ptr(self.block_tables, ctypes.c_int32),
            _ptr(self.active, ctypes.c_uint8),
            _ptr(self.histories, ctypes.c_int32),
            _ptr(self.temperature, ctypes.c_float),
            _ptr(self.top_p, ctypes.c_float),
            _ptr(self.min_p, ctypes.c_float),
            _ptr(self.top_k, ctypes.c_int32),
            _ptr(self.rep_pen, ctypes.c_float),
            _ptr(self.presence, ctypes.c_float),
            _ptr(self.frequency, ctypes.c_float),
        ))

    def commit_decode(self, tokens: np.ndarray) -> None:
        t = np.ascontiguousarray(tokens, np.int32)
        self._lib.pie_sched_commit_decode(self._h, _ptr(t, ctypes.c_int32))

    def pop_finished(self, cap: int = 64) -> list[tuple[int, Optional[str]]]:
        ids = np.zeros((cap,), np.uint64)
        reasons = np.zeros((cap,), np.uint8)
        n = self._lib.pie_sched_pop_finished(
            self._h, _ptr(ids, ctypes.c_uint64), _ptr(reasons, ctypes.c_uint8), cap)
        return [(int(ids[i]), _FINISH_REASONS[int(reasons[i])]) for i in range(n)]

    def seq_output(self, seq_id: int, cap: int = 4096) -> list[int]:
        out = np.zeros((cap,), np.int32)
        n = self._lib.pie_sched_seq_output(self._h, seq_id,
                                           _ptr(out, ctypes.c_int32), cap)
        if n == 0xFFFFFFFF:
            raise KeyError(f"unknown seq {seq_id}")
        return out[:min(n, cap)].tolist()

    def release(self, seq_id: int) -> None:
        self._lib.pie_sched_release(self._h, seq_id)

    def lane_seqs(self) -> np.ndarray:
        """Each lane's sequence id (0 for a free lane)."""
        self._lib.pie_sched_lane_seqs(self._h, _ptr(self._lane_seqs, ctypes.c_uint64))
        return self._lane_seqs.copy()

    @property
    def has_work(self) -> bool:
        return bool(self._lib.pie_sched_has_work(self._h))

    @property
    def num_waiting(self) -> int:
        return int(self._lib.pie_sched_num_waiting(self._h))

    @property
    def num_running(self) -> int:
        return int(self._lib.pie_sched_num_running(self._h))

    @property
    def num_free_pages(self) -> int:
        return int(self._lib.pie_sched_num_free_pages(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pie_sched_destroy(h)
            self._h = None


class NativeRequest:
    """Handle of one request submitted to the NativeScheduler."""

    __slots__ = ("seq_id", "output_ids", "finish_reason", "on_token",
                 "on_finish", "done", "machine", "masker", "state_kwargs",
                 "base_sampling")

    def __init__(self, seq_id: int):
        self.seq_id = seq_id
        self.output_ids: list[int] = []
        self.finish_reason: Optional[str] = None
        self.on_token: Optional[Callable[["NativeRequest", int], None]] = None
        self.on_finish: Optional[Callable[["NativeRequest"], None]] = None
        self.done = False
        # constrained decoding: the character machine, the vocabulary
        # masker, per-phase sampler overrides and the request's own sampling
        self.machine = None
        self.masker = None
        self.state_kwargs: dict = {}
        self.base_sampling: tuple = (1.0, 1.0, 0.0, -1)


class NativeScheduler:
    """Continuous batching with the native C++ host runtime over a
    ``PagedEngine``'s native programs: a peer of the Python ``Scheduler``
    whose per-step bookkeeping runs in C++. ``token_sink`` /
    ``finish_sink`` receive the tokens and finishes of sequences submitted
    over IPC (not through ``add_request``)."""

    def __init__(self, engine, num_pages: Optional[int] = None):
        from pie_tpu_torch.engine.scheduler import HISTORY_LEN

        self.engine = engine
        self.core = NativeSchedulerCore(
            num_lanes=engine.num_lanes,
            num_pages=num_pages or engine.pool.num_pages,
            max_pages_per_seq=engine.max_pages_per_seq,
            prefill_chunk=engine.prefill_chunk,
            history_len=HISTORY_LEN,
        )
        self.requests: dict[int, NativeRequest] = {}
        self.token_sink: Optional[Callable[[int, int], None]] = None
        self.finish_sink: Optional[Callable[[int, Optional[str]], None]] = None
        self._vocab = engine.model.config.vocab_size

    # -- public API -------------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens: int = 256, stop_token_ids=(),
                    temperature: float = 1.0, top_p: float = 1.0,
                    min_p: float = 0.0, top_k: int = -1,
                    repetition_penalty: float = 1.0, presence_penalty: float = 0.0,
                    frequency_penalty: float = 0.0, machine=None, masker=None,
                    state_kwargs: Optional[dict] = None) -> NativeRequest:
        seq_id = self.core.submit(
            prompt_ids, max_new_tokens=max_new_tokens, stop_token_ids=stop_token_ids,
            temperature=temperature, top_p=top_p, min_p=min_p, top_k=top_k,
            repetition_penalty=repetition_penalty, presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty)
        req = NativeRequest(seq_id)
        req.machine = machine
        req.masker = masker
        req.state_kwargs = dict(state_kwargs or {})
        req.base_sampling = (temperature, top_p, min_p, top_k)
        self.requests[seq_id] = req
        return req

    def cancel(self, req: NativeRequest) -> None:
        self.core.cancel(req.seq_id)

    @property
    def has_work(self) -> bool:
        return self.core.has_work

    def run_to_completion(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
        raise RuntimeError("native scheduler did not drain")

    # -- one step ----------------------------------------------------------

    def step(self) -> list[NativeRequest]:
        """Admit, prefill the staged chunks (sampling the first token of
        each finished prompt), then one batched decode step over every
        decoding lane. Returns the requests that finished."""
        from pie_tpu_torch.ops.sampling import sampler_kind_for

        e, core = self.engine, self.core
        core.begin_step()
        core.decode_view()  # the prefilling lanes' tables and parameters
        while (chunk := core.next_prefill()) is not None:
            lane, seq_id, ids, start_pos, context_len, is_last = chunk
            n = len(ids)
            c = _bucket(n, core.prefill_chunk)
            ids_pad = np.zeros((1, c), np.int32)
            ids_pad[0, :n] = ids
            positions = np.full((1, c), -1, np.int32)
            positions[0, :n] = start_pos + np.arange(n)
            logits = e._prefill_logits(
                e.params, ids_pad, positions, core.block_tables[lane:lane + 1],
                np.array([context_len], np.int32), n - 1)
            if is_last:
                req = self.requests.get(seq_id)
                constrained = req is not None and req.machine is not None
                mask = self._mask_logits(req) if constrained else None
                tok = self._sample_first(lane, logits, mask)
                core.commit_first(lane, tok)
                self._emit(seq_id, tok)
                if constrained:
                    self._advance_machine(req, tok)

        if core.decode_view() > 0:
            act = core.active.astype(bool)
            lane_seq = core.lane_seqs()
            # constrained lanes: each token sampled under the host mask of
            # the machine's state, with its phase's sampler overrides
            con_lanes: dict[int, NativeRequest] = {}
            for lane in np.nonzero(act)[0]:
                r = self.requests.get(int(lane_seq[lane]))
                if r is not None and r.machine is not None:
                    con_lanes[int(lane)] = r
            mask = None
            if con_lanes:
                allowed = np.ones((len(act), self._vocab), bool)
                valid = np.zeros((len(act),), bool)
                for lane, r in con_lanes.items():
                    if r.state_kwargs and hasattr(r.machine, "active_names"):
                        kw: dict = {}
                        for name in sorted(r.machine.active_names()):
                            kw.update(r.state_kwargs.get(name, {}))
                        bt, bp, bm, bk = r.base_sampling
                        core.temperature[lane] = kw.get("temperature", bt)
                        core.top_p[lane] = kw.get("top_p", bp)
                        core.min_p[lane] = kw.get("min_p", bm)
                        core.top_k[lane] = kw.get("top_k", bk)
                    if getattr(r.machine, "is_unconstrained", lambda: False)():
                        continue
                    m = r.masker.build_mask(r.machine)
                    allowed[lane] = False
                    allowed[lane, :m.shape[0]] = m
                    valid[lane] = True
                mask = (allowed, valid)
            kind = sampler_kind_for(core.temperature[act], core.top_p[act],
                                    core.min_p[act], core.top_k[act])
            tokens, _ = e._decode(
                e.params, core.last_tokens, core.context_lens, core.block_tables,
                core.histories, self._sampling(slice(None)), self._penalties(slice(None)),
                core.active, kind, self._penalties_on(act), mask=mask)
            tokens = tokens.cpu().numpy()  # the step's one read of the device
            core.commit_decode(tokens)
            for lane in np.nonzero(act)[0]:
                self._emit(int(lane_seq[lane]), int(tokens[lane]))
            for lane, r in con_lanes.items():
                self._advance_machine(r, int(tokens[lane]))

        finished = []
        for seq_id, reason in core.pop_finished():
            req = self.requests.pop(seq_id, None)
            core.release(seq_id)
            if req is None:
                if self.finish_sink is not None:
                    self.finish_sink(seq_id, reason)
                continue
            req.finish_reason = reason
            req.done = True
            if req.on_finish:
                try:
                    req.on_finish(req)
                except Exception:  # pragma: no cover
                    logger.exception("on_finish callback failed")
            finished.append(req)
        return finished

    # -- helpers ------------------------------------------------------------

    def _sampling(self, s) -> dict:
        c = self.core
        return {"temperature": c.temperature[s], "top_p": c.top_p[s],
                "min_p": c.min_p[s], "top_k": c.top_k[s]}

    def _penalties(self, s) -> dict:
        c = self.core
        return {"repetition": c.rep_pen[s], "presence": c.presence[s],
                "frequency": c.frequency[s]}

    def _penalties_on(self, rows) -> bool:
        c = self.core
        return bool((c.rep_pen[rows] != 1.0).any() or (c.presence[rows] != 0.0).any()
                    or (c.frequency[rows] != 0.0).any())

    def _sample_first(self, lane: int, logits, mask: Optional[np.ndarray]) -> int:
        """Sample a just-prefilled lane's first token from the lane state the
        C++ core exposed through decode_view (its parameters and the prompt's
        tail as history); reads the token back."""
        from pie_tpu_torch.ops.sampling import sampler_kind_for

        c, s = self.core, slice(lane, lane + 1)
        kind = sampler_kind_for(c.temperature[s], c.top_p[s], c.min_p[s], c.top_k[s])
        tok = self.engine._sample_first(
            logits, self._sampling(s), self._penalties(s), c.histories[s], kind,
            self._penalties_on(s), mask=mask)
        return int(tok.cpu()[0])

    def _mask_logits(self, req: NativeRequest) -> Optional[np.ndarray]:
        """The request's token mask [V] for its first sampled token after
        the prefill (None in a freeform phase): the first-token program
        applies it to the prefill's logits."""
        machine = req.machine
        if getattr(machine, "is_unconstrained", lambda: False)():
            return None
        m = np.asarray(req.masker.build_mask(machine))
        row = np.zeros((self._vocab,), bool)
        row[:m.shape[0]] = m
        return row

    def _advance_machine(self, req: NativeRequest, tok: int) -> None:
        """Advance the request's character machine over an emitted token;
        finish the native sequence when the machine completes (STOP) or
        rejects the token (MACHINE_ERROR: only an undecodable token, or an
        inconsistency in a freeform phase, since masked sampling keeps
        tokens valid). The JAX ``_advance_machine``: the mask makes a forced
        run's tokens single choices, so no rider is needed."""
        machine, masker = req.machine, req.masker
        if req.done:
            return  # finished natively on this very token (stop / length)
        tstr = masker.token_strs[tok] if tok < masker.vocab_size else None
        if tstr is None and getattr(machine, "is_unconstrained", lambda: False)():
            return  # an undecodable token in a freeform phase
        probe = machine.copy() if tstr is not None else None
        if tstr is None or not probe.advance(tstr):
            # a stop token or the length budget may have finished the
            # sequence on this very token: then the rejection is expected
            if self.core.finish_external(req.seq_id, 5):
                logger.warning("native constrained: token %d (%r) rejected", tok, tstr)
            return
        req.machine = probe
        if probe.is_complete:
            self.core.finish_external(req.seq_id, 1)

    def _emit(self, seq_id: int, token: int) -> None:
        req = self.requests.get(seq_id)
        if req is None:
            if self.token_sink is not None:
                self.token_sink(seq_id, token)
            return
        req.output_ids.append(token)
        if req.on_token:
            try:
                req.on_token(req, token)
            except Exception:  # pragma: no cover
                logger.exception("on_token callback failed")


def _bucket(n: int, max_chunk: int) -> int:
    """A prefill chunk's bucket: the next power of two from 16, capped."""
    c = 16
    while c < n:
        c *= 2
    return min(c, max_chunk)
