"""Shared-memory IPC between a frontend process and the engine process,
bound through ctypes (``native/src/ipc.cpp``, ``ipc_reader.cpp``).

Port of the JAX package's ``pie_tpu/runtime/ipc.py``. One POSIX shm
segment holds a request ring (cache-aligned slots with an atomic
FREE / WRITING / READY / READING lifecycle) and a response ring, each with
a futex doorbell. ``IpcFrontend`` (a frontend process: it needs neither
torch's device nor the model) submits token-id prompts and streams the
response events; ``IpcEngineService`` runs the ``NativeScheduler`` loop in
the engine process, a C++ reader thread feeding the scheduler from the
request ring and the service sending each generated token back through the
response ring. The process that creates a segment unlinks it when it
closes the channel.
"""

from __future__ import annotations

import ctypes
import logging
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from pie_tpu_torch.runtime.native import load

logger = logging.getLogger(__name__)

_FINISH_CODES = {None: 0, "stop": 1, "length": 2, "cancelled": 3,
                 "error: out of pages": 4}
_FINISH_REASONS = {v: k for k, v in _FINISH_CODES.items()}


def _bind_ipc(lib) -> None:
    """The IPC rings' C prototypes (``native/src/capi_ipc.cpp``)."""
    c = ctypes
    p_i32 = c.POINTER(c.c_int32)
    p_u8 = c.POINTER(c.c_uint8)
    p_u32 = c.POINTER(c.c_uint32)
    p_u64 = c.POINTER(c.c_uint64)
    p_f32 = c.POINTER(c.c_float)
    lib.pie_ipc_create.restype = c.c_void_p
    lib.pie_ipc_create.argtypes = [c.c_char_p, c.c_uint32, c.c_uint32, c.c_uint32]
    lib.pie_ipc_attach.restype = c.c_void_p
    lib.pie_ipc_attach.argtypes = [c.c_char_p]
    lib.pie_ipc_destroy.argtypes = [c.c_void_p]
    lib.pie_ipc_prompt_capacity.restype = c.c_uint32
    lib.pie_ipc_prompt_capacity.argtypes = [c.c_void_p]
    lib.pie_ipc_submit.restype = c.c_int32
    lib.pie_ipc_submit.argtypes = [
        c.c_void_p, c.c_uint64, p_i32, c.c_uint32, c.c_uint32, p_i32,
        c.c_uint32, c.c_float, c.c_float, c.c_float, c.c_int32, c.c_float,
        c.c_float, c.c_float, c.c_uint64,
    ]
    lib.pie_ipc_submit_cancel.restype = c.c_int32
    lib.pie_ipc_submit_cancel.argtypes = [c.c_void_p, c.c_uint64]
    lib.pie_ipc_poll_response.restype = c.c_int32
    lib.pie_ipc_poll_response.argtypes = [c.c_void_p, p_u64, p_i32, p_u8, p_u8]
    lib.pie_ipc_wait_responses.restype = c.c_uint32
    lib.pie_ipc_wait_responses.argtypes = [c.c_void_p, c.c_uint32, c.c_int32]
    lib.pie_ipc_response_doorbell.restype = c.c_uint32
    lib.pie_ipc_response_doorbell.argtypes = [c.c_void_p]
    lib.pie_ipc_next_request.restype = c.c_int32
    lib.pie_ipc_next_request.argtypes = [
        c.c_void_p, p_u64, p_i32, p_u32, p_u32, p_i32, p_u32, p_f32, p_f32,
        p_f32, p_i32, p_f32, p_f32, p_f32, p_u64, p_u8,
    ]
    lib.pie_ipc_wait_requests.restype = c.c_uint32
    lib.pie_ipc_wait_requests.argtypes = [c.c_void_p, c.c_uint32, c.c_int32]
    lib.pie_ipc_request_doorbell.restype = c.c_uint32
    lib.pie_ipc_request_doorbell.argtypes = [c.c_void_p]
    lib.pie_ipc_push_response.restype = c.c_int32
    lib.pie_ipc_push_response.argtypes = [
        c.c_void_p, c.c_uint64, c.c_int32, c.c_uint8, c.c_uint8,
    ]
    lib.pie_ipc_reader_create.restype = c.c_void_p
    lib.pie_ipc_reader_create.argtypes = [c.c_void_p, c.c_void_p]
    lib.pie_ipc_reader_destroy.argtypes = [c.c_void_p]
    lib.pie_ipc_reader_forward_token.argtypes = [c.c_void_p, c.c_uint64, c.c_int32]
    lib.pie_ipc_reader_forward_finish.argtypes = [c.c_void_p, c.c_uint64, c.c_uint8]
    lib.pie_ipc_reader_accepted.restype = c.c_uint64
    lib.pie_ipc_reader_accepted.argtypes = [c.c_void_p]
    for void in (lib.pie_ipc_destroy, lib.pie_ipc_reader_destroy,
                 lib.pie_ipc_reader_forward_token, lib.pie_ipc_reader_forward_finish):
        void.restype = None


def _lib():
    lib = load()
    _bind_ipc(lib)
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class IpcChannel:
    """One shared-memory segment: ``create`` (the engine) or ``attach``
    (a frontend)."""

    def __init__(self, handle, lib, name: str):
        self._h = handle
        self._lib = lib
        self.name = name

    @classmethod
    def create(cls, name: str, request_slots: int = 256,
               prompt_capacity: int = 8192, response_slots: int = 4096) -> "IpcChannel":
        lib = _lib()
        h = ctypes.c_void_p(lib.pie_ipc_create(
            name.encode(), request_slots, prompt_capacity, response_slots))
        if not h:
            raise OSError(f"failed to create shm channel {name}")
        return cls(h, lib, name)

    @classmethod
    def attach(cls, name: str) -> "IpcChannel":
        lib = _lib()
        h = ctypes.c_void_p(lib.pie_ipc_attach(name.encode()))
        if not h:
            raise OSError(f"failed to attach shm channel {name}")
        return cls(h, lib, name)

    @property
    def prompt_capacity(self) -> int:
        return int(self._lib.pie_ipc_prompt_capacity(self._h))

    def submit(self, request_id: int, prompt_ids, max_new_tokens: int = 256,
               stop_token_ids=(), temperature: float = 1.0, top_p: float = 1.0,
               min_p: float = 0.0, top_k: int = -1, repetition_penalty: float = 1.0,
               presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
               rng_seed: int = 0) -> bool:
        prompt = np.ascontiguousarray(prompt_ids, np.int32)
        stops = np.ascontiguousarray(list(stop_token_ids), np.int32)
        return self._lib.pie_ipc_submit(
            self._h, request_id, _ptr(prompt, ctypes.c_int32), len(prompt),
            max_new_tokens, _ptr(stops, ctypes.c_int32), len(stops), temperature,
            top_p, min_p, top_k, repetition_penalty, presence_penalty,
            frequency_penalty, rng_seed,
        ) == 0

    def submit_cancel(self, request_id: int) -> bool:
        return self._lib.pie_ipc_submit_cancel(self._h, request_id) == 0

    def poll_response(self) -> Optional[tuple[int, int, bool, Optional[str]]]:
        """(request_id, token, finished, reason), or None."""
        rid = ctypes.c_uint64()
        tok = ctypes.c_int32()
        fin = ctypes.c_uint8()
        reason = ctypes.c_uint8()
        if not self._lib.pie_ipc_poll_response(
                self._h, ctypes.byref(rid), ctypes.byref(tok), ctypes.byref(fin),
                ctypes.byref(reason)):
            return None
        return (rid.value, tok.value, bool(fin.value),
                _FINISH_REASONS.get(reason.value) if fin.value else None)

    def wait_responses(self, seen: int, timeout_ms: int = 100) -> int:
        return int(self._lib.pie_ipc_wait_responses(self._h, seen, timeout_ms))

    @property
    def response_doorbell(self) -> int:
        return int(self._lib.pie_ipc_response_doorbell(self._h))

    def close(self) -> None:
        """Unmap the segment (and unlink it, from the process that made it)."""
        if self._h:
            self._lib.pie_ipc_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class IpcFrontend:
    """A frontend process's client: submit requests, stream responses.
    Submission is thread-safe; ``pump`` (on a thread of its own, or from
    ``stream``) dispatches response events to per-request queues."""

    def __init__(self, name: str):
        self.channel = IpcChannel.attach(name)
        self._next_id = 1
        self._lock = threading.Lock()
        self._queues: dict[int, list] = {}
        self._events: dict[int, threading.Event] = {}
        self.last_finish_reason: Optional[str] = None

    def submit(self, prompt_ids, **kw) -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._queues[rid] = []
            self._events[rid] = threading.Event()
        if not self.channel.submit(rid, prompt_ids, **kw):
            with self._lock:
                self._queues.pop(rid, None)
                self._events.pop(rid, None)
            raise RuntimeError("request ring full")
        return rid

    def cancel(self, request_id: int) -> bool:
        return self.channel.submit_cancel(request_id)

    def pump(self, timeout_ms: int = 100) -> int:
        """Dispatch the pending response events, waiting up to
        ``timeout_ms`` when there are none; returns how many it dispatched."""
        n = 0
        seen = self.channel.response_doorbell
        while (ev := self.channel.poll_response()) is not None:
            rid, tok, fin, reason = ev
            with self._lock:
                q = self._queues.get(rid)
                e = self._events.get(rid)
            if q is not None:
                q.append((tok, fin, reason))
                e.set()
            n += 1
        if n == 0 and timeout_ms > 0:
            self.channel.wait_responses(seen, timeout_ms)
        return n

    def stream(self, request_id: int, timeout_s: float = 60.0,
               pump: bool = True) -> Iterator[int]:
        """Yield the generated tokens until the finish event (its reason in
        ``last_finish_reason``); TimeoutError when the engine stays silent
        for ``timeout_s``. With ``pump`` this thread dispatches the
        responses itself; without it another thread must call ``pump``."""
        idx = 0
        last_progress = time.monotonic()
        while True:
            with self._lock:
                q = self._queues.get(request_id)
                e = self._events.get(request_id)
            if q is None:
                raise KeyError(request_id)
            progressed = False
            while idx < len(q):
                progressed = True
                tok, fin, reason = q[idx]
                idx += 1
                if fin:
                    with self._lock:
                        self._queues.pop(request_id, None)
                        self._events.pop(request_id, None)
                    self.last_finish_reason = reason
                    return
                yield tok
            if progressed:
                last_progress = time.monotonic()
            elif time.monotonic() - last_progress > timeout_s:
                raise TimeoutError(f"request {request_id} stalled")
            if pump:
                self.pump(timeout_ms=50)
            else:
                e.clear()
                e.wait(min(timeout_s, 0.05))

    def collect(self, request_id: int,
                timeout_s: float = 60.0) -> tuple[list[int], Optional[str]]:
        toks = list(self.stream(request_id, timeout_s=timeout_s))
        return toks, self.last_finish_reason

    def close(self) -> None:
        self.channel.close()


class IpcEngineService:
    """The engine process's service: a ``NativeScheduler`` whose requests
    arrive over the shm ring (a C++ reader thread submits them to the
    native core) and whose tokens go back through the response ring."""

    def __init__(self, scheduler, name: str, request_slots: int = 256,
                 prompt_capacity: int = 8192, response_slots: int = 4096):
        from pie_tpu_torch.runtime.native_scheduler import NativeScheduler

        if not isinstance(scheduler, NativeScheduler):
            raise TypeError("IpcEngineService serves a NativeScheduler")
        self.scheduler = scheduler
        self.channel = IpcChannel.create(name, request_slots, prompt_capacity,
                                         response_slots)
        lib = self._lib = self.channel._lib
        self._reader = ctypes.c_void_p(lib.pie_ipc_reader_create(
            self.channel._h, scheduler.core._h))
        if not self._reader:
            self.channel.close()
            raise OSError("failed to start the IPC reader")
        scheduler.token_sink = self._forward_token
        scheduler.finish_sink = self._forward_finish
        self._stop = threading.Event()

    def _forward_token(self, seq_id: int, token: int) -> None:
        self._lib.pie_ipc_reader_forward_token(self._reader, seq_id, token)

    def _forward_finish(self, seq_id: int, reason: Optional[str]) -> None:
        self._lib.pie_ipc_reader_forward_finish(self._reader, seq_id,
                                                _FINISH_CODES.get(reason, 0))

    def step(self):
        return self.scheduler.step()

    def serve_forever(self, idle_wait_ms: int = 20,
                      should_stop: Optional[Callable[[], bool]] = None) -> None:
        """The engine's main loop: step while there is work, wait on the
        request doorbell while there is none."""
        lib, ch = self._lib, self.channel
        while not self._stop.is_set():
            if should_stop is not None and should_stop():
                return
            if self.scheduler.has_work:
                self.step()
            else:
                seen = lib.pie_ipc_request_doorbell(ch._h)
                lib.pie_ipc_wait_requests(ch._h, seen, idle_wait_ms)
                # the reader thread takes the ring's request; give it a moment
                if not self.scheduler.has_work:
                    self._stop.wait(0.001)

    def shutdown(self) -> None:
        """Stop the reader thread, then unmap and unlink the segment."""
        self._stop.set()
        if self._reader:
            self._lib.pie_ipc_reader_destroy(self._reader)
            self._reader = None
        self.channel.close()
