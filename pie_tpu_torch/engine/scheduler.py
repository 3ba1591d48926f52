"""Continuous-batching scheduler over the paged KV pool (PyTorch).

Port of the JAX package's ``pie_tpu/engine/scheduler.py`` text paths:
sequences move WAITING -> PREFILLING -> DECODING -> COMPLETED over fixed
batch lanes; one ``Scheduler.step()`` plans a CHUNK of device steps on the
host (admissions, prefill-rider slices, the steps at which lanes wake) and
runs it, and the host reads the chunk's tokens once, when it drains it.

Each device step advances every live decode lane one token. A step whose
plan carries a prefill-rider slice runs ``LlamaModel.mixed_forward`` (the
lanes plus the rider, one pass over the weights); a step without one runs
``paged_forward`` at M = lanes. The JAX package compiles one program per
chunk and therefore picks one of the two for the whole chunk; here the
choice is host data per step, so rider-free steps of a mixed chunk take
the decode path. Each of the two steps is a function over the engine's
static buffers (lane state, block tables, request parameters, the step's
rider slice) run through ``StepGraphs`` (``engine/graphs.py``): on the card
a CUDA graph per (step, sampler kind, penalties on, bias on), captured at
its first use and replayed after; on the CPU the same function, called
directly. Long prompt bodies prefill through dedicated programs before the
chunk (``PagedEngine._prefill``: a graph per chunk bucket over static ids,
positions, block table and context length, queued behind the chunk in
flight). In steady decode the
next chunk is dispatched on the previous chunk's device state before that
chunk's tokens are read (pipelining): nothing inside a chunk reads the
device, so PyTorch queues chunk k+1 while the host drains chunk k, and
each chunk's tokens land in a tensor of its own.

The pool is written in place; inputs go to the card through pinned host
buffers (a copy from pageable memory would wait for the device), copied
into the static buffers on the stream, outside any graph.

Constrained lanes (a sequence carrying a character machine) decode
speculatively inside full chunks: the host builds each such lane's token
mask for its next choice point, the step applies it only to the lane's
first token sampled in the chunk (a per-lane count on the device, reset at
the chunk's start), the later steps sample unmasked, and the drain accepts
the longest prefix the machine accepts, rolls the lane back to the host's
truth past it, and re-arms forced-token runs through the prefill rider or
a direct prefill. A chunk with a mask runs the steps keyed by ``use_mask``;
chunks without one keep their own steps and upload no mask.

Image prompts (Qwen2-VL, Gemma-3): a sequence carries its prompt's
embeddings on the device (``prompt_embeds``, the vision tower's features
over the placeholders) and, for Qwen2-VL, its M-RoPE streams
(``positions3``) and its decode offset (``pos_delta``). It always
prefills as rider slices (never a direct prefill, never the prefix
store): a step whose slice carries embeddings copies them into the static
rider-embeddings buffer before it runs and takes the graph keyed "embeds
on". For an M-RoPE model every mixed step
reads the slice's streams from a static [3, Cs] buffer (text slices carry
their positions) and every step reads the lanes' offsets from a static
[B] buffer (zeros for text), so text and image lanes share the graphs.
The native scheduler (``runtime/native_scheduler.py``, the C++ core of
``native/``) drives three more programs of ``PagedEngine``, each a graph
over static buffers: ``_prefill_logits`` (a prefill chunk that also
returns its last row's logits), ``_sample_first`` (the first token, after
the request's mask and penalties) and ``_decode`` (one batched step whose
tokens the host reads back, once per token).

Sharded serving (``PagedEngine(mesh=)``, one process per rank of a
("dp", "tp") mesh): the model runs over its rank's shard with its
collectives inside the steps; the pool holds the rank's KV heads of every
page. Lanes split over the dp ranks: every rank runs the same host
schedule and keeps the same lane state, runs its own lanes' rows through
the model (the rider and the direct prefills on every rank), samples
them (from the whole batch's draws, so each lane samples as it would
unsharded), and gathers every lane's token over dp inside the step, so
the ranks' host state stays in step.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import itertools
import logging
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from pie_tpu_torch.cache.paged import (
    PAGE_SIZE,
    PagedCacheManager,
    PagedKVPool,
    PrefixStore,
)
from pie_tpu_torch.engine.core import PAD_TOKEN, PenaltyParams
from pie_tpu_torch.engine.engine import forced_run
from pie_tpu_torch.engine.graphs import StepGraphs
from pie_tpu_torch.ops.sampling import (
    SAMPLER_KINDS,
    SamplingParams,
    apply_logit_bias,
    dry_penalty,
    presence_frequency_penalty,
    repetition_penalty,
    sample,
    sampler_kind_for,
)
from pie_tpu_torch.parallel.tp import mesh_ops, shard_model
from pie_tpu_torch.utils import profiling
from pie_tpu_torch.utils.device import host_tensor, resolve_device, upload

logger = logging.getLogger(__name__)

HISTORY_LEN = 64  # recent tokens per lane the penalties read
MAX_STOP_IDS = 8  # stop tokens per request the device checks
MAX_BIAS = 16  # logit-bias entries per request
# prompt bodies longer than this prefill through dedicated programs;
# shorter ones ride mixed steps
DIRECT_PREFILL_MIN = 32


class SeqStatus(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    COMPLETED = "completed"
    CANCELLED = "cancelled"
    ERROR = "error"


@dataclasses.dataclass
class Sequence:
    """One request."""

    seq_id: int
    prompt_ids: list[int]
    max_new_tokens: int = 256
    stop_token_ids: tuple[int, ...] = ()
    temperature: float = 1.0
    top_p: float = 1.0
    min_p: float = 0.0
    top_k: int = -1
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    # sparse per-request logit bias {token_id: bias}
    logit_bias: dict = dataclasses.field(default_factory=dict)

    status: SeqStatus = SeqStatus.WAITING
    output_ids: list[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0  # pending tokens already written to the pool
    lane: int = -1
    finish_reason: Optional[str] = None
    cancelled: bool = False
    on_token: Optional[Callable[["Sequence", int], None]] = None
    on_finish: Optional[Callable[["Sequence"], None]] = None
    # constrained decoding: the character machine that restricts the
    # output and the vocabulary masker that turns its state into a token
    # mask (set by BatchedInferenceEngine.generate_constrained)
    machine: Any = None
    masker: Any = None
    # per-sub-state sampler overrides keyed by machine.active_names(),
    # resolved each chunk against the request's own sampling parameters
    state_kwargs: dict = dataclasses.field(default_factory=dict)
    # tokens whose KV still needs writing, starting at pool position
    # pending_base; the LAST pending token is the wake token (its KV is
    # written during its own decode step). The prompt at admission; a
    # forced-token run of a constrained lane re-arms it.
    pending: list[int] = dataclasses.field(default_factory=list)
    pending_base: int = 0
    # the prompt's full pages are registered in the PrefixStore (at first wake)
    prefix_cached: bool = False
    # an image prompt: its embeddings [plen, D] on the device, its M-RoPE
    # streams [3, plen] (host) and its decode offset (rope position = KV
    # position - pos_delta past the prompt)
    prompt_embeds: Any = None
    positions3: Any = None
    pos_delta: int = 0
    # pixel inputs not yet through the vision tower: (pixel_values, the
    # tower's keyword arguments), embedded by the batching service's
    # scheduler thread
    image_inputs: Any = None
    # request stamps (time.perf_counter_ns; 0: not yet): submitted to the
    # batching service, given a lane, first output token
    t_submit: int = 0
    t_admit: int = 0
    t_first: int = 0

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)


@dataclasses.dataclass
class LaneState:
    """Per-lane decode state carried from step to step on the device (the
    engine's static buffers, updated in place by every step)."""

    last: torch.Tensor  # [B] int32 next input token
    ctx: torch.Tensor  # [B] int32 tokens in the pool
    hist: torch.Tensor  # [B, H] int32 recent tokens (-1 pad)
    done: torch.Tensor  # [B] bool frozen (finished / not yet woken)
    prod: torch.Tensor  # [B] int32 tokens generated so far


@dataclasses.dataclass
class LaneParams:
    """Per-lane request parameters on the device (constant within a chunk)."""

    max_new: torch.Tensor  # [B] int32
    stop_ids: torch.Tensor  # [B, S] int32 (-1 pad)
    sampling: SamplingParams
    pen: PenaltyParams
    bias_ids: torch.Tensor  # [B, NB] int32 (-1 pad)
    bias_vals: torch.Tensor  # [B, NB] f32


@dataclasses.dataclass
class RiderPlan:
    """Host plan of a chunk's prefill-rider slices, one per step."""

    ids: np.ndarray  # [N, Cs] int32 tokens (-1 pad)
    pos: np.ndarray  # [N, Cs] int32 positions (-1 pad)
    lane: np.ndarray  # [N] lane whose table each slice uses
    ctx: np.ndarray  # [N] rider-lane pool tokens after each slice
    # per step: (prompt_embeds, start, count) of an image prompt's slice,
    # or None
    embeds: list
    # [N, 3, Cs] int32 M-RoPE streams of each slice (an M-RoPE model only)
    pos3: Optional[np.ndarray] = None


@dataclasses.dataclass
class WakePlan:
    """Host plan of the lanes that start decoding inside a chunk."""

    step: np.ndarray  # [B] step at which the lane wakes (-1 never)
    tokens: np.ndarray  # [B] the prompt's final token (first decode input)
    ctx: np.ndarray  # [B] pool tokens at wake
    prod: np.ndarray  # [B] produced count at wake
    hist: np.ndarray  # [B, H] history seeded with the prompt tail


@dataclasses.dataclass
class NativeInputs:
    """Static inputs of the native scheduler's programs at batch ``b``. The
    lane state and request parameters are packed as int32 [last | ctx |
    active | top_k | table | hist] and f32 [temperature | top_p | min_p |
    repetition | presence | frequency], so each pack goes to the device in
    one copy (``pack``); the fields are views of the two packs."""

    i32: torch.Tensor
    f32: torch.Tensor
    last: torch.Tensor  # [b] next input token
    ctx: torch.Tensor  # [b] tokens of the sequence, the input included
    active: torch.Tensor  # [b] 1 = the lane decodes
    table: torch.Tensor  # [b, maxP] block table
    hist: torch.Tensor  # [b, H] recent tokens (-1 pad)
    sampling: SamplingParams
    pen: PenaltyParams
    pos_delta: torch.Tensor  # [b] zeros: an M-RoPE model's text offset

    @classmethod
    def make(cls, b: int, max_pages: int, device) -> "NativeInputs":
        i32 = torch.zeros((b * (4 + max_pages + HISTORY_LEN),), dtype=torch.int32,
                          device=device)
        f32 = torch.zeros((6 * b,), dtype=torch.float32, device=device)
        iv = [i32[k * b:(k + 1) * b] for k in range(4)]
        table = i32[4 * b:(4 + max_pages) * b].view(b, max_pages)
        hist = i32[(4 + max_pages) * b:].view(b, HISTORY_LEN)
        fv = [f32[k * b:(k + 1) * b] for k in range(6)]
        return cls(i32=i32, f32=f32, last=iv[0], ctx=iv[1], active=iv[2], table=table,
                   hist=hist,
                   sampling=SamplingParams(temperature=fv[0], top_p=fv[1], min_p=fv[2],
                                           top_k=iv[3]),
                   pen=PenaltyParams(repetition=fv[3], presence=fv[4], frequency=fv[5]),
                   pos_delta=torch.zeros((b,), dtype=torch.int32, device=device))

    @staticmethod
    def pack(last, ctx, active, table, hist, sampling: dict, pen: dict) -> tuple:
        """The host packs (int32, f32) of one program's inputs: ``sampling``
        holds temperature / top_p / min_p / top_k, ``pen`` repetition /
        presence / frequency, each [b]."""
        i32 = np.concatenate([np.ravel(a).astype(np.int32, copy=False) for a in (
            last, ctx, active, sampling["top_k"], table, hist)])
        f32 = np.concatenate([np.ravel(a).astype(np.float32, copy=False) for a in (
            sampling["temperature"], sampling["top_p"], sampling["min_p"],
            pen["repetition"], pen["presence"], pen["frequency"])])
        return i32, f32


class PagedEngine:
    """The device side of the scheduler: the pool, the parameters, the
    static lane buffers and the device programs (the direct prefill, and
    the rider-free and mixed steps of a chunk; the native scheduler's
    prefill with logits, first-token sample and decode step), all run
    through ``StepGraphs``."""

    def __init__(
        self,
        model,
        params,
        num_lanes: int = 8,
        num_pages: int = 512,
        max_pages_per_seq: int = 32,
        # direct-prefill programs: bigger chunks are fewer passes over the
        # weights (one per chunk)
        prefill_chunk: int = 1024,
        # M = num_lanes + rider_width = 256 for a mixed step
        rider_width: int = 248,
        kv_dtype=torch.bfloat16,
        kv_quantized: bool = False,
        seed: int = 0,
        device="cuda",
        # the ("dp", "tp") mesh this process is a rank of (params: its
        # shard, parallel.tp.shard_params); eager_steps: no CUDA graphs
        # (a mesh over gloo needs them off)
        mesh=None,
        eager_steps: bool = False,
    ):
        self.device = dev = resolve_device(device)
        if mesh is not None:
            model = shard_model(model, mesh)
        #: the model's collectives and this rank's lanes
        self.par = mesh_ops(mesh)
        self.par.rows(num_lanes)  # the lanes split over dp
        cfg = model.config
        self.model = model
        self.params = params
        self.num_lanes = num_lanes
        self.max_pages_per_seq = max_pages_per_seq
        self.prefill_chunk = prefill_chunk
        self.rider_width = rider_width
        self.pool = PagedKVPool.create(
            cfg.num_hidden_layers, num_pages, cfg.num_key_value_heads,
            cfg.resolved_head_dim, kv_dtype, kv_quantized, device=dev,
        )
        self.key = torch.Generator(device=dev).manual_seed(seed)
        #: the steps' graphs (jax.jit's cache of compiled programs)
        self.graphs = StepGraphs(dev, self.key, self.par, eager=eager_steps)
        #: device steps dispatched (decode or mixed; a direct prefill is
        #: not one): each runs the paged attention once per layer
        self.device_steps = 0
        # the static buffers the steps read and write: lane state, block
        # tables, request parameters, and one step's rider slice packed as
        # [ids (Cs) | positions (Cs) | lane | ctx]
        b, i32 = num_lanes, torch.int32
        self.lanes = LaneState(
            last=torch.zeros((b,), dtype=i32, device=dev),
            ctx=torch.zeros((b,), dtype=i32, device=dev),
            hist=torch.full((b, HISTORY_LEN), PAD_TOKEN, dtype=i32, device=dev),
            done=torch.ones((b,), dtype=torch.bool, device=dev),
            prod=torch.zeros((b,), dtype=i32, device=dev),
        )
        self.block_tables = torch.full((b, max_pages_per_seq), -1, dtype=i32,
                                       device=dev)
        self.lane_params = LaneParams(
            max_new=torch.ones((b,), dtype=i32, device=dev),
            stop_ids=torch.full((b, MAX_STOP_IDS), -1, dtype=i32, device=dev),
            sampling=SamplingParams.make(b, device=dev),
            pen=PenaltyParams.make(b, device=dev),
            bias_ids=torch.full((b, MAX_BIAS), -1, dtype=i32, device=dev),
            bias_vals=torch.zeros((b, MAX_BIAS), dtype=torch.float32, device=dev),
        )
        self._rider = torch.full((2 * rider_width + 2,), -1, dtype=i32, device=dev)
        # M-RoPE: the slice's streams and the lanes' decode offsets; an
        # image slice's embeddings (made at the first one)
        self.mrope = bool(getattr(model, "uses_mrope", False))
        self._rider_pos3 = torch.full((3, rider_width), -1, dtype=i32, device=dev)
        self.pos_delta = torch.zeros((b,), dtype=i32, device=dev)
        self._rider_embeds: Optional[torch.Tensor] = None
        # constrained lanes: the chunk's token masks [B, V] (made at the
        # first masked chunk), which lanes they apply to, and the tokens
        # each lane has sampled since the chunk began (the mask applies to
        # the first only)
        self.allowed: Optional[torch.Tensor] = None
        self.mask_valid = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.sampled = torch.zeros((b,), dtype=i32, device=dev)
        # the direct prefill's static inputs: ids and positions per chunk
        # bucket (made at first use), one block table and context length
        self._prefill_in: dict = {}
        self._prefill_table = torch.full((1, max_pages_per_seq), -1, dtype=i32,
                                         device=dev)
        self._prefill_ctx = torch.zeros((1,), dtype=i32, device=dev)
        # the native scheduler's static inputs (made at its first call): the
        # decode lanes', the first sample's (batch 1) and its logits [1, V],
        # the prefill's row to unembed
        self._native: Optional[NativeInputs] = None
        self._first: Optional[NativeInputs] = None
        self._first_logits: Optional[torch.Tensor] = None
        self._first_allowed: Optional[torch.Tensor] = None
        self._prefill_last = torch.zeros((1,), dtype=torch.int64, device=dev)

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """A copy of host array ``a`` on the engine's device, queued without
        waiting for the device (pinned staging buffer)."""
        return host_tensor(a, self.device)

    # -- device programs -------------------------------------------------

    @torch.no_grad()
    def _prefill(self, params, ids, positions, block_table, context_len):
        """One prefill chunk of ONE sequence: writes its K/V into the pool;
        no logits (the prompt's final token is its lane's first decode
        input). ids, positions [1, T]; block_table [1, maxP]; context_len
        [1] (host arrays, or tensors). They are copied into static buffers
        (ids and positions per chunk bucket T), then the chunk runs through
        ``self.graphs`` keyed by (T, params): a CUDA graph per bucket on
        the card, as ``jax.jit`` compiles one program per chunk shape."""
        bufs = self._prefill_inputs(ids, positions, block_table, context_len)
        self.graphs(("prefill", ids.shape[1], id(params)),
                    functools.partial(self._prefill_step, params, *bufs))

    def _prefill_inputs(self, ids, positions, block_table, context_len) -> tuple:
        """Copy a prefill chunk's inputs into its bucket's static buffers."""
        t = ids.shape[1]
        bufs = self._prefill_in.get(t)
        if bufs is None:
            bufs = self._prefill_in[t] = (
                torch.zeros((1, t), dtype=torch.int32, device=self.device),
                torch.full((1, t), -1, dtype=torch.int32, device=self.device),
                self._prefill_table, self._prefill_ctx)
        for buf, src in zip(bufs, (ids, positions, block_table, context_len)):
            upload(buf, src)
        return bufs

    def _prefill_step(self, params, ids, positions, block_table, context_len):
        """The direct prefill over its static buffers (a graph's body)."""
        self.model.paged_forward(params, ids, self.pool, block_table, positions,
                                 context_len, with_logits=False)
        return ()

    def _step(self, params, sampler_kind: str, use_penalties: bool,
              use_bias: bool, mixed: bool, use_mask: bool = False,
              use_embeds: bool = False):
        """One continuous-batching step over the static buffers (a graph's
        body): every live lane advances one token (a mixed step also
        writes the rider slice's K/V), samples, and freezes on a stop token
        or its length budget; frozen lanes emit PAD. ``use_mask``: a lane
        flagged in ``mask_valid`` samples its first token of the chunk
        under its row of ``allowed``. ``use_embeds``: the rider slice's
        embeddings are the static image-embeddings buffer's. An M-RoPE
        model reads the slice's streams and the lanes' offsets. Returns
        (emitted [B], logits of this rank's lanes [B/dp, V])."""
        st, lp, model = self.lanes, self.lane_params, self.model
        loc = self.par.local
        pad = torch.full_like(st.last, PAD_TOKEN)
        active = ~st.done
        dec_pos = torch.where(active, st.ctx, pad)
        dec_ctx = torch.where(active, st.ctx + 1, torch.ones_like(st.ctx))
        extra = {"pos_delta": self.pos_delta} if self.mrope else {}
        if mixed:
            r, cs = self._rider, self.rider_width
            if self.mrope:
                extra["pf_pos3"] = self._rider_pos3
            if use_embeds:
                extra["pf_embeds"] = self._rider_embeds
            logits, _ = model.mixed_forward(
                params, self.pool, st.last, dec_pos, dec_ctx, self.block_tables,
                r[:cs], r[cs:2 * cs], r[2 * cs:2 * cs + 1], r[2 * cs + 1:], **extra,
            )
        else:
            logits, _ = model.paged_forward(
                params, st.last[:, None], self.pool, self.block_tables,
                dec_pos[:, None], dec_ctx, lane_split=True, **extra,
            )
            logits = logits[:, 0]
        if use_penalties:
            hist, pen = loc(st.hist), loc(lp.pen)
            logits = repetition_penalty(logits, hist, pen.repetition)
            logits = presence_frequency_penalty(
                logits, hist, pen.presence, pen.frequency)
            logits = dry_penalty(logits, hist, pen.dry_multiplier,
                                 pen.dry_base, pen.dry_allowed)
        if use_bias:
            logits = apply_logit_bias(logits, loc(lp.bias_ids), loc(lp.bias_vals))
        if use_mask:
            first = loc(self.mask_valid & (self.sampled == 0))
            logits = torch.where(first[:, None] & ~loc(self.allowed),
                                 torch.full_like(logits, -1e30), logits)
            self.sampled.add_(active.to(torch.int32))
        tok = sample(logits, loc(lp.sampling), self.key, kind=sampler_kind,
                     rows=self.par.batch_rows(logits.shape[0]))
        tok = self.par.gather_rows(tok)
        tok = torch.where(active, tok, st.last)
        emitted = torch.where(active, tok, pad)
        hit_stop = (tok[:, None] == lp.stop_ids).any(dim=1)
        step = active.to(torch.int32)
        prod = st.prod + step
        done = st.done | (active & (hit_stop | (prod >= lp.max_new)))
        ctx = st.ctx + step
        hist = torch.where(active[:, None],
                           torch.cat([st.hist[:, 1:], tok[:, None]], dim=1), st.hist)
        st.last.copy_(tok)
        st.ctx.copy_(ctx)
        st.hist.copy_(hist)
        st.done.copy_(done)
        st.prod.copy_(prod)
        return emitted, logits

    @torch.no_grad()
    def _chunk(
        self,
        params,
        num_steps: int,
        sampler_kind: str,
        use_penalties: bool,
        use_bias: bool,
        rider: Optional[RiderPlan] = None,
        wake: Optional[WakePlan] = None,
        mask: Optional[tuple] = None,
    ) -> torch.Tensor:
        """``num_steps`` continuous-batching steps on the static lane state
        with no read back to the host: lanes wake at their planned step
        (eager updates of the static buffers before that step), then each
        step runs the rider-free or the mixed step graph, keyed by
        (sampler kind, penalties on, bias on, mask on), as JAX's
        ``use_rider`` picks one of two programs. ``mask``: host arrays
        (allowed [B, V] bool, valid [B] bool) of the constrained lanes,
        copied into the static buffers before the first step. Returns the
        chunk's emitted tokens [N, B] int32, a tensor of its own that later
        chunks leave alone."""
        st, b = self.lanes, self.num_lanes
        if sampler_kind not in SAMPLER_KINDS:
            raise ValueError(f"sampler kind {sampler_kind!r}: resolve it on the host")
        if rider is not None:
            cols = [rider.ids, rider.pos, rider.lane[:, None], rider.ctx[:, None]]
            if rider.pos3 is not None:
                cols.append(rider.pos3.reshape(num_steps, -1))
            # [N, 2 Cs + 2 (+ 3 Cs)]
            rider_dev = self.to_device(np.concatenate(cols, axis=1).astype(np.int32))
            rides = (rider.ids >= 0).any(axis=1)
            nr = self._rider.shape[0]
        if wake is not None:
            w_step = self.to_device(wake.step)
            w_tok, w_ctx, w_prod, w_hist = (
                self.to_device(a) for a in (wake.tokens, wake.ctx, wake.prod, wake.hist))
            woken = set(int(s) for s in wake.step if s >= 0)
        if mask is not None:
            allowed, valid = mask
            if self.allowed is None:
                self.allowed = torch.ones(allowed.shape, dtype=torch.bool,
                                          device=self.device)
            upload(self.allowed, allowed)
            upload(self.mask_valid, valid)
            self.sampled.zero_()
        emitted = torch.empty((num_steps, b), dtype=torch.int32, device=self.device)
        for s in range(num_steps):
            self.device_steps += 1
            if wake is not None and s in woken:
                w = w_step == s
                st.last.copy_(torch.where(w, w_tok, st.last))
                st.ctx.copy_(torch.where(w, w_ctx, st.ctx))
                st.prod.copy_(torch.where(w, w_prod, st.prod))
                st.hist.copy_(torch.where(w[:, None], w_hist, st.hist))
                st.done.logical_and_(~w)
            mixed = bool(rider is not None and rides[s])
            embeds = mixed and rider.embeds[s] is not None
            if mixed:
                self._rider.copy_(rider_dev[s, :nr])
                if rider.pos3 is not None:
                    self._rider_pos3.copy_(rider_dev[s, nr:].reshape(3, -1))
            if embeds:
                self._copy_rider_embeds(*rider.embeds[s])
            key = ("mixed" if mixed else "decode", sampler_kind, use_penalties,
                   use_bias, mask is not None, embeds, id(params))
            out = self.graphs(
                key, functools.partial(self._step, params, sampler_kind,
                                       use_penalties, use_bias, mixed,
                                       mask is not None, embeds),
                samples=sampler_kind != "greedy")
            emitted[s].copy_(out[0])
        return emitted

    def _copy_rider_embeds(self, prompt_embeds: torch.Tensor, start: int,
                           count: int) -> None:
        """Rows [start, start + count) of an image prompt's embeddings into
        the static rider-embeddings buffer (a device copy on the stream;
        the buffer is made, zeroed, at the first image slice)."""
        if self._rider_embeds is None:
            self._rider_embeds = torch.zeros(
                (self.rider_width, prompt_embeds.shape[-1]), dtype=prompt_embeds.dtype,
                device=self.device)
        self._rider_embeds[:count].copy_(prompt_embeds[start:start + count])

    # -- the native scheduler's programs ---------------------------------
    # (runtime/native_scheduler.py drives them; the JAX package's
    # _prefill_impl, _sample_first_impl and _decode_impl.) The C++ core
    # stages whole prompts: a prefill writes every prompt token, the last
    # row's logits give the first token, and each later token is one
    # batched decode step whose tokens the host reads back.

    @torch.no_grad()
    def _prefill_logits(self, params, ids, positions, block_table, context_len,
                        last_idx: int) -> torch.Tensor:
        """One prefill chunk of ONE sequence that also returns the logits of
        its row ``last_idx`` (host arrays as ``_prefill``'s). Runs through
        ``self.graphs`` keyed ("native_prefill", T, params); only that row
        is unembedded. Returns the first sample's static logits buffer
        [1, V] f32, which holds a copy of them."""
        bufs = self._prefill_inputs(ids, positions, block_table, context_len)
        upload(self._prefill_last, np.array([last_idx], np.int64))
        out = self.graphs(("native_prefill", ids.shape[1], id(params)),
                          functools.partial(self._prefill_logits_step, params, *bufs))
        self._first_inputs()
        self._first_logits.copy_(out[0])
        return self._first_logits

    def _prefill_logits_step(self, params, ids, positions, block_table, context_len):
        """The native prefill over its static buffers (a graph's body)."""
        logits, _ = self.model.paged_forward(params, ids, self.pool, block_table,
                                             positions, context_len,
                                             last_idx=self._prefill_last)
        return (logits[0],)

    def _first_inputs(self) -> NativeInputs:
        if self._first is None:
            v = self.model.config.vocab_size
            self._first = NativeInputs.make(1, 0, self.device)
            self._first_logits = torch.zeros((1, v), dtype=torch.float32,
                                             device=self.device)
        return self._first

    @torch.no_grad()
    def _sample_first(self, logits, sampling: dict, pen: dict, history,
                      sampler_kind: str, use_penalties: bool,
                      mask: Optional[np.ndarray] = None) -> torch.Tensor:
        """The first token of a just-prefilled sequence from its logits
        [1, V]: its mask (a constrained request's [V] bool row, JAX's
        ``_mask_logits``), its penalties over ``history`` [1, H], then its
        sampler. ``sampling`` / ``pen``: host arrays [1] (see
        ``NativeInputs.pack``). Runs through ``self.graphs`` keyed ("first",
        sampler kind, penalties on, mask on). Returns a [1] int32 tensor of
        its own on the device."""
        nf = self._first_inputs()
        if logits is not self._first_logits:
            self._first_logits.copy_(logits.reshape(1, -1))
        i32, f32 = NativeInputs.pack([0], [0], [0], np.zeros((1, 0)), history,
                                     sampling, pen)
        upload(nf.i32, i32)
        upload(nf.f32, f32)
        if mask is not None:
            if self._first_allowed is None:
                self._first_allowed = torch.ones_like(self._first_logits,
                                                      dtype=torch.bool)
            upload(self._first_allowed, mask)
        if sampler_kind not in SAMPLER_KINDS:
            raise ValueError(f"sampler kind {sampler_kind!r}: resolve it on the host")
        out = self.graphs(
            ("first", sampler_kind, use_penalties, mask is not None),
            functools.partial(self._first_step, sampler_kind, use_penalties,
                              mask is not None),
            samples=sampler_kind != "greedy")
        return out[0].clone()

    def _first_step(self, sampler_kind: str, use_penalties: bool, use_mask: bool):
        """The first-token sample over its static buffers (a graph's body)."""
        nf, logits = self._first, self._first_logits
        if use_mask:
            logits = torch.where(self._first_allowed, logits,
                                 torch.full_like(logits, -1e30))
        if use_penalties:
            logits = _penalize(logits, nf.hist, nf.pen)
        return (sample(logits, nf.sampling, self.key, kind=sampler_kind),)

    @torch.no_grad()
    def _decode(self, params, last_tokens, context_lens, block_tables, histories,
                sampling: dict, pen: dict, active, sampler_kind: str,
                use_penalties: bool, mask: Optional[tuple] = None) -> tuple:
        """One batched decode step over every lane (host arrays [B], as the
        C++ core's ``decode_view`` fills them; ``context_lens`` counts the
        input token). An active lane writes its input's K/V at
        context_len - 1 and samples; an inactive one writes nowhere
        (position -1) and emits PAD. ``mask``: (allowed [B, V] bool,
        valid [B] bool) of the constrained lanes. Runs through
        ``self.graphs`` keyed ("native", sampler kind, penalties on, mask
        on, params). Returns (tokens [B] int32, a tensor of its own;
        logits [B, V], the graph's, valid until its next replay)."""
        if sampler_kind not in SAMPLER_KINDS:
            raise ValueError(f"sampler kind {sampler_kind!r}: resolve it on the host")
        if self._native is None:
            self._native = NativeInputs.make(self.num_lanes, self.max_pages_per_seq,
                                             self.device)
        nb = self._native
        i32, f32 = NativeInputs.pack(last_tokens, context_lens, active, block_tables,
                                     histories, sampling, pen)
        upload(nb.i32, i32)
        upload(nb.f32, f32)
        if mask is not None:
            allowed, valid = mask
            if self.allowed is None:
                self.allowed = torch.ones(allowed.shape, dtype=torch.bool,
                                          device=self.device)
            upload(self.allowed, allowed)
            upload(self.mask_valid, valid)
        self.device_steps += 1
        out = self.graphs(
            ("native", sampler_kind, use_penalties, mask is not None, id(params)),
            functools.partial(self._decode_step, params, sampler_kind, use_penalties,
                              mask is not None),
            samples=sampler_kind != "greedy")
        return out[0].clone(), out[1]

    def _decode_step(self, params, sampler_kind: str, use_penalties: bool,
                     use_mask: bool):
        """The native decode step over its static buffers (a graph's body)."""
        nb, loc = self._native, self.par.local
        active = nb.active != 0
        pos = torch.where(active, nb.ctx - 1, torch.full_like(nb.ctx, -1))
        ctx = torch.where(active, nb.ctx, torch.ones_like(nb.ctx))
        extra = {"pos_delta": nb.pos_delta} if self.mrope else {}
        logits, _ = self.model.paged_forward(params, nb.last[:, None], self.pool,
                                             nb.table, pos[:, None], ctx,
                                             lane_split=True, **extra)
        logits = logits[:, 0]
        if use_penalties:
            logits = _penalize(logits, loc(nb.hist), loc(nb.pen))
        if use_mask:
            logits = torch.where(loc(self.mask_valid)[:, None] & ~loc(self.allowed),
                                 torch.full_like(logits, -1e30), logits)
        tok = self.par.gather_rows(sample(logits, loc(nb.sampling), self.key,
                                          kind=sampler_kind,
                                          rows=self.par.batch_rows(logits.shape[0])))
        return torch.where(active, tok, torch.full_like(tok, PAD_TOKEN)), logits


class Scheduler:
    """Host-side continuous-batching orchestrator.

    One ``step()`` = one CHUNK of up to ``decode_steps`` device steps: plan
    (admissions, direct prefills, rider slices, wake schedule), dispatch,
    and drain with one read of the device per chunk."""

    def __init__(
        self,
        engine: PagedEngine,
        decode_steps: int = 8,
        prefix_cache: bool = True,
    ):
        self.engine = engine
        self.decode_steps = decode_steps
        self.manager = PagedCacheManager(engine.pool.num_pages,
                                         engine.max_pages_per_seq)
        self.prefix_store = PrefixStore(self.manager) if prefix_cache else None
        self.waiting: deque[Sequence] = deque()
        self.running: dict[int, Sequence] = {}  # lane -> seq
        self.free_lanes = list(range(engine.num_lanes - 1, -1, -1))
        self._ids = itertools.count()
        b = engine.num_lanes
        h = HISTORY_LEN
        # host mirrors of lane state (shipped to the device per chunk)
        self.last_tokens = np.zeros((b,), np.int32)
        self.context_lens = np.zeros((b,), np.int32)
        self.block_tables = np.full((b, engine.max_pages_per_seq), -1, np.int32)
        self.histories = np.full((b, h), PAD_TOKEN, np.int32)
        self.done = np.ones((b,), bool)
        self.produced = np.zeros((b,), np.int32)
        self.max_new = np.ones((b,), np.int32)
        self.stop_ids = np.full((b, MAX_STOP_IDS), -1, np.int32)
        self.samp = {
            "temperature": np.ones((b,), np.float32),
            "top_p": np.ones((b,), np.float32),
            "min_p": np.zeros((b,), np.float32),
            "top_k": np.full((b,), -1, np.int32),
            "xtc_probability": np.zeros((b,), np.float32),
            "xtc_threshold": np.full((b,), 0.1, np.float32),
        }
        self.pen = {
            "repetition": np.ones((b,), np.float32),
            "presence": np.zeros((b,), np.float32),
            "frequency": np.zeros((b,), np.float32),
            "dry_multiplier": np.zeros((b,), np.float32),
            "dry_base": np.full((b,), 1.75, np.float32),
            "dry_allowed": np.full((b,), 2, np.int32),
        }
        self.bias_ids = np.full((b, MAX_BIAS), -1, np.int32)
        self.bias_vals = np.zeros((b, MAX_BIAS), np.float32)
        self.pos_delta = np.zeros((b,), np.int32)  # M-RoPE decode offsets
        self._lane_params: Optional[LaneParams] = None  # device copy of the above
        # steady-state pipelining: whether the engine's lane state carries
        # on from the last dispatched chunk, and the chunks in flight,
        # oldest first, as (emitted, n). Host mirrors lag the device while
        # a chunk is in flight; draining its emitted tokens alone
        # reconstructs them exactly.
        self._chained = False
        self._inflight: deque = deque()
        self.pipeline_depth = 1

    # -- public API ------------------------------------------------------

    def add_request(self, prompt_ids, **kw) -> Sequence:
        seq = Sequence(seq_id=next(self._ids), prompt_ids=list(prompt_ids), **kw)
        self.waiting.append(seq)
        return seq

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self._inflight)

    @property
    def _hold(self) -> int:
        """Device steps already dispatched but not yet drained."""
        return sum(n for _, n in self._inflight)

    def run_to_completion(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
        raise RuntimeError("scheduler did not drain")

    # -- one scheduling step (= one device chunk) ------------------------

    def _all_decoding(self) -> bool:
        """Every lane decodes freely: none prefills, none is cancelled and
        none carries a machine (a constrained lane's chunks are drained
        before the next is planned)."""
        return bool(self.running) and all(
            s.status == SeqStatus.DECODING and s.machine is None and not s.cancelled
            for s in self.running.values()
        )

    def step(self) -> list[Sequence]:
        """Admit -> plan a chunk -> dispatch -> drain. Returns the sequences
        that finished.

        While prefill work is pending the chunk is sized to the rider slices
        it needs (a power of two, at most ``decode_steps``); steady decode
        chunks are ``decode_steps`` long. In steady decode (every lane
        decoding, nothing queued, no constrained lane) the next chunk is
        dispatched on the device-chained lane state before the previous one
        is drained.

        Constrained lanes run speculatively inside full chunks: the mask of
        the lane's choice point applies to its first sampled token only,
        the rest sample unmasked, and the drain keeps the longest prefix
        the machine accepts (an unmasked sample conditioned on the
        machine's acceptance is distributed as a masked one, so greedy
        streams equal the per-token masked loop's)."""
        with profiling.span("pie.sched.step"):
            if not self.waiting and self._all_decoding():
                self._fill_pipeline()
                if self._inflight:
                    return self._drain_inflight()
            # admission and direct prefill before the pipeline flush: new lanes
            # touch only free lanes and the pool, and their prefill programs
            # queue behind the chunk in flight
            if self._inflight and self.waiting:
                clean = self._all_decoding()
                pre_lanes = set(self.running)
                self._admit()
                self._direct_prefill()
                if clean:
                    new = [(l, s) for l, s in sorted(self.running.items())
                           if l not in pre_lanes]
                    if new and all(s.machine is None and len(s.pending) - 1 == s.prefill_pos
                                   for _, s in new):
                        # fully prefilled new lanes wake at step 0 of a chunk
                        # dispatched on the chained state before the old drains
                        out = self._dispatch_pipelined_wake(new)
                        if out is not None:
                            return out
            # pipeline flush: exact host mirrors before any planning
            finished_prev = []
            while self._inflight:
                finished_prev.extend(self._drain_inflight())
            self._chained = False
            self._admit()
            self._direct_prefill()
            cs = self.engine.rider_width
            need = 0
            for s in self.running.values():
                if s.status == SeqStatus.PREFILLING:
                    rem = len(s.pending) - 1 - s.prefill_pos
                    need += -(-rem // cs) if rem > 0 else 1  # wake-only: one step
            n = _bucket_chunk(need, self.decode_steps) if need else self.decode_steps
            plan = self._plan_chunk(n)
            if plan is None:
                return finished_prev
            return finished_prev + self._dispatch_and_drain(plan, n)

    def _fill_pipeline(self) -> None:
        """Steady decode: dispatch decode-only chunks on the chained device
        state until ``pipeline_depth`` are in flight, growing every lane's
        pages first (a lane out of pages stops it). Reads nothing back."""
        n = self.decode_steps
        while len(self._inflight) < self.pipeline_depth:
            hold = self._hold
            for lane, seq in self.running.items():
                if not self.manager.extend_seq(
                    seq.seq_id, int(self.context_lens[lane]) + hold + n
                ):
                    return
                self._sync_table(lane, seq)
            self._inflight.append((self._dispatch_steady(n), n))

    # -- device dispatch -------------------------------------------------

    def _sampler_kind(self) -> str:
        lanes = [lane for lane, s in self.running.items()
                 if s.status == SeqStatus.DECODING]
        if not lanes:
            return "greedy"
        return sampler_kind_for(
            self.samp["temperature"][lanes], self.samp["top_p"][lanes],
            self.samp["min_p"][lanes], self.samp["top_k"][lanes],
            self.samp["xtc_probability"][lanes],
        )

    def _device_params(self) -> LaneParams:
        """The lanes' request parameters in the engine's static buffers,
        uploaded again only after an admission changed them."""
        lp = self.engine.lane_params
        if self._lane_params is None:
            upload(lp.max_new, self.max_new)
            upload(lp.stop_ids, self.stop_ids)
            for k, v in self.samp.items():
                upload(getattr(lp.sampling, k), v)
            for k, v in self.pen.items():
                upload(getattr(lp.pen, k), v)
            upload(lp.bias_ids, self.bias_ids)
            upload(lp.bias_vals, self.bias_vals)
            upload(self.engine.pos_delta, self.pos_delta)
            self._lane_params = lp
        return lp

    def _host_state(self) -> None:
        """Upload the host mirrors into the engine's static lane state."""
        st = self.engine.lanes
        for dst, a in ((st.last, self.last_tokens), (st.ctx, self.context_lens),
                       (st.hist, self.histories), (st.done, self.done),
                       (st.prod, self.produced)):
            upload(dst, a)

    def _run_chunk(self, n, rider=None, wake=None, mask=None) -> torch.Tensor:
        """Dispatch one chunk on the engine's static lane state: chained
        from the previous chunk when ``_chained`` is set, else loaded from
        the host mirrors. The block tables and (after an admission or a
        change of a constrained lane's sampling phase) the request
        parameters are copied into their static buffers first, all queued
        from pinned memory. Returns the chunk's emitted tokens."""
        e = self.engine
        if not self._chained:
            self._host_state()
        upload(e.block_tables, self.block_tables)
        self._device_params()
        pen_on = (
            (self.pen["repetition"] != 1.0).any()
            or (self.pen["presence"] != 0.0).any()
            or (self.pen["frequency"] != 0.0).any()
            or (self.pen["dry_multiplier"] > 0.0).any()
        )
        with profiling.span("pie.engine.chunk"):
            return e._chunk(
                e.params, num_steps=n, sampler_kind=self._sampler_kind(),
                use_penalties=bool(pen_on),
                use_bias=bool((self.bias_ids >= 0).any()), rider=rider, wake=wake,
                mask=mask,
            )

    def _dispatch_steady(self, n: int) -> torch.Tensor:
        """Dispatch a decode-only chunk on the lane state chained from the
        previous chunk (no host round trip)."""
        emitted = self._run_chunk(n)
        self._chained = True
        return emitted

    def _dispatch_pipelined_wake(self, new) -> Optional[list[Sequence]]:
        """Dispatch a decode-only chunk that wakes freshly admitted, fully
        prefilled lanes at step 0, chained on the in-flight chunk's device
        state. Returns the old chunk's finished sequences, or None when page
        growth for the old lanes fails (the caller then flushes)."""
        e = self.engine
        b = e.num_lanes
        # a single late joiner wakes in a 1-step chunk, so its first token
        # comes back at the very next drain; bursts keep full chunks
        n = 1 if len(new) == 1 else self.decode_steps
        hold = self._hold
        new_lanes = {lane for lane, _ in new}
        for lane, seq in self.running.items():
            if lane in new_lanes:
                continue  # admission allocated prompt + max_new up front
            if not self.manager.extend_seq(
                seq.seq_id, int(self.context_lens[lane]) + hold + n
            ):
                return None
            self._sync_table(lane, seq)
        wake = WakePlan(
            step=np.full((b,), -1, np.int32), tokens=np.zeros((b,), np.int32),
            ctx=np.zeros((b,), np.int32), prod=np.zeros((b,), np.int32),
            hist=self.histories.copy(),
        )
        h = HISTORY_LEN
        for lane, seq in new:
            wake.step[lane] = 0
            wake.tokens[lane] = seq.pending[-1]
            wake.ctx[lane] = seq.pending_base + len(seq.pending) - 1
            tail = seq.prompt_ids[-h:]
            wake.hist[lane] = PAD_TOKEN
            wake.hist[lane, -len(tail):] = tail
            seq.status = SeqStatus.DECODING
            # optimistic host mirrors (the drain advances them as in steady)
            self.context_lens[lane] = wake.ctx[lane]
            self.last_tokens[lane] = wake.tokens[lane]
            self.histories[lane] = wake.hist[lane]
            self.done[lane] = False
            self.produced[lane] = 0
            if (self.prefix_store is not None and not seq.prefix_cached
                    and seq.prompt_embeds is None):
                seq.prefix_cached = True
                self.prefix_store.insert(seq.prompt_ids,
                                         self.manager.block_table(seq.seq_id))
        emitted = self._run_chunk(n, wake=wake)
        finished = []
        while self._inflight:
            finished.extend(self._drain_inflight())
        self._chained = True
        self._inflight.append((emitted, n))
        return finished

    def _drain_inflight(self) -> list[Sequence]:
        """Read a pipelined chunk's emitted tokens (the one host read of the
        chunk) and rebuild the host mirrors from them: every active step
        emitted a non-PAD token, so per-lane counts recover ctx / produced
        and the values recover last / history."""
        if not self._inflight:
            return []
        emitted_dev, n = self._inflight.popleft()
        with profiling.span("pie.sched.readback"):
            emitted = emitted_dev.cpu().numpy()  # [n, B]
        h = HISTORY_LEN
        for lane in range(self.engine.num_lanes):
            seq = self.running.get(lane)
            if seq is None or seq.status != SeqStatus.DECODING:
                continue
            toks = emitted[:, lane]
            valid = toks[toks != PAD_TOKEN]
            cnt = len(valid)
            if cnt:
                self.last_tokens[lane] = valid[-1]
                self.histories[lane] = np.concatenate(
                    [self.histories[lane], valid])[-h:]
            self.context_lens[lane] += cnt
            self.produced[lane] += cnt
        return self._emit_chunk(emitted, n)

    def _emit_chunk(self, emitted: np.ndarray, n: int) -> list[Sequence]:
        """Hand a drained chunk's tokens to their free (machine-less)
        sequences, in step order; a cancellation (possibly raised by a
        callback during this drain) drops the lane's remaining tokens."""
        finished: list[Sequence] = []
        for lane in list(self.running.keys()):
            seq = self.running[lane]
            if seq.status != SeqStatus.DECODING or seq.machine is not None:
                continue
            for s in range(n):
                if seq.cancelled:
                    self._finish(seq, "cancelled")
                    finished.append(seq)
                    break
                tok = int(emitted[s, lane])
                if tok == PAD_TOKEN:
                    continue
                self._emit(seq, tok)
                if seq.status != SeqStatus.DECODING:
                    finished.append(seq)
                    break
            else:
                if seq.cancelled:
                    self._finish(seq, "cancelled")
                    finished.append(seq)
        return finished

    def _chunk_masks(self) -> Optional[tuple]:
        """The host masks of the constrained decoding lanes' next choice
        points: (allowed [B, V], valid [B]), or None when no lane carries
        a machine. Sets each such lane's sampling parameters to its
        machine's phase (state_kwargs)."""
        lanes = [(lane, s) for lane, s in self.running.items()
                 if s.machine is not None and s.status == SeqStatus.DECODING]
        if not lanes:
            return None
        b, v = self.engine.num_lanes, self.engine.model.config.vocab_size
        allowed = np.ones((b, v), bool)
        valid = np.zeros((b,), bool)
        for lane, seq in lanes:
            machine = seq.machine
            if seq.state_kwargs and hasattr(machine, "active_names"):
                phase = self._phase_params(seq)
                for k, val in zip(("temperature", "top_p", "min_p", "top_k"), phase):
                    val = self.samp[k].dtype.type(val)
                    if self.samp[k][lane] != val:
                        self.samp[k][lane] = val
                        self._lane_params = None
            if getattr(machine, "is_unconstrained", lambda: False)():
                continue  # a freeform phase samples unmasked
            m = seq.masker.build_mask(machine)
            allowed[lane] = False
            allowed[lane, :m.shape[0]] = m
            valid[lane] = True
        return allowed, valid

    def _dispatch_and_drain(self, plan, n: int) -> list[Sequence]:
        rider, wake = plan
        mask = self._chunk_masks()
        emitted = self._run_chunk(n, rider=rider, wake=wake, mask=mask)
        st = self.engine.lanes
        # one read of the device for the whole chunk: everything packed into
        # one int32 buffer
        b, h = self.engine.num_lanes, HISTORY_LEN
        packed = torch.cat([
            emitted.reshape(-1), st.last, st.ctx, st.hist.reshape(-1),
            st.done.to(torch.int32), st.prod,
        ])
        with profiling.span("pie.sched.readback"):
            packed = packed.cpu().numpy()
        cuts = np.cumsum([n * b, b, b, b * h, b])
        em, last, ctx, hist, done, prod = np.split(packed, cuts)
        self.last_tokens = last.copy()
        self.context_lens = ctx.copy()
        self.histories = hist.reshape(b, h).copy()
        self.done = done.astype(bool)
        self.produced = prod.copy()
        em = em.reshape(n, b)
        finished = []
        for lane, seq in list(self.running.items()):
            if seq.machine is not None and seq.status == SeqStatus.DECODING:
                if self._drain_constrained_lane(lane, seq, em, n,
                                                mask is not None and bool(mask[1][lane])):
                    finished.append(seq)
        return finished + self._emit_chunk(em, n)

    # -- planning --------------------------------------------------------

    def _direct_prefill(self):
        """Prefill long prompt bodies with dedicated programs (one pass over
        the weights per ``prefill_chunk`` tokens) instead of rider slices;
        short bodies ride mixed steps, which also advance every lane.
        Queued on the device without a read back."""
        e = self.engine
        for lane, seq in sorted(self.running.items()):
            if seq.status != SeqStatus.PREFILLING or seq.prompt_embeds is not None:
                continue  # an image prompt's embeddings ride mixed steps
            plen1 = len(seq.pending) - 1
            if plen1 - seq.prefill_pos <= DIRECT_PREFILL_MIN:
                continue
            while plen1 - seq.prefill_pos > 0:
                c = min(e.prefill_chunk, plen1 - seq.prefill_pos)
                bucket = 16
                while bucket < c:
                    bucket *= 2
                bucket = min(bucket, e.prefill_chunk)
                if not self.manager.extend_seq(
                    seq.seq_id, seq.pending_base + seq.prefill_pos + c
                ):
                    self._finish(seq, "error: out of pages")
                    break
                self._sync_table(lane, seq)
                ids = np.zeros((1, bucket), np.int32)
                pos = np.full((1, bucket), -1, np.int32)
                ids[0, :c] = seq.pending[seq.prefill_pos:seq.prefill_pos + c]
                pos[0, :c] = seq.pending_base + np.arange(
                    seq.prefill_pos, seq.prefill_pos + c)
                e._prefill(
                    e.params, ids, pos, self.block_tables[lane:lane + 1],
                    np.full((1,), seq.pending_base + seq.prefill_pos + c, np.int32),
                )
                seq.prefill_pos += c
                self.context_lens[lane] = seq.pending_base + seq.prefill_pos

    def _admit(self):
        while self.waiting and self.free_lanes:
            seq = self.waiting[0]
            if seq.cancelled:
                self.waiting.popleft()
                self._finish(seq, "cancelled")
                continue
            need = len(seq.prompt_ids) + seq.max_new_tokens
            if self.manager.pages_needed(need) > self.engine.max_pages_per_seq:
                self.waiting.popleft()
                self._finish(seq, "error: sequence exceeds max pages")
                continue
            # prefix-cache hit: splice the cached full pages into the new
            # table (refcounted, never written by this lane) and prefill only
            # the suffix
            store = self.prefix_store
            # an image prompt's placeholder ids do not identify its image
            share = store is not None and seq.prompt_embeds is None
            while True:
                shared = store.match(seq.prompt_ids) if share else []
                if self.manager.allocate_seq_with_prefix(seq.seq_id, need, shared):
                    break
                shortfall = self.manager.pages_needed(need) - len(shared)
                if store is None or store.evict(shortfall) == 0:
                    shared = None
                    break
            if shared is None:
                break  # pool exhausted: stay queued
            self.waiting.popleft()
            lane = self.free_lanes.pop()
            seq.lane = lane
            seq.t_admit = time.perf_counter_ns()
            seq.status = SeqStatus.PREFILLING
            seq.prefill_pos = 0
            seq.pending = list(seq.prompt_ids[len(shared) * PAGE_SIZE:])
            seq.pending_base = len(shared) * PAGE_SIZE
            self.running[lane] = seq
            table = self.manager.block_table(seq.seq_id)
            self.block_tables[lane] = -1
            self.block_tables[lane, :len(table)] = table
            self.context_lens[lane] = seq.pending_base
            self.histories[lane] = PAD_TOKEN
            self.done[lane] = True  # frozen until its wake step
            self.produced[lane] = 0
            self.max_new[lane] = seq.max_new_tokens
            self.stop_ids[lane] = -1
            sids = list(seq.stop_token_ids)[:MAX_STOP_IDS]
            self.stop_ids[lane, :len(sids)] = sids
            self.samp["temperature"][lane] = seq.temperature
            self.samp["top_p"][lane] = seq.top_p
            self.samp["min_p"][lane] = seq.min_p
            self.samp["top_k"][lane] = seq.top_k
            self.samp["xtc_probability"][lane] = seq.xtc_probability
            self.samp["xtc_threshold"][lane] = seq.xtc_threshold
            self.pen["repetition"][lane] = seq.repetition_penalty
            self.pen["presence"][lane] = seq.presence_penalty
            self.pen["frequency"][lane] = seq.frequency_penalty
            self.pen["dry_multiplier"][lane] = seq.dry_multiplier
            self.pen["dry_base"][lane] = seq.dry_base
            self.pen["dry_allowed"][lane] = seq.dry_allowed_length
            self.bias_ids[lane] = -1
            self.bias_vals[lane] = 0.0
            self.pos_delta[lane] = seq.pos_delta
            for i, (tid, bv) in enumerate(sorted(seq.logit_bias.items())[:MAX_BIAS]):
                self.bias_ids[lane, i] = int(tid)
                self.bias_vals[lane, i] = float(bv)
            self._lane_params = None

    def _plan_chunk(self, n: int):
        """The host plan of one chunk: rider slices (one lane's prompt per
        step), the wake schedule of lanes whose prefill completes, and page
        pre-allocation. None when there is nothing to run."""
        e = self.engine
        cs = e.rider_width
        b = e.num_lanes
        rider = RiderPlan(
            ids=np.full((n, cs), -1, np.int32), pos=np.full((n, cs), -1, np.int32),
            lane=np.zeros((n,), np.int32), ctx=np.zeros((n,), np.int32),
            pos3=np.full((n, 3, cs), -1, np.int32) if e.mrope else None,
            embeds=[None] * n,
        )
        wake = WakePlan(
            step=np.full((b,), -1, np.int32), tokens=np.zeros((b,), np.int32),
            ctx=np.zeros((b,), np.int32), prod=np.zeros((b,), np.int32),
            hist=self.histories.copy(),
        )

        # cancelled lanes are finished host-side before planning
        for lane, seq in list(self.running.items()):
            if seq.cancelled:
                self._finish(seq, "cancelled")

        prefilling = [(lane, s) for lane, s in sorted(self.running.items())
                      if s.status == SeqStatus.PREFILLING]

        def wake_at(lane, seq, s):
            # the final pending token becomes the lane's decode input at this
            # very step (the rider slice's KV is written before the lanes'
            # attention reads it)
            wake.step[lane] = s
            wake.tokens[lane] = seq.pending[-1]
            wake.ctx[lane] = seq.pending_base + len(seq.pending) - 1
            tail = (seq.prompt_ids + seq.output_ids)[-HISTORY_LEN:]
            wake.hist[lane] = PAD_TOKEN
            wake.hist[lane, -len(tail):] = tail
            seq.status = SeqStatus.DECODING
            self.produced[lane] = len(seq.output_ids)
            wake.prod[lane] = self.produced[lane]
            if (self.prefix_store is not None and not seq.prefix_cached
                    and seq.prompt_embeds is None
                    and seq.pending_base + len(seq.pending) == len(seq.prompt_ids)):
                # this very chunk writes the prompt's KV; device order makes
                # it visible before any later chunk reads it
                seq.prefix_cached = True
                self.prefix_store.insert(seq.prompt_ids,
                                         self.manager.block_table(seq.seq_id))

        qi = iter(prefilling)
        cur = next(qi, None)
        for s in range(n):
            while cur is not None:
                lane, seq = cur
                base = seq.pending_base
                rem = len(seq.pending) - 1 - seq.prefill_pos
                if rem <= 0:
                    # nothing left to prefill: wake without using the slice
                    wake_at(lane, seq, s)
                    cur = next(qi, None)
                    continue
                cnt = min(cs, rem)
                rider.ids[s, :cnt] = seq.pending[seq.prefill_pos:seq.prefill_pos + cnt]
                rider.pos[s, :cnt] = base + np.arange(seq.prefill_pos,
                                                      seq.prefill_pos + cnt)
                if rider.pos3 is not None:
                    rider.pos3[s, :, :cnt] = _pos3_slice(seq, rider.pos[s, :cnt])
                if seq.prompt_embeds is not None and base == 0:
                    # the image prompt's slice: its embeddings, not its ids'
                    rider.embeds[s] = (seq.prompt_embeds, seq.prefill_pos, cnt)
                rider.lane[s] = lane
                seq.prefill_pos += cnt
                rider.ctx[s] = base + seq.prefill_pos
                self.context_lens[lane] = base + seq.prefill_pos
                if seq.prefill_pos >= len(seq.pending) - 1:
                    wake_at(lane, seq, s)
                    cur = next(qi, None)
                break  # this step's rider slice is used

        decoding = [lane for lane, s in self.running.items()
                    if s.status == SeqStatus.DECODING]
        if not decoding and not prefilling:
            return None

        # pages for every token this chunk can write
        for lane in decoding:
            seq = self.running[lane]
            woken = wake.step[lane] >= 0
            start = int(wake.ctx[lane]) if woken else int(self.context_lens[lane])
            steps = n - max(int(wake.step[lane]), 0)
            if not self.manager.extend_seq(seq.seq_id, start + steps):
                self._finish(seq, "error: out of pages")
                wake.step[lane] = -1
                continue
            self._sync_table(lane, seq)
        dead = set()
        for lane, seq in prefilling:
            if seq.status == SeqStatus.PREFILLING:
                if not self.manager.extend_seq(seq.seq_id,
                                               seq.pending_base + seq.prefill_pos):
                    self._finish(seq, "error: out of pages")
                    dead.add(lane)
                    continue
                self._sync_table(lane, seq)
        for s in range(n):
            if dead and int(rider.lane[s]) in dead and (rider.ids[s] >= 0).any():
                # the failed lane's pages are freed: its slices must not write
                rider.ids[s] = -1
                rider.pos[s] = -1
                rider.lane[s] = 0
                rider.ctx[s] = 0
                rider.embeds[s] = None
                if rider.pos3 is not None:
                    rider.pos3[s] = -1
        return rider, wake

    def _sync_table(self, lane: int, seq: Sequence):
        table = self.manager.block_table(seq.seq_id)
        self.block_tables[lane, :len(table)] = table

    # -- constrained lanes -------------------------------------------------

    def _phase_params(self, seq: Sequence) -> tuple:
        """The sampling parameters the lane's current machine phase sets
        (temperature, top_p, min_p, top_k), from its state_kwargs."""
        kw: dict = {}
        for name in sorted(seq.machine.active_names()):
            kw.update(seq.state_kwargs.get(name, {}))
        return (kw.get("temperature", seq.temperature), kw.get("top_p", seq.top_p),
                kw.get("min_p", seq.min_p), kw.get("top_k", seq.top_k))

    def _drain_constrained_lane(self, lane: int, seq: Sequence, emitted, n: int,
                                first_masked: bool) -> bool:
        """Accept the longest machine-valid prefix of a constrained lane's
        chunk tokens, then reset the lane's host mirrors to the host's truth
        (the rejected tail rolled back); the next chunk uploads them into
        the static lane state. Only the first token was sampled under the
        mask; a later one the machine rejects ends the prefix, and so does
        a phase switch that changes the lane's sampling parameters (the
        tail was sampled under the old phase's). Returns True when the
        sequence finished."""
        phase0 = (self._phase_params(seq)
                  if seq.state_kwargs and hasattr(seq.machine, "active_names")
                  else None)
        first = True
        for s in range(n):
            if seq.cancelled:
                self._finish(seq, "cancelled")
                return True
            tok = int(emitted[s, lane])
            if tok == PAD_TOKEN:
                continue
            accepted = self._emit_constrained(seq, tok, masked=first and first_masked)
            first = False
            if seq.status == SeqStatus.PREFILLING:
                # re-armed with a forced run: its rider slice or direct
                # prefill and its wake rebuild the lane; the rest of the
                # chunk was sampled before the run existed
                return False
            if seq.status != SeqStatus.DECODING:
                return True  # stop, length, complete, error or cancelled
            if not accepted:
                break  # speculation rejected: roll the tail back
            if phase0 is not None and self._phase_params(seq) != phase0:
                break
        if seq.cancelled:
            self._finish(seq, "cancelled")
            return True
        self._resync_lane(lane, seq)
        return False

    def _resync_lane(self, lane: int, seq: Sequence):
        """Reset a decoding lane's host mirrors from the host's truth: the
        pool holds every token but the newest, which is the next decode
        input (as at a wake). KV written past that point is dead: attention
        reads up to the context length, and real tokens overwrite it."""
        toks = seq.prompt_ids + seq.output_ids
        self.context_lens[lane] = len(toks) - 1
        self.last_tokens[lane] = toks[-1]
        tail = toks[-HISTORY_LEN:]
        self.histories[lane] = PAD_TOKEN
        self.histories[lane, -len(tail):] = tail
        self.produced[lane] = len(seq.output_ids)
        self.done[lane] = False

    def _emit_constrained(self, seq: Sequence, tok: int, masked: bool = True) -> bool:
        """Advance a constrained lane by one sampled token: check it against
        the machine (on a copy, kept only if it accepts), emit it, then
        follow the forced-token path: a run of characters the machine fixes
        is encoded on the host, emitted with no sampling, and its KV rides
        the next chunk's rider (or a direct prefill) as the lane's new
        ``pending``. ``masked``: the token was sampled under the lane's
        mask, so a rejection is an error finish; an unmasked (speculative)
        token the machine rejects returns False and the caller rolls back.
        Returns whether the token was accepted."""
        machine, masker = seq.machine, seq.masker
        if tok in seq.stop_token_ids:
            self._emit(seq, tok)
            return True
        tstr = masker.token_strs[tok] if tok < masker.vocab_size else None
        if tstr is None and getattr(machine, "is_unconstrained", lambda: False)():
            # an undecodable (partial UTF-8) token in a freeform phase:
            # emitted without advancing the machine
            self._emit(seq, tok)
            return True
        probe = machine.copy() if tstr is not None else None
        if tstr is None or not probe.advance(tstr):
            if not masked:
                return False
            logger.warning("constrained decoding: token %d (%r) rejected", tok, tstr)
            self._finish(seq, "error: constrained decoding produced invalid token")
            return False
        seq.machine = machine = probe
        self._emit(seq, tok)
        if seq.status != SeqStatus.DECODING:
            return True
        if machine.is_complete:
            self._finish(seq, "stop")
            return True

        forced: list[int] = []
        chars = forced_run(machine)
        if chars:
            # host truth, not the mirror (which holds the chunk's end)
            ctx_true = len(seq.prompt_ids) + len(seq.output_ids) - 1
            budget = min(seq.max_new_tokens - len(seq.output_ids),
                         self.engine.max_pages_per_seq * PAGE_SIZE - ctx_true - 1)
            for fid in masker.encode_longest(chars)[:max(0, budget)]:
                if not machine.advance(masker.token_strs[fid]):
                    break  # keep the machine and the output consistent
                forced.append(fid)
                if machine.is_complete:
                    break
        if not forced:
            return True
        # the sampled token's KV goes at (total tokens - 1) before the run
        base = len(seq.prompt_ids) + len(seq.output_ids) - 1
        for fid in forced:
            self._emit(seq, fid)  # may finish (stop token or length)
            if seq.status != SeqStatus.DECODING:
                return True
        if machine.is_complete:
            self._finish(seq, "stop")
            return True
        # [sampled, *forced] need KV at base..; the last forced token wakes
        seq.pending = [tok] + forced
        seq.pending_base = base
        seq.prefill_pos = 0
        seq.status = SeqStatus.PREFILLING
        self.done[seq.lane] = True  # frozen until its wake step
        return True

    def _emit(self, seq: Sequence, tok: int):
        if not seq.output_ids:
            seq.t_first = time.perf_counter_ns()
        seq.output_ids.append(tok)
        if seq.on_token:
            try:
                seq.on_token(seq, tok)
            except Exception:  # pragma: no cover
                logger.exception("on_token callback failed")
        if tok in seq.stop_token_ids:
            self._finish(seq, "stop")
        elif len(seq.output_ids) >= seq.max_new_tokens:
            self._finish(seq, "length")

    def _finish(self, seq: Sequence, reason: str):
        seq.finish_reason = reason
        seq.status = (
            SeqStatus.CANCELLED if reason == "cancelled"
            else SeqStatus.ERROR if reason.startswith("error")
            else SeqStatus.COMPLETED
        )
        if seq.lane >= 0:
            self.running.pop(seq.lane, None)
            self.free_lanes.append(seq.lane)
            self.block_tables[seq.lane] = -1
            self.context_lens[seq.lane] = 0
            # freeze the lane so the next chunk cannot write into its (now
            # freed, possibly re-allocated) pages
            self.done[seq.lane] = True
            seq.lane = -1
        self.manager.free_seq(seq.seq_id)
        if seq.on_finish:
            try:
                seq.on_finish(seq)
            except Exception:  # pragma: no cover
                logger.exception("on_finish callback failed")


def _penalize(logits, hist, pen: PenaltyParams):
    """Repetition, then presence / frequency penalties over ``hist`` (the
    native programs' processors; they carry no DRY, which the native
    scheduler refuses)."""
    logits = repetition_penalty(logits, hist, pen.repetition)
    return presence_frequency_penalty(logits, hist, pen.presence, pen.frequency)


def _pos3_slice(seq: Sequence, pos: np.ndarray) -> np.ndarray:
    """[3, k] M-RoPE streams of one sequence's pool positions ``pos``: the
    prompt's positions read its streams (``seq.positions3``), later ones
    run at pos - pos_delta on all three (text: the positions)."""
    out = np.broadcast_to((pos - seq.pos_delta)[None], (3, len(pos))).astype(np.int32)
    if seq.positions3 is not None:
        plen = seq.positions3.shape[1]
        idx = np.clip(pos, 0, plen - 1)
        out = np.where((pos < plen)[None], seq.positions3[:, idx], out)
    return out


def _bucket_chunk(n: int, max_chunk: int) -> int:
    """Round a chunk step count up to the next power of two (capped)."""
    c = 1
    while c < n:
        c *= 2
    return min(c, max_chunk)
