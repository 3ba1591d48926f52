"""Paged prefill attention: the hand-written CUDA kernel K5 and the route
that sends a prefill chunk's attention to it.

K5 (``csrc/paged_prefill_attention.cu``) replaces no TPU kernel: the JAX
package runs a prefill chunk's attention as plain XLA ops, and the port's
plain version of it is ``models.llama.gathered_attention`` (the chunk's
pages gathered to dense K/V, then ``sdpa_quantized``'s masked f32
attention). It was added because the H100 profile of the served Qwen cells
named that plain form: every chunk covered its lane's whole block table.

K5 computes the same function over the paged INT8 pool at head dim 128:
row (token t, query head) attends key slot s iff ``s < ctx``, ``s <=
positions[t]`` and the table's page for s is not -1; the score is bf16 q
times the INT8 K codes widened exactly to bf16 with f32 accumulation, times
``scale * k_scale[s]`` in f32; the softmax is online in f32; the
probabilities times ``v_scale[s]`` are rounded once to bf16 for PV (f32
accumulation); the output is divided by the running sum and rounded once to
bf16. A pad row (position -1) gets zeros (the plain version's pad rows hold
an average nobody reads). ``csrc/paged_prefill_attention.cu`` says how.

``uses_k5`` is the route: K5 serves a CUDA tensor over an INT8 pool at head
dim 128; head dims 64 and 256 and bf16 pools keep ``gathered_attention``,
whose register and shared-memory budgets differ, and a CPU tensor always
runs the plain version (Gemma-3's windowed prefill never asks). A CUDA call
that K5 takes launches it or raises.
"""

from __future__ import annotations

import ctypes
import torch

from pie_tpu_torch.cache.paged import PAGE_SIZE
from pie_tpu_torch.ops import quant_matmul_cuda as qmc

HEAD_DIM = 128
#: query rows ((token, query head) pairs of one kv head) a K5 block owns
ROWS = 128
#: K5 splits a row tile's page walk until the grid fills one wave of this
#: many SMs (132: an H100 SXM), each split walking at least
#: MIN_PAGES_PER_SPLIT pages (the kernel drops splits a short walk leaves
#: empty)
TARGET_BLOCKS = 132
MIN_PAGES_PER_SPLIT = 4

_counters: dict = {}  # per device: K5's zeroed arrival counters
#: counters a larger set replaced: a CUDA graph captured over them still
#: uses them at every replay, so they are never freed
_retired: list = []


def uses_k5(pool, head_dim: int, device) -> bool:
    """Whether a prefill chunk's attention over ``pool`` runs K5: a CUDA
    device, an INT8 pool and head dim 128. Everything else runs
    ``gathered_attention``."""
    return (torch.device(device).type == "cuda" and pool.quantized
            and pool.k.dtype == torch.int8 and head_dim == HEAD_DIM)


def launch_plan(batch: int, tokens: int, hq: int, hkv: int, max_pages: int) -> dict:
    """K5's grid for a chunk of ``tokens`` tokens: row tiles of ROWS
    (token, head) rows a kv head, and page splits until the grid fills one
    wave of TARGET_BLOCKS (from shapes only: the positions and context
    lengths stay on the card)."""
    tiles = -(-tokens * (hq // hkv) // ROWS)
    base = batch * hkv * tiles
    splits = max(1, min(max_pages // MIN_PAGES_PER_SPLIT, TARGET_BLOCKS // base))
    return dict(tiles=tiles, splits=splits, blocks=base * splits)


def k5_geometry(device) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared memory
    bytes and resident blocks an SM of K5, from the kernel itself."""
    geo = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = qmc.kernel("prefill_attention_geometry")(geo)
    if err:
        raise RuntimeError(f"K5 geometry query failed: CUDA error {err}")
    return dict(registers=geo[0], local_bytes=geo[1], smem_bytes=geo[2],
                blocks_per_sm=geo[3])


def _arrival_counters(device, n: int) -> torch.Tensor:
    counters = _counters.get(device)
    if counters is None or counters.numel() < n:
        if counters is not None:
            _retired.append(counters)
        counters = torch.zeros(max(4096, n), dtype=torch.int32, device=device)
        _counters[device] = counters
    return counters


def prefill_attention_cuda(q, pool, layer: int, tables, positions, context_lens,
                           scale: float) -> torch.Tensor:
    """K5: masked attention of q [B, T, Hq, 128] bf16 (batch and token
    strides free, heads and head dim contiguous) over layer ``layer`` of the
    INT8 pool through ``tables`` [B, maxP] int32, rows at ``positions``
    [B, T] int32 (-1 = pad row), ``context_lens`` [B] int32 tokens in the
    pool. Returns [B, T, Hq, 128] bf16."""
    b, t, hq, d = q.shape
    nl, ptot, hkv, page, dk = pool.k.shape
    if d != HEAD_DIM or dk != HEAD_DIM or page != PAGE_SIZE or hq % hkv:
        raise ValueError(f"K5 takes head_dim {HEAD_DIM}, {PAGE_SIZE}-token pages and "
                         f"Hkv | Hq; got D={d}, pool D={dk}, page={page}, Hq={hq}, Hkv={hkv}")
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError(f"q must be a bf16 CUDA tensor, got {q.dtype} on {q.device}")
    if q.stride(3) != 1 or q.stride(2) != d or q.data_ptr() % 4:
        raise ValueError("q's heads and head dim must be contiguous")
    check = qmc._check
    check(pool.k, "pool.k", torch.int8)
    check(pool.v, "pool.v", torch.int8, tuple(pool.k.shape))
    if not pool.quantized:
        raise ValueError("K5 takes an INT8 pool with its scales")
    check(pool.k_scale, "k_scale", torch.float32, (nl, ptot, hkv, page))
    check(pool.v_scale, "v_scale", torch.float32, (nl, ptot, hkv, page))
    maxp = tables.shape[1]
    check(tables, "tables", torch.int32, (b, maxp))
    for x, name, shape in ((positions, "positions", (b, t)),
                           (context_lens, "context_lens", (b,))):
        if (x.device != q.device or x.dtype != torch.int32 or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 {shape} tensor on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    layer = int(layer)
    if not 0 <= layer < nl:
        raise IndexError(f"layer {layer} of {nl}")
    plan = launch_plan(b, t, hq, hkv, maxp)
    splits = plan["splits"]
    out = torch.empty((b, t, hq, d), dtype=torch.bfloat16, device=q.device)
    ws = counters = None
    if splits > 1:
        slots = b * hkv * plan["tiles"]
        ws = torch.empty((slots * splits, ROWS, d + 2), dtype=torch.float32,
                         device=q.device)
        counters = _arrival_counters(q.device, slots)
    ptr = qmc._ptr
    err = qmc.kernel("prefill_attention")(
        q.data_ptr(), pool.k.data_ptr(), pool.v.data_ptr(), pool.k_scale.data_ptr(),
        pool.v_scale.data_ptr(), tables.data_ptr(), positions.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), ptr(ws), ptr(counters),
        q.stride(0), q.stride(1), b, t, hq, hkv, ptot, maxp, layer, splits,
        float(scale), torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"K5 (prefill_attention) launch failed: CUDA error {err}")
    qmc.launch_counts["K5"] += 1
    return out
