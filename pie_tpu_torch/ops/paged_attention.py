"""Paged decode attention: the hand-written CUDA kernel K3 and the plain
PyTorch version beside it.

Replaces both TPU kernels of ``pie_tpu/ops/paged_attention.py``:
``paged_attention_decode`` (``_decode_kernel`` over one layer's pool) and
``paged_attention_decode_stacked`` (the layer applied inside the page
fetch). On the card the layer is a pointer offset, ``layer * P + page``,
so the two are one kernel over the full ``[L, P + 1, Hkv, PAGE, D]`` pool
and the port never slices a layer out. The TPU's ``fold`` and its lane
constraints (``decode_kernel_supported``) have no counterpart: K3 takes
head dims 64, 128 and 256 and any ``Hq / Hkv`` up to 16 (32 at D = 64),
INT8 pages at Hkv = 1 included (Gemma-3 1B's MQA, which the JAX package
sends to XLA: its Mosaic scale view needs Hkv x 64 to be a multiple of
128).

One query per sequence attends over the 64-token pages its block table
names (-1 pads read page 0), with an online softmax in f32:

1. q is scaled by ``scale`` in f32 first;
2. the score is q . k in f32, times ``k_scale[token]`` for INT8 pages;
3. invalid scores are ``NEG_INF = -0.7 * f32 max`` (not -inf); a token is
   valid iff ``pos < ctx`` and ``pos >= lo``, ``lo = max(ctx - window, 0)``
   when ``window > 0`` else 0;
4. only pages ``[lo // 64, ceil(ctx / 64))`` are walked;
5. ``l`` sums the unscaled probabilities; for INT8 the probabilities are
   multiplied by ``v_scale[token]`` for the PV product only;
6. ``out = acc / max(l, 1e-30)``.

``paged_attention_ref`` is the plain version of exactly that (the CPU path
and the kernel checks use it); ``paged_attention_decode`` routes a CPU
tensor to it and a CUDA tensor to K3 (or raises).

K3 runs QK and PV on the tensor cores (``mma.sync``, the probabilities
rounded for PV as two bf16 terms). At D = 64 / 128 each warp of a block
walks its own pages over a ``cp.async`` double buffer; at D = 256 (B8,
Gemma-3) a kernel of its own streams the block's pages through a TMA ring
and deals each page's tokens to its warps in 16-token slices, with the
query heads on the n side of the mma. ``csrc/paged_attention.cu`` says
how. ``launch_plan`` gives the geometry of a call.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pie_tpu_torch.cache.paged import PAGE_SIZE
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.ops.attention import NEG_INF

#: K3 splits each lane's page walk until the grid is one wave of this many
#: SMs times K3's resident blocks per SM (132: the SMs of an H100 SXM)
TARGET_BLOCKS = 132
HEAD_DIMS = (64, 128, 256)
#: query heads per kv head that one m16 tile of K3's mma holds (two tiles,
#: 32 heads, at D = 64)
MAX_GROUP = 16

_counters: dict = {}  # per device: K3's zeroed arrival counters
#: counters a larger set replaced: a CUDA graph captured over them still
#: uses them at every replay, so they are never freed
_retired: list = []
_geometry: dict = {}  # per (device, D, quantized, rep): K3's block geometry


def paged_attention_ref(
    q: torch.Tensor,  # [B, Hq, D]
    pool_k: torch.Tensor,  # [L, P(+1), Hkv, PAGE, D]
    pool_v: torch.Tensor,
    k_scale: Optional[torch.Tensor],  # [L, P(+1), Hkv, PAGE] f32 or None
    v_scale: Optional[torch.Tensor],
    layer: int,
    block_tables: torch.Tensor,  # [B, maxP] int32 (-1 pad)
    context_lens: torch.Tensor,  # [B] int32
    scale: float,
    window: int = 0,
) -> torch.Tensor:
    """Plain version of K3 (semantics in the module docstring): gathers
    the lanes' pages densely and masks. Returns [B, Hq, D] in q.dtype."""
    b, hq, d = q.shape
    hkv = pool_k.shape[2]
    rep = hq // hkv
    bt = torch.clamp(block_tables, min=0).long()
    k = pool_k[layer][bt].to(torch.float32)  # [B, maxP, Hkv, PAGE, D]
    v = pool_v[layer][bt].to(torch.float32)
    mp = bt.shape[1]
    qg = q.reshape(b, hkv, rep, d).to(torch.float32) * scale
    s = torch.einsum("bhrd,bphtd->bhrpt", qg, k)  # [B, Hkv, rep, maxP, PAGE]
    if k_scale is not None:
        s = s * k_scale[layer][bt].permute(0, 2, 1, 3)[:, :, None]
    pos = torch.arange(mp * PAGE_SIZE, device=q.device).reshape(mp, PAGE_SIZE)
    ctx = context_lens.to(torch.int64)[:, None, None]
    lo = torch.clamp(ctx - window, min=0) if window > 0 else torch.zeros_like(ctx)
    valid = (pos[None] < ctx) & (pos[None] >= lo)  # [B, maxP, PAGE]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    s = s.reshape(b, hkv, rep, mp * PAGE_SIZE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        vs = v_scale[layer][bt].permute(0, 2, 1, 3).reshape(b, hkv, 1, -1)
        p = p * vs
    v = v.permute(0, 2, 1, 3, 4).reshape(b, hkv, mp * PAGE_SIZE, d)
    out = torch.einsum("bhrs,bhsd->bhrd", p, v) / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, d).to(q.dtype)


def page_splits(batch: int, hkv: int, max_pages: int, blocks_per_sm: int = 1) -> int:
    """Blocks per (lane, kv head) of K3: split the page walk until the grid
    fills one wave of TARGET_BLOCKS x ``blocks_per_sm`` resident blocks, and
    no further (a second, partial wave would wait for the first). Chosen
    from shapes only (the context lengths stay on the card)."""
    return max(1, min(max_pages, TARGET_BLOCKS * blocks_per_sm // (batch * hkv)))


def k3_geometry(device, d: int, quantized: bool, rep: int) -> dict:
    """Warps per block, stages (cp.async stages per warp at D 64 / 128,
    ring stages per block at D 256), resident blocks per SM, registers a
    thread and local (spill) bytes a thread of the K3 kernel that serves
    these heads, from the kernel itself."""
    key = (device, d, quantized, rep)
    if key not in _geometry:
        geo = (ctypes.c_int * 5)()
        with torch.cuda.device(device):
            err = qmc.kernel("paged_attention_geometry")(d, int(quantized), rep, geo)
        if err:
            raise RuntimeError(f"K3 geometry query failed: CUDA error {err}")
        _geometry[key] = dict(warps=geo[0], stages=geo[1], blocks_per_sm=geo[2],
                              registers=geo[3], local_bytes=geo[4])
    return _geometry[key]


def launch_plan(device, batch: int, hq: int, hkv: int, d: int, max_pages: int,
                quantized: bool) -> dict:
    """K3's launch for a call: its geometry, the page splits, the blocks of
    the grid and how the probabilities are rounded for PV."""
    geo = k3_geometry(device, d, quantized, hq // hkv)
    splits = page_splits(batch, hkv, max_pages, geo["blocks_per_sm"])
    return dict(geo, splits=splits, blocks=batch * hkv * splits, p_round="bf16 hi + lo")


def paged_attention_cuda(q, pool_k, pool_v, k_scale, v_scale, layer,
                         block_tables, context_lens, scale, window=0):
    """K3 on CUDA tensors (contract of ``paged_attention_decode``)."""
    b, hq, d = q.shape
    nl, ptot, hkv, page, _ = pool_k.shape
    if (d not in HEAD_DIMS or page != PAGE_SIZE or hq % hkv
            or hq // hkv > (2 * MAX_GROUP if d == 64 else MAX_GROUP)):
        raise ValueError(
            f"K3 takes head_dim {HEAD_DIMS}, {PAGE_SIZE}-token pages, Hkv | Hq "
            f"and Hq / Hkv <= {MAX_GROUP} (32 at D = 64); got D={d}, page={page}, "
            f"Hq={hq}, Hkv={hkv}")
    check = qmc._check
    check(q, "q", torch.bfloat16, (b, hq, d))
    quantized = pool_k.dtype == torch.int8
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    check(pool_k, "pool_k", kv_dtype, (nl, ptot, hkv, page, d))
    check(pool_v, "pool_v", kv_dtype, (nl, ptot, hkv, page, d))
    if quantized != (k_scale is not None and v_scale is not None):
        raise ValueError("an INT8 pool takes k_scale and v_scale, a bf16 pool neither")
    if quantized:
        check(k_scale, "k_scale", torch.float32, (nl, ptot, hkv, page))
        check(v_scale, "v_scale", torch.float32, (nl, ptot, hkv, page))
    maxp = block_tables.shape[1]
    check(block_tables, "block_tables", torch.int32, (b, maxp))
    check(context_lens, "context_lens", torch.int32, (b,))
    layer = int(layer)
    if not 0 <= layer < nl:
        raise IndexError(f"layer {layer} of {nl}")
    rep = hq // hkv
    splits = launch_plan(q.device, b, hq, hkv, d, maxp, quantized)["splits"]
    out = torch.empty((b, hq, d), dtype=torch.bfloat16, device=q.device)
    ws = counters = None
    if splits > 1:
        # a (lane, head, split)'s partial: rep * (d + 2) floats, 16-byte rows
        ws = torch.empty((b * hkv * splits, -(-rep * (d + 2) // 4) * 4),
                         dtype=torch.float32, device=q.device)
        counters = _counters.get(q.device)
        if counters is None or counters.numel() < b * hkv:
            if counters is not None:
                _retired.append(counters)
            counters = torch.zeros(max(4096, b * hkv), dtype=torch.int32,
                                   device=q.device)
            _counters[q.device] = counters
    ptr = qmc._ptr
    err = qmc.kernel("paged_attention")(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), ptr(k_scale),
        ptr(v_scale), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), ptr(ws), ptr(counters), b, hq, hkv, d, ptot, maxp,
        layer, int(quantized), int(window), float(scale), splits,
        torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"K3 (paged_attention) launch failed: CUDA error {err}")
    qmc.launch_counts["K3"] += 1
    return out


def paged_attention_decode(q, pool_k, pool_v, k_scale, v_scale, layer,
                           block_tables, context_lens, scale, window=0):
    """Decode attention over the paged pool (module docstring).

    q [B, Hq, D]; pool_k / pool_v [L, P(+1), Hkv, PAGE, D] bf16 or int8;
    scales [L, P(+1), Hkv, PAGE] f32 (None for bf16); layer an int;
    block_tables [B, maxP] int32; context_lens [B] int32; window <= 0 is
    full attention. A CPU tensor runs the plain version; a CUDA tensor
    launches K3 or raises."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, pool_k, pool_v, k_scale, v_scale, layer,
                                   block_tables, context_lens, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    return paged_attention_cuda(q, pool_k, pool_v, k_scale, v_scale, layer,
                                block_tables, context_lens, scale, window)

