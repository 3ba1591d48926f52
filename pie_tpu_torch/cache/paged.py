"""Paged KV cache pool: the device-side pool and the host-side page tables.

Port of the JAX package's ``pie_tpu/cache/paged.py``. The pool is one
global array per K/V, ``[L, P + 1, Hkv, PAGE, Dh]`` (head-major, so one
page of one head is a contiguous ``PAGE x Dh`` tile for the attention
kernel); sequences own page-id lists handed out by the ``PageAllocator``
and batches address the pool through block tables ``[B, maxP]`` (-1 pad).

Differences from the JAX pool, both deliberate:

- INT8 scales are kept in natural order ``[L, P + 1, Hkv, PAGE]`` f32. The
  JAX pool's phase-major ``fold`` layout exists for TPU lanes;
  ``unpermute_page_scales`` of the JAX scales equals these.
- Page ``P`` (one past the last allocatable page) is a **scratch page**: no
  block table ever names it, and every write that JAX drops with
  ``mode="drop"`` (pads, frozen lanes, position -1, unmapped pages) lands
  there instead. Writes then need no mask, so no count is read back to
  the host. Only pages ``[0, P)`` hold data.

The pool is updated IN PLACE by the model forward (PyTorch has no buffer
donation); ``write_tokens`` returns the same pool object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pie_tpu_torch.cache.kv_cache import quantize_kv
from pie_tpu_torch.runtime import TOKENS_PER_PAGE, PageAllocator

PAGE_SIZE = TOKENS_PER_PAGE


@dataclasses.dataclass(frozen=True)
class PagedKVPool:
    """Device-side page pool.

    k, v: [L, P + 1, Hkv, PAGE_SIZE, Dh] (bf16 / f32, or int8 when quantized)
    k_scale, v_scale: [L, P + 1, Hkv, PAGE_SIZE] f32 when quantized, else None
    Page P is the scratch page (see the module docstring).
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]

    @classmethod
    def create(
        cls, num_layers: int, num_pages: int, num_kv_heads: int,
        head_dim: int, dtype=torch.bfloat16, quantized: bool = False,
        *, device,
    ) -> "PagedKVPool":
        shape = (num_layers, num_pages + 1, num_kv_heads, PAGE_SIZE, head_dim)
        store = torch.int8 if quantized else dtype
        scales = None
        if quantized:
            scales = [torch.zeros(shape[:4], dtype=torch.float32, device=device)
                      for _ in range(2)]
        return cls(
            k=torch.zeros(shape, dtype=store, device=device),
            v=torch.zeros(shape, dtype=store, device=device),
            k_scale=scales[0] if scales else None,
            v_scale=scales[1] if scales else None,
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_pages(self) -> int:
        """Allocatable pages; the scratch page has this index."""
        return self.k.shape[1] - 1


class PagedCacheManager:
    """Host-side page bookkeeping for a set of sequences: per-sequence page
    tables over a refcounted ``PageAllocator``."""

    def __init__(self, num_pages: int, max_pages_per_seq: int):
        self.allocator = PageAllocator(num_pages)
        self.max_pages_per_seq = max_pages_per_seq
        self.tables: dict[int, list[int]] = {}

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // PAGE_SIZE)

    def allocate_seq(self, seq_id: int, num_tokens: int) -> bool:
        """Reserve pages for a sequence's first ``num_tokens``; False when
        the pool cannot (the caller queues)."""
        n = self.pages_needed(num_tokens)
        if n > self.max_pages_per_seq:
            raise ValueError(
                f"sequence needs {n} pages > max_pages_per_seq "
                f"{self.max_pages_per_seq}"
            )
        pages = self.allocator.allocate_n(n)
        if not pages and n > 0:
            return False
        self.tables[seq_id] = pages
        return True

    def extend_seq(self, seq_id: int, new_total_tokens: int) -> bool:
        """Grow a sequence's table to cover ``new_total_tokens``."""
        table = self.tables[seq_id]
        need = self.pages_needed(new_total_tokens) - len(table)
        if need <= 0:
            return True
        if len(table) + need > self.max_pages_per_seq:
            return False
        pages = self.allocator.allocate_n(need)
        if not pages:
            return False
        table.extend(pages)
        return True

    def free_seq(self, seq_id: int):
        for p in self.tables.pop(seq_id, []):
            self.allocator.free(p)

    def allocate_seq_with_prefix(
        self, seq_id: int, num_tokens: int, shared_pages: list[int]
    ) -> bool:
        """``allocate_seq`` whose first ``len(shared_pages)`` pages come from
        a prefix-cache hit: they are refcounted, never written by the new
        sequence (whole pages only). On exhaustion the refs are rolled back
        so the caller can evict and retry."""
        total = self.pages_needed(num_tokens)
        if total > self.max_pages_per_seq:
            raise ValueError(
                f"sequence needs {total} pages > max_pages_per_seq "
                f"{self.max_pages_per_seq}"
            )
        fresh_n = total - len(shared_pages)
        for p in shared_pages:
            self.allocator.add_ref(p)
        fresh = self.allocator.allocate_n(fresh_n) if fresh_n > 0 else []
        if fresh_n > 0 and not fresh:
            for p in shared_pages:
                self.allocator.free(p)
            return False
        self.tables[seq_id] = list(shared_pages) + fresh
        return True

    def block_table(self, seq_id: int) -> list[int]:
        return self.tables[seq_id]

    def num_free_pages(self) -> int:
        return self.allocator.num_free()


@dataclasses.dataclass
class _PrefixNode:
    key: tuple
    parent: Optional[tuple]
    page_id: int
    nchildren: int = 0
    last_use: int = 0


class PrefixStore:
    """Page-granularity prefix cache over the paged pool.

    A trie of FULL pages keyed by ``(parent_key, tuple(page_token_ids))``
    (exact tokens, no hash collisions). Each node holds one allocator
    reference on its page; a match hands back page ids to splice into a
    new sequence's table, so a repeated prefix prefills only its suffix.
    The final prompt token is never shared (the new lane writes its KV at
    its first decode step), so a shared page is never written. Eviction is
    LRU over leaves.
    """

    def __init__(self, manager: PagedCacheManager):
        self.manager = manager
        self.nodes: dict[tuple, _PrefixNode] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    def __len__(self) -> int:
        return len(self.nodes)

    @staticmethod
    def _max_shared_pages(prompt_len: int) -> int:
        return max(0, (prompt_len - 1) // PAGE_SIZE)

    def _chain(self, prompt_ids, limit_pages: int):
        key: Optional[tuple] = None
        for j in range(limit_pages):
            page = tuple(prompt_ids[j * PAGE_SIZE: (j + 1) * PAGE_SIZE])
            key = (key, page)
            yield j, key

    def match(self, prompt_ids: list[int]) -> list[int]:
        """Page ids of the longest cached full-page prefix (not yet
        refcounted: ``allocate_seq_with_prefix`` takes the refs)."""
        self._clock += 1
        pages: list[int] = []
        for _, key in self._chain(prompt_ids,
                                  self._max_shared_pages(len(prompt_ids))):
            node = self.nodes.get(key)
            if node is None:
                break
            node.last_use = self._clock
            pages.append(node.page_id)
        if pages:
            self.hits += 1
            self.hit_tokens += len(pages) * PAGE_SIZE
        else:
            self.misses += 1
        return pages

    def insert(self, prompt_ids: list[int], table: list[int]):
        """Register a prompt's full pages; new nodes take one reference on
        the sequence's page so it outlives the sequence."""
        self._clock += 1
        for j, key in self._chain(prompt_ids,
                                  self._max_shared_pages(len(prompt_ids))):
            node = self.nodes.get(key)
            if node is not None:
                node.last_use = self._clock
                continue
            parent = key[0]
            self.manager.allocator.add_ref(table[j])
            self.nodes[key] = _PrefixNode(key=key, parent=parent,
                                          page_id=table[j],
                                          last_use=self._clock)
            if parent is not None:
                self.nodes[parent].nchildren += 1

    def evict(self, num_pages: int) -> int:
        """Release up to ``num_pages`` nodes, oldest leaves first; returns
        how many were released."""
        freed = 0
        while freed < num_pages and self.nodes:
            leaves = [n for n in self.nodes.values() if n.nchildren == 0]
            victim = min(leaves, key=lambda n: n.last_use)
            del self.nodes[victim.key]
            if victim.parent is not None and victim.parent in self.nodes:
                self.nodes[victim.parent].nchildren -= 1
            self.manager.allocator.free(victim.page_id)
            freed += 1
        return freed

    def clear(self):
        self.evict(len(self.nodes))


# ---------------------------------------------------------------------------
# device ops: write tokens into the pool, gather for attention
# ---------------------------------------------------------------------------


def page_slots(block_tables: torch.Tensor, positions: torch.Tensor,
               scratch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical page, slot) [B, T] int64 of each token written at
    ``positions`` [B, T] through ``block_tables`` [B, maxP]. Invalid writes
    (position < 0, unmapped page) go to page ``scratch``."""
    maxp = block_tables.shape[1]
    page_idx = torch.clamp(torch.div(positions, PAGE_SIZE, rounding_mode="floor"),
                           0, maxp - 1)
    phys = torch.gather(block_tables, 1, page_idx.long())
    ok = (phys >= 0) & (positions >= 0)
    phys = torch.where(ok, phys, torch.full_like(phys, scratch))
    return phys.long(), torch.remainder(positions, PAGE_SIZE).long()


def scatter_tokens(pool: PagedKVPool, layer: int, phys: torch.Tensor,
                   slot: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Write one layer's new K/V [..., Hkv, Dh] at (phys, slot) [...] in
    place, quantizing to int8 with per-(token, head) scales when the pool
    is quantized."""
    if pool.quantized:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        pool.k[layer][phys, :, slot] = kq
        pool.v[layer][phys, :, slot] = vq
        pool.k_scale[layer][phys, :, slot] = ks[..., 0]
        pool.v_scale[layer][phys, :, slot] = vs[..., 0]
    else:
        pool.k[layer][phys, :, slot] = k.to(pool.k.dtype)
        pool.v[layer][phys, :, slot] = v.to(pool.v.dtype)


def write_tokens(
    pool: PagedKVPool,
    layer_k: torch.Tensor,  # [B, T, Hkv, Dh] new keys for ONE layer
    layer_v: torch.Tensor,
    layer_idx: int,
    block_tables: torch.Tensor,  # [B, maxP] int32 (-1 pad)
    positions: torch.Tensor,  # [B, T] token positions (-1 = pad)
) -> PagedKVPool:
    """Scatter new K/V into the pool in place (page = pos // PAGE_SIZE
    through the block table, slot = pos % PAGE_SIZE)."""
    phys, slot = page_slots(block_tables, positions, pool.num_pages)
    scatter_tokens(pool, layer_idx, phys, slot, layer_k, layer_v)
    return pool


def gather_pages(a: torch.Tensor, layer: int, tables: torch.Tensor):
    """Layer ``layer`` of pool array ``a`` [L, P+1, Hkv, PAGE, ...] gathered
    through ``tables`` [B, maxP] (pads read page 0) and flattened to
    token-major [B, maxP*PAGE, Hkv, ...]."""
    g = a[layer][torch.clamp(tables, min=0).long()]  # [B, maxP, Hkv, PAGE, ...]
    g = g.transpose(2, 3)
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def gather_kv(
    pool: PagedKVPool,
    layer_idx: int,
    block_tables: torch.Tensor,  # [B, maxP]
    dtype=torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's K/V for a batch as dense [B, maxP*PAGE, Hkv, Dh]
    (dequantized when the pool is INT8)."""
    k = gather_pages(pool.k, layer_idx, block_tables)
    v = gather_pages(pool.v, layer_idx, block_tables)
    if pool.quantized:
        ks = gather_pages(pool.k_scale, layer_idx, block_tables)[..., None]
        vs = gather_pages(pool.v_scale, layer_idx, block_tables)[..., None]
        k = k.to(torch.float32) * ks
        v = v.to(torch.float32) * vs
    return k.to(dtype), v.to(dtype)
