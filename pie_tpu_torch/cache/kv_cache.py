"""Fixed-capacity KV cache containers (PyTorch).

Same layout and bookkeeping as the JAX package's ``pie_tpu/cache/kv_cache.py``:
k, v ``[L, B, S, Hkv, Dh]`` buffers, ``slot_positions [B, S]`` (-1 = empty)
and ``length [B]``; a window makes the slots rotate (``slot = pos % S``).

Unlike the JAX containers the k/v buffers are updated IN PLACE by the model
forward (no buffer donation exists here). The small metadata tensors stay
functional: ``advance``/``trim_to`` return a new container that shares the
k/v buffers, and the prefill and decode steps of ``engine/core.py`` copy
the new metadata back into the static buffers they were captured over
(``copy_metadata``). ``trim_capacity`` returns views into the same
buffers, so the model's in-place writes through a trimmed view land in
the full cache.

``DualKVCache`` is Gemma-3's bounded pair of groups: the sliding layers'
rotating store of ``min(window, max_len)`` slots and the global layers'
``max_len`` store. A step's rotating slot is ``position % capacity``,
computed on the device from the positions, and writes that JAX drops are
rewritten on the device (``scatter_drop``), so a captured step reads
nothing back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def scatter_drop(target: torch.Tensor, slots: torch.Tensor,
                 values: torch.Tensor) -> None:
    """``target[b, slots[b, t]] = values[b, t]`` in place along dim 1,
    dropping out-of-range slots (JAX ``.at[...].set(mode="drop")``).
    Used by the rotating and INT8 caches, not by the contiguous bf16 cache.

    Nothing is read back to the host at any T, so a captured prefill or
    decode step can run it: a dropped write is not filtered out but
    rewritten. With one write per row (a decode step) it writes back the
    value already at its clamped slot. With more, it becomes a copy of its
    row's last kept write (same slot, same value), or, in a row that keeps
    none, slot 0's own value written back. A dropped write therefore never
    changes what a kept one leaves behind, whatever order the writes land
    in; two kept writes to one slot (a chunk longer than a rotating store)
    race as in JAX, the last one winning where writes land in order."""
    s, t = target.shape[1], slots.shape[1]
    slots = slots.long()
    ok = (slots >= 0) & (slots < s)
    rows = torch.arange(slots.shape[0], device=slots.device)
    tail = (1,) * (values.dim() - 2)
    if t == 1:  # four launches: a decode step runs it per layer
        at = slots.clamp(0, s - 1)
        target[rows[:, None], at] = torch.where(
            ok.reshape(ok.shape + tail), values.to(target.dtype),
            target[rows[:, None], at])
        return
    last = torch.where(ok, torch.arange(t, device=slots.device)[None, :],
                       torch.full_like(slots, -1)).amax(dim=1)
    kept = last >= 0  # the row keeps a write
    last = last.clamp(min=0)
    anchor_slot = torch.where(kept, slots[rows, last], torch.zeros_like(last))
    anchor_val = torch.where(kept.reshape(kept.shape + tail),
                             values[rows, last].to(target.dtype), target[rows, 0])
    at = torch.where(ok, slots, anchor_slot[:, None])
    vals = torch.where(ok.reshape(ok.shape + tail), values.to(target.dtype),
                       anchor_val[:, None])
    target[rows[:, None], at] = vals


@dataclasses.dataclass(frozen=True)
class KVCache:
    """Contiguous (window=None) or rotating (window=capacity) KV cache."""

    k: torch.Tensor
    v: torch.Tensor
    slot_positions: torch.Tensor
    length: torch.Tensor
    window: Optional[int] = None

    @classmethod
    def create(
        cls, num_layers: int, batch: int, capacity: int, num_kv_heads: int,
        head_dim: int, dtype=torch.bfloat16, window: Optional[int] = None,
        *, device,
    ) -> "KVCache":
        shape = (num_layers, batch, capacity, num_kv_heads, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            slot_positions=torch.full(
                (batch, capacity), -1, dtype=torch.int32, device=device
            ),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
            window=window,
        )

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    def trim_capacity(self, bucket: int) -> "KVCache":
        """Capacity-bucketed VIEW for short-context decode (see the JAX
        package): attention reads a [.., :bucket] slice of the buffers."""
        return dataclasses.replace(
            self, k=self.k[:, :, :bucket], v=self.v[:, :, :bucket],
            slot_positions=self.slot_positions[:, :bucket],
        )

    def write_slot(self, positions: torch.Tensor) -> torch.Tensor:
        if self.window is None:
            return positions
        return positions % self.capacity

    def advance(self, first_pos: torch.Tensor, num_tokens: int,
                valid_lens=None) -> "KVCache":
        """Metadata for ``num_tokens`` written from ``first_pos`` [B]
        (k/v are written by the model forward). Pads beyond ``valid_lens``
        are not recorded; a rotating cache records only the last
        ``capacity`` valid tokens of a chunk."""
        b, s = self.slot_positions.shape
        dev = self.slot_positions.device
        ar = torch.arange(num_tokens, dtype=torch.int32, device=dev)
        new_pos = first_pos[:, None].to(torch.int32) + ar[None, :]
        slots = self.write_slot(new_pos)
        drop = None
        if valid_lens is not None:
            drop = ar[None, :] >= valid_lens[:, None]
        if self.window is not None and num_tokens > 1:
            end = first_pos + (valid_lens if valid_lens is not None else num_tokens)
            stale = new_pos < (end - self.capacity)[:, None]
            drop = stale if drop is None else (drop | stale)
        if drop is not None:
            slots = torch.where(drop, torch.full_like(slots, s), slots)
        # scatter into one spare column that takes the dropped writes: no
        # host round trip on the per-token path
        ext = torch.cat(
            [self.slot_positions, self.slot_positions.new_full((b, 1), -1)], 1
        )
        slots = torch.where((slots >= 0) & (slots < s), slots,
                            torch.full_like(slots, s))
        ext.scatter_(1, slots.long(), new_pos)
        slot_positions = ext[:, :s].contiguous()
        end_len = first_pos + (valid_lens if valid_lens is not None else num_tokens)
        return dataclasses.replace(
            self, slot_positions=slot_positions,
            length=torch.maximum(self.length, end_len.to(torch.int32)),
        )

    def trim_to(self, length: torch.Tensor) -> "KVCache":
        """Logically trim each sequence to ``length`` tokens (metadata only)."""
        keep = self.slot_positions < length[:, None]
        return dataclasses.replace(
            self,
            slot_positions=torch.where(
                keep, self.slot_positions, torch.full_like(self.slot_positions, -1)
            ),
            length=torch.minimum(self.length, length.to(torch.int32)),
        )


@dataclasses.dataclass(frozen=True)
class QuantizedKVCache:
    """INT8 KV cache with per-(token, head) symmetric scales.

    k_q, v_q: [L, B, S, Hkv, Dh] int8; k_scale, v_scale: [L, B, S, Hkv, 1] f32.
    """

    k_q: torch.Tensor
    k_scale: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor
    slot_positions: torch.Tensor
    length: torch.Tensor
    window: Optional[int] = None

    @classmethod
    def create(
        cls, num_layers: int, batch: int, capacity: int, num_kv_heads: int,
        head_dim: int, dtype=torch.bfloat16, window: Optional[int] = None,
        *, device,
    ) -> "QuantizedKVCache":
        shape = (num_layers, batch, capacity, num_kv_heads, head_dim)
        sshape = (num_layers, batch, capacity, num_kv_heads, 1)
        z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        return cls(
            k_q=z(shape, torch.int8), k_scale=z(sshape, torch.float32),
            v_q=z(shape, torch.int8), v_scale=z(sshape, torch.float32),
            slot_positions=torch.full(
                (batch, capacity), -1, dtype=torch.int32, device=device
            ),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
            window=window,
        )

    @property
    def capacity(self) -> int:
        return self.k_q.shape[2]

    def trim_capacity(self, bucket: int) -> "QuantizedKVCache":
        return dataclasses.replace(
            self,
            k_q=self.k_q[:, :, :bucket], k_scale=self.k_scale[:, :, :bucket],
            v_q=self.v_q[:, :, :bucket], v_scale=self.v_scale[:, :, :bucket],
            slot_positions=self.slot_positions[:, :bucket],
        )

    write_slot = KVCache.write_slot
    advance = KVCache.advance
    trim_to = KVCache.trim_to


@dataclasses.dataclass(frozen=True)
class DualKVCache:
    """Two cache groups for a model that interleaves sliding-window and
    global layers (Gemma-3's 5:1 pattern), as the JAX package's
    ``DualKVCache``: ``sliding`` holds the sliding layers in a rotating
    store of ``min(window, max_len)`` slots (window set), ``full`` the
    global layers at ``max_len``. Both are ``KVCache`` or both
    ``QuantizedKVCache``. The engine's bookkeeping reads the full group."""

    sliding: object
    full: object

    @property
    def window(self):
        return self.sliding.window

    @property
    def capacity(self) -> int:
        return self.full.capacity

    @property
    def slot_positions(self) -> torch.Tensor:
        return self.full.slot_positions

    @property
    def length(self) -> torch.Tensor:
        return self.full.length

    def advance(self, first_pos, num_tokens: int, valid_lens=None) -> "DualKVCache":
        return DualKVCache(
            sliding=self.sliding.advance(first_pos, num_tokens, valid_lens),
            full=self.full.advance(first_pos, num_tokens, valid_lens),
        )

    def trim_to(self, length: torch.Tensor) -> "DualKVCache":
        return DualKVCache(sliding=self.sliding.trim_to(length),
                           full=self.full.trim_to(length))


def cache_groups(cache) -> dict:
    """The single-group caches of ``cache`` by name: ``{"": cache}``, or a
    DualKVCache's ``{"sliding.": ..., "full.": ...}``."""
    if isinstance(cache, DualKVCache):
        return {"sliding.": cache.sliding, "full.": cache.full}
    return {"": cache}


def cache_kind(cache) -> tuple:
    """What a cache is made of: its class and its groups' classes."""
    return (type(cache),) + tuple(type(g) for g in cache_groups(cache).values())


def cache_tensors(cache) -> dict:
    """Every tensor of ``cache`` by name (a group's prefixed)."""
    return {prefix + f.name: getattr(g, f.name)
            for prefix, g in cache_groups(cache).items()
            for f in dataclasses.fields(g)
            if isinstance(getattr(g, f.name), torch.Tensor)}


def copy_metadata(dst, src) -> None:
    """``src``'s slot positions and lengths into ``dst``'s buffers, in place
    (every group)."""
    for d, s in zip(cache_groups(dst).values(), cache_groups(src).values()):
        d.slot_positions.copy_(s.slot_positions)
        d.length.copy_(s.length)


def reset_metadata(cache) -> None:
    """Every slot empty, every length 0, in place (every group)."""
    for g in cache_groups(cache).values():
        g.slot_positions.fill_(-1)
        g.length.zero_()


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (token, head): x [B, T, H, D] -> (q int8, scale
    f32 [B, T, H, 1])."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def make_kv_cache(
    num_layers: int, batch: int, capacity: int, num_kv_heads: int,
    head_dim: int, dtype=torch.bfloat16, window: Optional[int] = None,
    quantized: bool = False, *, device,
):
    """Window -> rotating slots; quantized -> int8 storage."""
    cls = QuantizedKVCache if quantized else KVCache
    return cls.create(num_layers, batch, capacity, num_kv_heads, head_dim,
                      dtype, window, device=device)


def maybe_quantize(cache, threshold_tokens: int = 4096):
    """Convert a bf16 cache to INT8 storage once any sequence crosses the
    token threshold. Reads the cache's length back to the host: the engine
    calls it between requests, never inside a decode step (a captured
    graph); the INT8 cache it returns replaces the engine's static one. A
    DualKVCache converts both groups."""
    if isinstance(cache, DualKVCache):
        return DualKVCache(sliding=maybe_quantize(cache.sliding, threshold_tokens),
                           full=maybe_quantize(cache.full, threshold_tokens))
    if isinstance(cache, QuantizedKVCache):
        return cache
    if int(cache.length.max()) < threshold_tokens:
        return cache
    k_q, k_scale = quantize_kv(cache.k)
    v_q, v_scale = quantize_kv(cache.v)
    return QuantizedKVCache(
        k_q=k_q, k_scale=k_scale, v_q=v_q, v_scale=v_scale,
        slot_positions=cache.slot_positions, length=cache.length,
        window=cache.window,
    )
