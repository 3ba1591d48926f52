"""Tensor- and data-parallel sharding of the decoder stack over a
``("dp", "tp")`` mesh of processes.

Port of the JAX package's ``pie_tpu/parallel/tp.py``. JAX states the
layout as PartitionSpecs and lets XLA place the collectives; here each
process holds its own shard and the forwards call the collectives
themselves (``MeshOps``). The layout is Megatron's:

- ``wq wk wv wg wu`` and the biases ``bq bk bv``: column parallel (output
  features over tp);
- the fused ``wqkv``: each of its q / k / v blocks split over tp, and
  ``wgu`` each of its gate / up blocks (a contiguous split of a fused
  tensor would hand shard 0 all of q and none of v);
- ``wo wd``: row parallel (the contraction over tp, an all-reduce after);
  a quantized row shard is re-padded to ``PACK_TILE_K`` with zero codes,
  scales and biases, so its padding adds nothing whatever x holds there;
- ``embed``: vocab rows over tp (a masked lookup, then an all-reduce);
  ``lm_head``: vocab columns over tp (an all-gather of the logits); a tied
  head reads the embedding's rows;
- the KV cache and pool: KV heads over tp; the contiguous cache's batch
  rows over dp; the pool's pages global and the same on every dp rank;
- norms, ``q_norm`` / ``k_norm``, the vision towers and the projector:
  replicated.

A rank runs its model under ``local_config``: the head and MLP widths of
its shard (``shard_model``). Under dp the batch rows split over the dp
ranks; every rank keeps the same host state and gathers each step's
sampled tokens, and the paged forwards gather each layer's new K/V of the
lanes, so every dp rank's pool holds every page (as JAX's pool replicated
over dp does).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from pie_tpu_torch.ops.quant import PACK_TILE_K, QuantizedTensor

warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*deprecated",
                        category=FutureWarning)

#: collectives the sharded forwards issued (a captured step's are added at
#: every replay, as the kernels' launch counts are)
collective_counts = {"tp all_reduce": 0, "tp all_gather": 0, "dp all_gather": 0}

# leaf name -> how a stacked layer weight [L, K, N] (or its quantized twin,
# or a bias [L, N]) splits over tp
LAYER_PLAN = {
    "wq": "col", "wk": "col", "wv": "col", "wg": "col", "wu": "col",
    "wqkv": "qkv", "wgu": "gu",
    "wo": "row", "wd": "row",
    "bq": "col", "bk": "col", "bv": "col",
}


class _Rows:
    """How a batch's rows split over the dp ranks (``dp``, ``dp_rank``):
    the one place the engines and the forwards learn it."""

    dp = 1
    dp_rank = 0

    def rows(self, b: int) -> slice:
        """This dp rank's rows of a batch of ``b``."""
        if b % self.dp:
            raise ValueError(f"batch {b} does not split over dp={self.dp}")
        n = b // self.dp
        return slice(self.dp_rank * n, (self.dp_rank + 1) * n)

    def local(self, x, dim: int = 0):
        """This rank's rows of a batch input (a tensor or host array on axis
        ``dim``, or a dataclass whose tensors are [B, ...]); ``x`` itself
        without dp, or when it is None."""
        if self.dp == 1 or x is None:
            return x
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: self.local(getattr(x, f.name)) for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor)})
        return x[(slice(None),) * dim + (self.rows(x.shape[dim]),)]

    def split_lanes(self, *arrays) -> tuple:
        """``local`` of each batch input."""
        return tuple(self.local(a) for a in arrays)

    def batch_rows(self, local_b: int):
        """(B, this rank's slice) of the batch whose rows here are
        ``local_b``, for a sampler that draws the whole batch's numbers;
        None without dp."""
        if self.dp == 1:
            return None
        b = local_b * self.dp
        return b, self.rows(b)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather_lead(self, b: int, *arrays) -> tuple:
        """Each [M, ...] array with its first ``b`` rows (this rank's lanes)
        gathered over dp and its other rows (the rider's, the same on every
        rank) after them."""
        if self.dp == 1:
            return arrays
        return tuple(torch.cat([self.gather_rows(a[:b]), a[b:]]) for a in arrays)


class MeshOps(_Rows):
    """The collectives of the sharded forwards over one ``("dp", "tp")``
    ``DeviceMesh``. A mesh of one process still issues its tp collectives
    (the path is the same at every width); dp collectives run only where
    the rows split (dp > 1)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.tp_group = mesh.get_group("tp")
        self.dp_group = mesh.get_group("dp")
        self.tp = dist.get_world_size(self.tp_group)
        self.dp = dist.get_world_size(self.dp_group)
        self.tp_rank = dist.get_rank(self.tp_group)
        self.dp_rank = dist.get_rank(self.dp_group)
        self.backend = dist.get_backend(self.tp_group)
        #: a CUDA graph may capture these collectives (NCCL's); gloo's
        #: synchronize with the host and cannot be captured
        self.capturable = all(dist.get_backend(g) == "nccl"
                              for g in (self.tp_group, self.dp_group))

    # -- tp ---------------------------------------------------------------

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the tp ranks' partial ``x`` (a row-parallel product)."""
        y = x.contiguous()
        dist.all_reduce(y, group=self.tp_group)
        collective_counts["tp all_reduce"] += 1
        return y

    def gather_vocab(self, x: torch.Tensor) -> torch.Tensor:
        """[..., V/tp] vocab-sharded logits -> [..., V], rank order."""
        xs = x.reshape(-1, x.shape[-1]).contiguous()
        out = torch.empty((self.tp * xs.shape[0], xs.shape[1]), dtype=xs.dtype,
                          device=xs.device)
        dist.all_gather_into_tensor(out, xs, group=self.tp_group)
        collective_counts["tp all_gather"] += 1
        out = out.view(self.tp, xs.shape[0], xs.shape[1]).transpose(0, 1)
        return out.reshape(*x.shape[:-1], self.tp * x.shape[-1])

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of a vocab-sharded table: each rank looks up the ids in its
        range (zeros elsewhere), then the ranks' rows are summed."""
        vl = table.shape[0]
        local = ids.long() - self.tp_rank * vl
        ok = (local >= 0) & (local < vl)
        rows = table[torch.clamp(local, 0, vl - 1)]
        rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
        return self.tp_sum(rows)

    # -- dp ---------------------------------------------------------------

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The dp ranks' rows [B/dp, ...] -> [B, ...], rank order."""
        if self.dp == 1:
            return x
        xs = x.contiguous()
        out = torch.empty((self.dp * xs.shape[0],) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=xs.device)
        dist.all_gather_into_tensor(out, xs, group=self.dp_group)
        collective_counts["dp all_gather"] += 1
        return out


class _NoMesh(_Rows):
    """The ops of an unsharded model: no collective, the whole batch."""

    tp = 1
    tp_rank = 0
    capturable = True

    @staticmethod
    def tp_sum(x):
        return x

    @staticmethod
    def gather_vocab(x):
        return x

    @staticmethod
    def embed(table, ids):
        return table[ids]


NO_MESH = _NoMesh()
_ops: dict = {}


def mesh_ops(mesh):
    """The collectives over ``mesh`` (made once per mesh); ``NO_MESH`` for
    None."""
    if mesh is None:
        return NO_MESH
    hit = _ops.get(id(mesh))
    if hit is None or hit.mesh is not mesh:
        hit = _ops[id(mesh)] = MeshOps(mesh)
    return hit


def _sizes(mesh) -> tuple[int, int, int, int]:
    ops = mesh_ops(mesh)
    return ops.tp, ops.tp_rank, ops.dp, ops.dp_rank


# ---------------------------------------------------------------------------
# configuration and model
# ---------------------------------------------------------------------------


def local_config(config, tp: int):
    """The configuration one of ``tp`` ranks runs: its query / KV heads
    and MLP width; head_dim pinned (it no longer follows hidden / heads);
    the vocabulary stays whole (the logits are gathered)."""
    hq, hkv = config.num_attention_heads, config.num_key_value_heads
    di = config.intermediate_size
    if hq % tp or hkv % tp or di % tp:
        raise ValueError(
            f"tp={tp} does not divide Hq={hq}, Hkv={hkv} and intermediate={di}"
            + (" (replicate_kv_heads lifts tp past Hkv)" if hkv % tp and not hq % tp
               else ""))
    return dataclasses.replace(
        config, num_attention_heads=hq // tp, num_key_value_heads=hkv // tp,
        intermediate_size=di // tp, head_dim=config.resolved_head_dim)


def shard_model(model, mesh):
    """``model`` as one rank of ``mesh`` runs it: a model of the same class
    over ``local_config``, its ``mesh`` set (the model itself when its mesh
    is already this one)."""
    if getattr(model, "mesh", None) is mesh:
        return model
    m = type(model)(local_config(model.config, mesh_ops(mesh).tp))
    m.mesh = mesh
    return m


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_plan(params: dict) -> dict:
    """How each leaf of a decoder params tree splits over tp: "col" (output
    features), "row" (the contraction), "qkv" / "gu" (each block of a fused
    projection by output feature), "vocab" (embedding rows), "head"
    (lm_head columns) or "rep" (replicated). The JAX package's
    ``param_specs`` as names; it replicates ``wqkv`` and ``wgu`` (its
    ``LAYER_SPECS`` names only the unfused leaves), which the port
    shards."""
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {n: ("rep" if isinstance(leaf, dict) else LAYER_PLAN.get(n, "rep"))
                      for n, leaf in v.items()}
        elif isinstance(v, dict):
            out[k] = "rep"  # vision tower / projector
        else:
            out[k] = {"embed": "vocab", "lm_head": "head"}.get(k, "rep")
    return out


def _cols(a: torch.Tensor, parts, r: int, tp: int) -> torch.Tensor:
    """Shard ``r`` of each block of the last axis (blocks of ``parts``
    widths), concatenated."""
    out, start = [], 0
    for w in parts:
        if w % tp:
            raise ValueError(f"block of {w} columns does not split over tp={tp}")
        s = w // tp
        out.append(a[..., start + r * s: start + (r + 1) * s])
        start += w
    return torch.cat(out, dim=-1).contiguous()


def _col_shard(leaf, parts, r: int, tp: int):
    if isinstance(leaf, QuantizedTensor):
        return dataclasses.replace(
            leaf, packed=_cols(leaf.packed, parts, r, tp),
            scales=_cols(leaf.scales, parts, r, tp),
            biases=_cols(leaf.biases, parts, r, tp),
            shape=(leaf.shape[0], leaf.shape[1] // tp))
    return _cols(leaf, parts, r, tp)


def row_shard(leaf, r: int, tp: int):
    """Rows [r K/tp, (r+1) K/tp) of a [.., K, N] weight. A quantized shard
    takes its whole words and groups and is re-padded to ``PACK_TILE_K``
    rows with zero codes, zero scales and zero biases."""
    if not isinstance(leaf, QuantizedTensor):
        k = leaf.shape[-2]
        if k % tp:
            raise ValueError(f"K={k} does not split over tp={tp}")
        kl = k // tp
        return leaf[..., r * kl:(r + 1) * kl, :].contiguous()
    k, n = leaf.shape
    ep, g = leaf.el_per_int, leaf.group_size
    kl = k // tp
    if k % tp or kl % g or kl % ep:
        raise ValueError(f"K={k} does not split over tp={tp} in whole groups of {g}")
    kp = -(-kl // PACK_TILE_K) * PACK_TILE_K

    def rows(a, unit):
        part = a[..., r * kl // unit:(r + 1) * kl // unit, :]
        pad = (kp - kl) // unit
        if pad:
            part = torch.nn.functional.pad(part, (0, 0, 0, pad))
        return part.contiguous()

    return dataclasses.replace(leaf, packed=rows(leaf.packed, ep),
                               scales=rows(leaf.scales, g), biases=rows(leaf.biases, g),
                               shape=(kl, n))


def _qkv_parts(config, n: int) -> tuple:
    hq, hkv = config.num_attention_heads, config.num_key_value_heads
    unit = n // (hq + 2 * hkv)
    return (hq * unit, hkv * unit, hkv * unit)


def shard_params(params: dict, mesh, config=None) -> dict:
    """This rank's shard of a decoder params tree (``param_plan``), on the
    params' own device. ``config`` (the global one) sizes the q / k / v
    blocks of a fused ``wqkv``."""
    tp, r, _, _ = _sizes(mesh)
    plan = param_plan(params)

    def one(name, leaf, how):
        if how == "rep":
            return leaf
        if how == "row":
            return row_shard(leaf, r, tp)
        n = leaf.shape[-1]
        if how == "qkv":
            if config is None:
                raise ValueError("a fused wqkv needs the config to find its q/k/v blocks")
            return _col_shard(leaf, _qkv_parts(config, n), r, tp)
        if how == "gu":
            return _col_shard(leaf, (n // 2, n // 2), r, tp)
        if how == "vocab":
            v = leaf.shape[0]
            if v % tp:
                raise ValueError(f"vocab {v} does not split over tp={tp}")
            return leaf[r * v // tp:(r + 1) * v // tp].contiguous()
        return _col_shard(leaf, (n,), r, tp)  # "col", "head"

    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {n: one(n, leaf, plan[k][n]) for n, leaf in v.items()}
        else:
            out[k] = one(k, v, plan[k])
    return out


def rank_config(config, tp: int):
    """The configuration one of ``tp`` ranks runs: ``local_config`` of the
    model after ``replicate_kv_heads`` where tp exceeds Hkv (each rank
    then holds one KV head)."""
    hkv = config.num_key_value_heads
    if tp > hkv and not tp % hkv and not config.num_attention_heads % tp:
        config = dataclasses.replace(config, num_key_value_heads=tp)
    return local_config(config, tp)


def projection_shards(config, tp: int, fused: bool = True,
                      quantized_head: bool = True) -> dict:
    """(K, N, rope head dim) of each quantized projection one of ``tp``
    ranks multiplies by: the K1 / K2 shapes of a sharded step, from the
    rank's ``rank_config`` (so only shapes a rank runs; a tp the heads do
    not split over raises). ``fused``: the Llama layout (``wqkv`` with the
    rope epilogue, ``wgu``); else each projection apart (Gemma-3,
    Qwen2-VL). Row shards keep their logical K (``row_shard`` pads the
    words to PACK_TILE_K)."""
    loc = rank_config(config, tp)
    d, dh, v = config.hidden_size, loc.resolved_head_dim, config.vocab_size
    hq, hkv, di = loc.num_attention_heads, loc.num_key_value_heads, loc.intermediate_size
    if v % tp:
        raise ValueError(f"vocab {v} does not split over tp={tp}")
    if fused:
        out = {"wqkv": (d, (hq + 2 * hkv) * dh, dh if dh in (64, 128) else 0),
               "wgu": (d, 2 * di, 0)}
    else:
        out = {"wq": (d, hq * dh, 0), "wk": (d, hkv * dh, 0), "wv": (d, hkv * dh, 0),
               "wg": (d, di, 0), "wu": (d, di, 0)}
    out.update(wo=(hq * dh, d, 0), wd=(di, d, 0))
    if quantized_head:
        out["lm_head"] = (d, v // tp, 0)
    return out


def replicate_kv_heads(params: dict, config, factor: int):
    """Repeat each KV head of ``wk`` / ``wv`` (+ ``bk`` / ``bv``, a fused
    ``wqkv``'s K and V blocks, per-(head, dim) k-norms) ``factor`` adjacent
    times, lifting tp <= Hkv to tp <= Hkv * factor. Returns (params, the
    config with Hkv * factor heads). Adjacent copies keep the GQA mapping:
    query head i still reads original KV head i // (Hq / Hkv), so attention
    is unchanged. Quantized leaves repeat the same column blocks of their
    words, scales and biases (each carries the head axis last)."""
    if factor <= 1:
        return params, config
    hq, hkv = config.num_attention_heads, config.num_key_value_heads
    if hq % (hkv * factor):
        raise ValueError(f"factor {factor}: Hq={hq} must be a multiple of "
                         f"Hkv*factor={hkv * factor}")
    dh = config.resolved_head_dim

    def rep(a, heads):
        lead = a.shape[:-1]
        unit = a.shape[-1] // heads
        r = a.reshape(*lead, heads, unit).repeat_interleave(factor, dim=-2)
        return r.reshape(*lead, heads * factor * unit).contiguous()

    def dup(leaf):
        if isinstance(leaf, QuantizedTensor):
            return dataclasses.replace(
                leaf, packed=rep(leaf.packed, hkv), scales=rep(leaf.scales, hkv),
                biases=rep(leaf.biases, hkv),
                shape=(leaf.shape[0], leaf.shape[1] * factor))
        return rep(leaf, hkv)

    def dup_fused_qkv(leaf):
        # [.., Hq*Dh | Hkv*Dh | Hkv*Dh]: expand only the K / V blocks
        def expand(a, unit):
            q = a[..., :hq * unit]
            k = a[..., hq * unit:(hq + hkv) * unit]
            v = a[..., (hq + hkv) * unit:]
            return torch.cat([q, rep(k, hkv), rep(v, hkv)], dim=-1).contiguous()

        n = leaf.shape[-1]
        unit = n // (hq + 2 * hkv)
        if isinstance(leaf, QuantizedTensor):
            return dataclasses.replace(
                leaf, packed=expand(leaf.packed, unit), scales=expand(leaf.scales, unit),
                biases=expand(leaf.biases, unit),
                shape=(leaf.shape[0], n + 2 * hkv * (factor - 1) * unit))
        return expand(leaf, unit)

    layers = dict(params["layers"])
    for name in ("wk", "wv", "bk", "bv"):
        if name in layers:
            layers[name] = dup(layers[name])
    if "wqkv" in layers:
        layers["wqkv"] = dup_fused_qkv(layers["wqkv"])
    if "k_norm" in layers and layers["k_norm"].shape[-1] == hkv * dh:
        layers["k_norm"] = dup(layers["k_norm"])
    new_params = dict(params)
    new_params["layers"] = layers
    return new_params, dataclasses.replace(config, num_key_value_heads=hkv * factor)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _heads(a: Optional[torch.Tensor], dim: int, r: int, tp: int):
    if a is None:
        return None
    h = a.shape[dim]
    if h % tp:
        raise ValueError(f"{h} KV heads do not split over tp={tp}")
    return a.narrow(dim, r * h // tp, h // tp).contiguous()


def shard_pool(pool, mesh):
    """This rank's shard of a paged KV pool: its KV heads of every page
    (k / v [L, P+1, Hkv, PAGE, D] and the INT8 scales [L, P+1, Hkv, PAGE]
    split on the head axis). Pages are global: every dp rank holds them
    all, under the same ids."""
    tp, r, _, _ = _sizes(mesh)
    return dataclasses.replace(
        pool, k=_heads(pool.k, 2, r, tp), v=_heads(pool.v, 2, r, tp),
        k_scale=_heads(pool.k_scale, 2, r, tp), v_scale=_heads(pool.v_scale, 2, r, tp))


def shard_cache(cache, mesh):
    """This rank's shard of a contiguous KV cache (``KVCache`` /
    ``QuantizedKVCache``, or each group of a ``DualKVCache``): batch rows
    over dp, KV heads over tp (k / v / k_q / v_q / scales
    [L, B, S, Hkv, *]; slot positions [B, S] and lengths [B] by row)."""
    tp, r, dp, _ = _sizes(mesh)
    if hasattr(cache, "sliding"):
        return dataclasses.replace(cache, sliding=shard_cache(cache.sliding, mesh),
                                   full=shard_cache(cache.full, mesh))
    rows = mesh_ops(mesh).rows(cache.length.shape[0])
    updates = {}
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        if f.name in ("k", "v", "k_q", "v_q", "k_scale", "v_scale"):
            updates[f.name] = _heads(v[:, rows], 3, r, tp)
        elif f.name in ("slot_positions", "length"):
            updates[f.name] = v[rows].contiguous()
    return dataclasses.replace(cache, **updates)
