"""Gemma-3 text decoder in PyTorch.

Port of the text parts of the JAX package's ``pie_tpu/models/gemma3.py``:
the 5:1 sliding/global layer pattern, dual rope bases (local 10k, global
1M with linear scaling), q/k-norm after the projections, four (1 + w)
RMS norms a block, the GeGLU MLP (``gelu_tanh(g) * u``), embeddings scaled
by sqrt(hidden) and an unembedding tied to them. Three forwards, as in
JAX: ``__call__`` over a contiguous cache or the bounded ``DualKVCache``
(``_dual_forward``: the sliding layers keep only a window-sized rotating
store), and ``paged_forward`` / ``mixed_forward`` over the paged pool,
where each decode lane attends through the paged decode-attention kernel
(K3 on the card, at head_dim 256) with the layer's window (``sliding_window``
or 0) and a prefill chunk gathers its pages under full or windowed masks.

The layer ``scan`` becomes a Python loop, so a layer's kind (sliding or
global), its rope table and its window are host values. Projections are
stacked per layer and run apart (``wq``, ``wk``, ``wv``; ``wg``, ``wu``):
quantized ones through ``ops.quant.quantized_matmul`` (K1 at M <= 32, K2
above, on the card) with no ln prologue and no rope epilogue (the norm is
the (1 + w) form and rope follows the q/k-norm). K4 is never used: it
fuses the silu MLP, and Gemma-3's is GeGLU. The unembedding is a plain
product against the embedding table, as JAX leaves it to XLA: f32 on the
CPU (JAX's ``preferred_element_type``), a bf16 GEMM with f32 accumulation
on the card.

``SigLipVision`` is the VLM's image half: the SigLIP encoder (a 14 x 14
stride-14 patch embedding written as unfold plus a product, its bias and
the learned position table, pre-LN blocks with biased q/k/v/o and the
tanh-GELU MLP, the post-LN) and Gemma-3's projector (a 4 x 4 average pool
of the patch grid, the (1 + w) RMS norm, the product into the text width).
Its products are plain large matmuls in the promoted dtype of the pixels
and the weights, f32 for f32 pixels as in JAX; it stays dense (never
quantized) and runs eagerly, before the prefill. ``embed_with_images``
writes the projected rows over the image placeholders in order (unscaled;
the text rows carry sqrt(hidden)) and refuses a placeholder count other
than images x ``mm_tokens_per_image``; ``__call__`` and ``mixed_forward``
take the prompt's embeddings in place of its ids' (``inputs_embeds``,
``pf_embeds``).

The JAX package's Gemma-3 params carry across unchanged through
``models.llama.from_jax_params`` (same keys, stacked layers, quantized
tensors repacked, the tower under ``vision``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from pie_tpu_torch.cache.kv_cache import (
    DualKVCache,
    KVCache,
    QuantizedKVCache,
    quantize_kv,
    scatter_drop,
)
from pie_tpu_torch.cache.paged import page_slots, scatter_tokens
from pie_tpu_torch.errors import InferenceError
from pie_tpu_torch.models.config import BaseConfig, _filter_kwargs
from pie_tpu_torch.models.llama import (
    _f32_dot,
    _paged_kv_positions,
    gathered_attention,
    linear,
)
from pie_tpu_torch.models.registry import register_model
from pie_tpu_torch.models.vision_common import (
    as_tensor,
    layer_norm,
    matmul_promoted,
    scatter_image_features,
)
from pie_tpu_torch.ops.attention import attention_mask, sdpa, sdpa_quantized
from pie_tpu_torch.ops.paged_attention import paged_attention_decode
from pie_tpu_torch.ops.quant import QuantizedTensor, quantize
from pie_tpu_torch.ops.rope import apply_rope_tables, make_inv_freq, rope_tables
from pie_tpu_torch.parallel.tp import mesh_ops
from pie_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Gemma3Config(BaseConfig):
    model_type: str = "gemma3_text"
    hidden_size: int = 1152
    num_hidden_layers: int = 26
    intermediate_size: int = 6912
    num_attention_heads: int = 4
    num_key_value_heads: int = 1
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    vocab_size: int = 262144
    rope_theta: float = 1000000.0
    rope_local_base_freq: float = 10000.0
    rope_scaling: Optional[dict] = None
    sliding_window: int = 512
    sliding_window_pattern: int = 6
    query_pre_attn_scalar: float = 256.0
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 131072
    # the SigLIP tower's config (None: text only)
    vision: Optional[dict] = None
    mm_tokens_per_image: int = 256
    image_token_id: int = 262144  # <image_soft_token>; the VLM config sets it

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Gemma3Config":
        if "text_config" in d:  # the VLM wrapper's config
            td = dict(d["text_config"])
            td["model_type"] = "gemma3"
            td["vision"] = d.get("vision_config")
            td["mm_tokens_per_image"] = d.get("mm_tokens_per_image", 256)
            td["image_token_id"] = d.get("image_token_index",
                                         d.get("image_token_id", 262144))
            if "tie_word_embeddings" in d:
                td["tie_word_embeddings"] = d["tie_word_embeddings"]
            return cls(**_filter_kwargs(cls, td))
        return cls(**_filter_kwargs(cls, d))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim


def _gemma_rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma's RMSNorm: the weight is stored as (gamma - 1)."""
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * (1.0 + w.to(torch.float32))).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``'s formula, in x's dtype."""
    cdf = 0.5 * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * (x ** 3))))
    return x * cdf


@register_model("gemma3")
class Gemma3Model:
    """Gemma-3 decoder over a plain dict of tensors (the JAX package's
    params layout)."""

    LINEAR_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
    HF_LAYER_MAP = {
        "wq": "self_attn.q_proj.weight",
        "wk": "self_attn.k_proj.weight",
        "wv": "self_attn.v_proj.weight",
        "wo": "self_attn.o_proj.weight",
        "wg": "mlp.gate_proj.weight",
        "wu": "mlp.up_proj.weight",
        "wd": "mlp.down_proj.weight",
        "ln1": "input_layernorm.weight",
        "ln2": "post_attention_layernorm.weight",
        "ln3": "pre_feedforward_layernorm.weight",
        "ln4": "post_feedforward_layernorm.weight",
        "q_norm": "self_attn.q_norm.weight",
        "k_norm": "self_attn.k_norm.weight",
    }

    #: the ("dp", "tp") mesh this rank's model runs over (None: unsharded;
    #: the collectives as in ``LlamaModel``, the tower replicated)
    mesh = None

    def __init__(self, config: Gemma3Config):
        self.config = config
        self.vision = (SigLipVision(config.vision, config.hidden_size,
                                    config.mm_tokens_per_image)
                       if config.vision else None)
        dh = config.head_dim
        inv_g = make_inv_freq(dh, config.rope_theta)
        rs = config.rope_scaling or {}
        if rs.get("rope_type", rs.get("type")) == "linear":  # global layers only
            inv_g = inv_g / float(rs.get("factor", 1.0))
        self.inv_freq_np = {"global": inv_g.astype(np.float32),
                            "local": make_inv_freq(dh, config.rope_local_base_freq)}
        self._inv_freq: dict = {}
        # sqrt(hidden) rounded to each table dtype, made here: a captured
        # step reads no tensor on the host
        self._embed_scale = {
            dt: float(torch.tensor(config.hidden_size ** 0.5, dtype=dt))
            for dt in (torch.float32, torch.bfloat16, torch.float16)}
        pat = config.sliding_window_pattern
        self.is_sliding = np.array(
            [(i + 1) % pat != 0 for i in range(config.num_hidden_layers)], dtype=bool)
        # layer -> its row within its group's store (DualKVCache)
        self.sliding_row = np.maximum(np.cumsum(self.is_sliding) - 1, 0)
        self.global_row = np.maximum(np.cumsum(~self.is_sliding) - 1, 0)

    def inv_freq(self, kind: str, device) -> torch.Tensor:
        key = (kind, str(device))
        if key not in self._inv_freq:
            self._inv_freq[key] = torch.from_numpy(self.inv_freq_np[kind]).to(device)
        return self._inv_freq[key]

    def _rope(self, positions: torch.Tensor) -> dict:
        """Both rope tables (cos, sin) for ``positions`` [B, T], by layer kind."""
        return {True: rope_tables(positions, self.inv_freq("local", positions.device)),
                False: rope_tables(positions, self.inv_freq("global", positions.device))}

    @property
    def prefill_chunk_bound(self) -> int:
        """Longest prompt chunk one forward may write: a longer one would
        alias the rotating sliding store (its early queries would read KV
        the chunk already evicted). The engine splits longer prompts."""
        return self.config.sliding_window

    def make_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   quantized: bool = False, *, device) -> DualKVCache:
        """The bounded dual-group cache: sliding layers store the last
        ``min(sliding_window, max_len)`` tokens in rotating slots, global
        layers ``max_len``."""
        cfg = self.config
        ns = int(self.is_sliding.sum())
        wcap = min(cfg.sliding_window, max_len)
        cls = QuantizedKVCache if quantized else KVCache
        hkv, dh = cfg.num_key_value_heads, cfg.head_dim
        return DualKVCache(
            sliding=cls.create(ns, batch, wcap, hkv, dh, dtype, window=wcap,
                               device=device),
            full=cls.create(cfg.num_hidden_layers - ns, batch, max_len, hkv, dh,
                            dtype, window=None, device=device),
        )

    # -- parameters ---------------------------------------------------------

    def init_params(self, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> dict:
        """Random dense params (tests / synthetic runs); norms at zero (a
        unit (1 + w) scale). The tower's come from ``vision.init_params``."""
        dev = resolve_device(device)
        cfg = self.config
        d, dh, di, l = (cfg.hidden_size, cfg.head_dim, cfg.intermediate_size,
                        cfg.num_hidden_layers)
        hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        gen = torch.Generator(device=dev).manual_seed(seed)

        def w(*shape, scale=None):
            scale = scale or (1.0 / np.sqrt(shape[-2]))
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
        return {
            "embed": w(cfg.vocab_size, d, scale=0.02),
            "layers": {
                "wq": w(l, d, hq * dh), "wk": w(l, d, hkv * dh), "wv": w(l, d, hkv * dh),
                "wo": w(l, hq * dh, d), "wg": w(l, d, di), "wu": w(l, d, di),
                "wd": w(l, di, d), "ln1": z(l, d), "ln2": z(l, d), "ln3": z(l, d),
                "ln4": z(l, d), "q_norm": z(l, dh), "k_norm": z(l, dh),
            },
            "norm": z(d),
        }

    def init_quantized_params(self, seed: int = 0, group_size: int = 64,
                              bits: int = 4, dtype=torch.bfloat16,
                              device="cuda") -> dict:
        """Random params built directly in quantized form on ``device``
        (random codes, scales that keep each projection's output near unit
        scale), for geometries whose dense init would not fit. The tower's
        come from ``vision.init_params``."""
        dev = resolve_device(device)
        cfg = self.config
        d, dh, di, l = (cfg.hidden_size, cfg.head_dim, cfg.intermediate_size,
                        cfg.num_hidden_layers)
        hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        ep = 32 // bits
        gen = torch.Generator(device=dev).manual_seed(seed)

        def rq(k, n):
            kp = -(-k // 512) * 512
            sc = 0.02 / np.sqrt(k)
            packed = torch.randint(-(2**31), 2**31, (l, kp // ep, n), generator=gen,
                                   dtype=torch.int32, device=dev)
            scales = torch.full((l, kp // group_size, n), sc, dtype=dtype, device=dev)
            biases = torch.full((l, kp // group_size, n), -sc * (2**bits - 1) / 2,
                                dtype=dtype, device=dev)
            return QuantizedTensor(packed=packed, scales=scales, biases=biases,
                                   bits=bits, group_size=group_size, shape=(k, n))

        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
        embed = torch.randn((cfg.vocab_size, d), generator=gen, device=dev,
                            dtype=torch.float32).mul_(0.02).to(dtype)
        return {
            "embed": embed,
            "layers": {
                "wq": rq(d, hq * dh), "wk": rq(d, hkv * dh), "wv": rq(d, hkv * dh),
                "wo": rq(hq * dh, d), "wg": rq(d, di), "wu": rq(d, di), "wd": rq(di, d),
                "ln1": z(l, d), "ln2": z(l, d), "ln3": z(l, d), "ln4": z(l, d),
                "q_norm": z(l, dh), "k_norm": z(l, dh),
            },
            "norm": z(d),
        }

    def from_hf_state_dict(self, weights: dict, dtype=torch.bfloat16) -> dict:
        """Params on the host from an HF-style state dict (CPU tensors or
        numpy arrays, linear weights [N, K]): linear weights turn to [K, N]
        and every per-layer weight stacks over layers. A VLM checkpoint's
        text model (``model.language_model.`` / ``language_model.model.``)
        is found too, and its tower and projector go under ``vision``."""
        cfg = self.config
        as_t = as_tensor
        prefix = "model.layers.{i}."
        if not any(k.startswith("model.layers.0.") for k in weights):
            prefix = "model.language_model.layers.{i}."
            if not any(k.startswith("model.language_model.layers.0.") for k in weights):
                prefix = "language_model.model.layers.{i}."
        top = prefix.split("layers")[0]
        layers = {}
        for name, suffix in self.HF_LAYER_MAP.items():
            mats = []
            for i in range(cfg.num_hidden_layers):
                m = as_t(weights[prefix.format(i=i) + suffix]).to(dtype)
                mats.append(m.T if name in self.LINEAR_KEYS else m)
            layers[name] = torch.stack(mats).contiguous()
        params = {
            "embed": as_t(weights[top + "embed_tokens.weight"]).to(dtype).contiguous(),
            "layers": layers,
            "norm": as_t(weights[top + "norm.weight"]).to(dtype).contiguous(),
        }
        if self.vision is not None:
            params["vision"] = self.vision.from_hf_state_dict(weights, dtype)
        return params

    def quantize_params(self, params: dict, group_size: int = 64, bits: int = 4) -> dict:
        """Group-wise quantize every linear weight (eagerly; each projection
        stays apart, as in JAX). The embedding stays dense (it is also the
        unembedding), and so does the vision tower."""
        out = dict(params)
        layers = dict(params["layers"])
        for name in self.LINEAR_KEYS:
            layers[name] = quantize(layers[name], group_size, bits)
        out["layers"] = layers
        return out

    # -- embedding / head ---------------------------------------------------

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        """The embedding rows times sqrt(hidden), the scale rounded to the
        table's dtype first, as JAX does."""
        e = params["embed"]
        return mesh_ops(self.mesh).embed(e, input_ids) * self._embed_scale[e.dtype]

    def unembed(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """Logits against the embedding table in h's dtype: f32 products and
        sums on the CPU (JAX's einsum), a bf16 GEMM with f32 accumulation on
        the card (a [V, D] f32 copy of the table would not fit a step)."""
        e = params["embed"].to(h.dtype)
        if h.device.type == "cpu":
            logits = _f32_dot(h, e.T)
        else:
            logits = torch.matmul(h, e.T).to(torch.float32)
        return mesh_ops(self.mesh).gather_vocab(logits)

    def embed_with_images(self, params: dict, input_ids: torch.Tensor,
                          pixel_values=None) -> torch.Tensor:
        """Token embeddings [B, T, D] with the projected image rows written
        over the image placeholders in order (the n-th placeholder takes the
        n-th row, across every image), unscaled and cast to the embedding's
        dtype. Runs the tower eagerly. pixel_values [N, 3, H, W] (a tensor
        or a host array). A placeholder count other than N x
        ``mm_tokens_per_image`` raises ``InferenceError`` before the tower
        runs (JAX clips the row index and repeats a row)."""
        h = self.embed(params, input_ids)
        if pixel_values is None or self.vision is None:
            return h
        cfg = self.config
        n = int(pixel_values.shape[0])
        have = int((input_ids == cfg.image_token_id).sum())
        if have != n * cfg.mm_tokens_per_image:
            raise InferenceError(
                f"{have} image placeholders for {n} image(s) of "
                f"{cfg.mm_tokens_per_image} tokens each")
        vp = params["vision"]
        proj = self.vision.project(vp, self.vision.forward(vp, pixel_values))
        return scatter_image_features(h, input_ids, proj.reshape(-1, proj.shape[-1]),
                                      (cfg.image_token_id,))

    # -- one decoder layer, around its attention ------------------------------

    def _qkv(self, p, h, i, rope, sliding):
        """ln1, the three projections apart, q/k-norm, rope: q [B, T, Hq, dh],
        k / v [B, T, Hkv, dh]."""
        cfg = self.config
        b, t = h.shape[0], h.shape[1]
        dh, eps = cfg.head_dim, cfg.rms_norm_eps
        x = _gemma_rms(h, p["ln1"][i], eps)
        q = linear(x, p["wq"], layer=i).reshape(b, t, cfg.num_attention_heads, dh)
        k = linear(x, p["wk"], layer=i).reshape(b, t, cfg.num_key_value_heads, dh)
        v = linear(x, p["wv"], layer=i).reshape(b, t, cfg.num_key_value_heads, dh)
        q = _gemma_rms(q, p["q_norm"][i], eps)
        k = _gemma_rms(k, p["k_norm"][i], eps)
        cos, sin = rope[sliding]
        return apply_rope_tables(q, cos, sin), apply_rope_tables(k, cos, sin), v

    def _block_out(self, p, h, attn, i):
        """wo, ln2, residual, ln3, the GeGLU MLP, ln4, residual."""
        eps = self.config.rms_norm_eps
        b, t = h.shape[0], h.shape[1]
        par = mesh_ops(self.mesh)
        h = h + _gemma_rms(par.tp_sum(linear(attn.reshape(b, t, -1), p["wo"], layer=i)),
                           p["ln2"][i], eps)
        x = _gemma_rms(h, p["ln3"][i], eps)
        g = linear(x, p["wg"], layer=i)
        u = linear(x, p["wu"], layer=i)
        mlp = par.tp_sum(linear(_gelu_tanh(g) * u, p["wd"], layer=i))
        return h + _gemma_rms(mlp, p["ln4"][i], eps)

    @property
    def _scale(self) -> float:
        return float(self.config.query_pre_attn_scalar) ** -0.5

    def _logits(self, params, h):
        return self.unembed(params, _gemma_rms(h, params["norm"],
                                               self.config.rms_norm_eps)).to(torch.float32)

    # -- forward over a contiguous or dual cache ------------------------------

    def __call__(self, params: dict, input_ids: torch.Tensor, cache,
                 positions: torch.Tensor, inputs_embeds: Optional[torch.Tensor] = None,
                 pixel_values=None, valid_lens: Optional[torch.Tensor] = None):
        """Forward writing this chunk's K/V into the cache IN PLACE.

        input_ids [B, T]; cache a KVCache / QuantizedKVCache (every layer at
        full length, windows by mask) or a DualKVCache, already advanced for
        these positions; positions [B, T]; inputs_embeds [B, T, D] (an image
        prompt's embeddings) or pixel_values (the tower runs here). Returns
        (logits [B, T, V] f32, cache)."""
        h = (inputs_embeds if inputs_embeds is not None
             else self.embed_with_images(params, input_ids, pixel_values))
        if isinstance(cache, DualKVCache):
            return self._dual_forward(params, h, cache, positions, valid_lens)
        cfg = self.config
        quantized = isinstance(cache, QuantizedKVCache)
        masks = {False: attention_mask(positions, cache.slot_positions, None),
                 True: attention_mask(positions, cache.slot_positions,
                                      cfg.sliding_window)}
        slots = cache.write_slot(positions).long()
        rope = self._rope(positions)
        p = params["layers"]
        for i in range(cfg.num_hidden_layers):
            sliding = bool(self.is_sliding[i])
            q, k, v = self._qkv(p, h, i, rope, sliding)
            if quantized:
                for store, val in zip((cache.k_q, cache.k_scale, cache.v_q, cache.v_scale),
                                      (*quantize_kv(k), *quantize_kv(v))):
                    scatter_drop(store[i], slots, val)
                attn = sdpa_quantized(q, cache.k_q[i], cache.k_scale[i], cache.v_q[i],
                                      cache.v_scale[i], masks[sliding], self._scale)
            else:
                scatter_drop(cache.k[i], slots, k)
                scatter_drop(cache.v[i], slots, v)
                attn = sdpa(q, cache.k[i].to(q.dtype), cache.v[i].to(q.dtype),
                            masks[sliding], self._scale)
            h = self._block_out(p, h, attn, i)
        return self._logits(params, h), cache

    def _dual_forward(self, params, h, cache: DualKVCache, positions, valid_lens):
        """Forward over the bounded DualKVCache. A sliding layer attends over
        [its store before this chunk's write | the chunk's fresh K/V] and
        THEN writes the chunk (writing first would evict tokens that earlier
        queries of the chunk still need once positions wrap); a global layer
        writes, then attends. The chunk's real tokens must fit the sliding
        store (the engine honours ``prefill_chunk_bound``). Every slot is
        computed on the device from the positions."""
        cfg = self.config
        b, t = h.shape[0], h.shape[1]
        dev = h.device
        quantized = isinstance(cache.sliding, QuantizedKVCache)
        wcap = cache.sliding.capacity
        if valid_lens is None and t > wcap:
            raise ValueError(f"prefill chunk {t} exceeds the sliding store ({wcap}); "
                             "split the prompt (see prefill_chunk_bound)")
        win = cfg.sliding_window
        valid = (torch.ones((b, t), dtype=torch.bool, device=dev) if valid_lens is None
                 else torch.arange(t, device=dev)[None, :] < valid_lens[:, None])
        neg = torch.full_like(positions, -1)
        fresh_pos = torch.where(valid, positions, neg)
        # what each sliding slot's DATA holds before this chunk's write:
        # advance() already claimed this chunk's slots in the metadata, but
        # the evicted token (one capacity behind) is still physically there
        sp = cache.sliding.slot_positions
        data_pos = torch.where(sp >= positions[:, :1], sp - wcap, sp)
        data_pos = torch.where(data_pos >= 0, data_pos, torch.full_like(data_pos, -1))
        mask_slide = torch.cat([attention_mask(positions, data_pos, win),
                                attention_mask(positions, fresh_pos, win)], dim=2)
        mask_full = attention_mask(positions, cache.full.slot_positions, None)
        s_slots = torch.where(valid, positions % wcap,
                              torch.full_like(positions, wcap)).long()
        g_slots = torch.where(valid, positions,
                              torch.full_like(positions, cache.full.capacity)).long()
        s, f = cache.sliding, cache.full
        stores = {True: (s.k_q, s.k_scale, s.v_q, s.v_scale) if quantized else (s.k, s.v),
                  False: (f.k_q, f.k_scale, f.v_q, f.v_scale) if quantized else (f.k, f.v)}
        rope = self._rope(positions)
        p = params["layers"]
        for i in range(cfg.num_hidden_layers):
            sliding = bool(self.is_sliding[i])
            row = int(self.sliding_row[i] if sliding else self.global_row[i])
            q, k, v = self._qkv(p, h, i, rope, sliding)
            fresh = (*quantize_kv(k), *quantize_kv(v)) if quantized else (k, v)
            layer = [a[row] for a in stores[sliding]]
            if sliding:
                parts = [torch.cat([a if quantized else a.to(q.dtype), x], dim=1)
                         for a, x in zip(layer, fresh)]
                attn = (sdpa_quantized(q, *parts, mask_slide, self._scale) if quantized
                        else sdpa(q, *parts, mask_slide, self._scale))
                for a, x in zip(layer, fresh):
                    scatter_drop(a, s_slots, x)
            else:
                for a, x in zip(layer, fresh):
                    scatter_drop(a, g_slots, x)
                attn = (sdpa_quantized(q, *layer, mask_full, self._scale) if quantized
                        else sdpa(q, layer[0].to(q.dtype), layer[1].to(q.dtype),
                                  mask_full, self._scale))
            h = self._block_out(p, h, attn, i)
        return self._logits(params, h), cache

    # -- forwards over the paged pool (continuous batching) -------------------

    def _window(self, sliding: bool) -> int:
        return self.config.sliding_window if sliding else 0

    def paged_forward(
        self,
        params: dict,
        input_ids: torch.Tensor,  # [B, T]
        pool,  # PagedKVPool, written in place
        block_tables: torch.Tensor,  # [B, maxP] int32 (-1 pad)
        positions: torch.Tensor,  # [B, T] int32 (-1 = no write)
        context_lens: torch.Tensor,  # [B] int32 lens AFTER this chunk
        with_logits: bool = True,
        last_idx: Optional[torch.Tensor] = None,  # [1] row to unembed
        lane_split: bool = False,  # the rows are decode lanes (split over dp)
    ):
        """Forward over the global paged pool. Decode (T == 1) attends
        through the paged decode-attention kernel with each layer's window
        (the kernel clips its page walk to it); a prefill chunk gathers its
        pages to dense K/V under the full or windowed mask. Returns (logits
        [B, T, V] f32, pool); with_logits=False stops after the last layer
        and returns (None, pool); ``last_idx`` unembeds that one row only
        (logits [B, 1, V]); ``lane_split`` as in ``LlamaModel``."""
        cfg = self.config
        par = mesh_ops(self.mesh)
        split = lane_split and par.dp > 1
        phys, slot = page_slots(block_tables, positions, pool.num_pages)
        if split:
            input_ids, positions, block_tables, context_lens = par.split_lanes(
                input_ids, positions, block_tables, context_lens)
        h = self.embed(params, torch.clamp(input_ids, min=0))
        decode = h.shape[1] == 1
        if not decode:
            kv_pos = _paged_kv_positions(block_tables, context_lens)
            masks = {False: attention_mask(positions, kv_pos),
                     True: attention_mask(positions, kv_pos, cfg.sliding_window)}
        rope = self._rope(positions)
        p = params["layers"]
        for i in range(cfg.num_hidden_layers):
            sliding = bool(self.is_sliding[i])
            q, k, v = self._qkv(p, h, i, rope, sliding)
            if split:
                k, v = par.gather_rows(k), par.gather_rows(v)
            scatter_tokens(pool, i, phys, slot, k, v)
            if decode:
                attn = paged_attention_decode(
                    q[:, 0].contiguous(), pool.k, pool.v, pool.k_scale, pool.v_scale,
                    i, block_tables, context_lens, self._scale, self._window(sliding),
                )[:, None]
            else:
                attn = gathered_attention(pool, i, block_tables, q, masks[sliding],
                                          self._scale)
            h = self._block_out(p, h, attn, i)
        if not with_logits:
            return None, pool
        if last_idx is not None:
            h = h.index_select(1, last_idx)
        return self._logits(params, h), pool

    def mixed_forward(
        self,
        params: dict,
        pool,  # PagedKVPool, written in place
        dec_tokens: torch.Tensor,  # [B] decode-lane tokens
        dec_positions: torch.Tensor,  # [B] write position per lane (-1 frozen)
        dec_ctx: torch.Tensor,  # [B] int32 context len incl. this token (>= 1)
        block_tables: torch.Tensor,  # [B, maxP] int32
        pf_ids: torch.Tensor,  # [Cs] prefill-rider tokens (-1 pad)
        pf_positions: torch.Tensor,  # [Cs] their positions (-1 pad)
        pf_lane: torch.Tensor,  # [1] int: the rider's lane
        pf_ctx: torch.Tensor,  # [1] int32: rider-lane tokens in the pool AFTER
        #          this slice
        pf_any: bool = True,  # the rider carries a token
        pf_embeds: Optional[torch.Tensor] = None,  # [Cs, D] the rider's image-
        #          prompt embeddings, in place of its ids' embeddings
    ):
        """One mixed continuous-batching step (the contract of
        ``LlamaModel.mixed_forward``): every decode lane advances one token
        through the paged decode-attention kernel with its layer's window,
        and a rider slice of prefill tokens (or of an image prompt's
        embeddings) writes its K/V through the same pass over the weights,
        attending by a masked (windowed on sliding layers) dense attention
        over its lane's gathered pages. Returns (decode logits [B, V] f32,
        pool); under dp > 1 as ``LlamaModel.mixed_forward``."""
        cfg = self.config
        par = mesh_ops(self.mesh)
        pf_table = block_tables[pf_lane.long()]  # [1, maxP]
        dec_phys, dec_slot = page_slots(block_tables, dec_positions[:, None],
                                        pool.num_pages)
        dec_tokens, dec_positions, dec_ctx, block_tables = par.split_lanes(
            dec_tokens, dec_positions, dec_ctx, block_tables)
        b = dec_tokens.shape[0]
        cs = pf_ids.shape[0]
        positions = torch.cat([dec_positions, pf_positions])  # [M]
        h = self.embed(params, torch.clamp(torch.cat([dec_tokens, pf_ids]), min=0)[None])
        if pf_embeds is not None:
            h = torch.cat([h[:, :b], pf_embeds.to(h.dtype)[None]], dim=1)
        pf_phys, pf_slot = page_slots(pf_table, pf_positions[None], pool.num_pages)
        phys = torch.cat([dec_phys[:, 0], pf_phys[0]])
        slot = torch.cat([dec_slot[:, 0], pf_slot[0]])
        if pf_any:
            kv_pos = _paged_kv_positions(pf_table, pf_ctx)
            pf_masks = {False: attention_mask(pf_positions[None], kv_pos),
                        True: attention_mask(pf_positions[None], kv_pos,
                                             cfg.sliding_window)}
        rope = self._rope(positions[None])
        p = params["layers"]
        for i in range(cfg.num_hidden_layers):
            sliding = bool(self.is_sliding[i])
            q, k, v = self._qkv(p, h, i, rope, sliding)  # [1, M, H, dh]
            scatter_tokens(pool, i, phys, slot, *par.gather_lead(b, k[0], v[0]))
            attn_dec = paged_attention_decode(
                q[0, :b].contiguous(), pool.k, pool.v, pool.k_scale, pool.v_scale,
                i, block_tables, dec_ctx, self._scale, self._window(sliding))
            if pf_any:
                attn_pf = gathered_attention(pool, i, pf_table, q[:, b:],
                                             pf_masks[sliding], self._scale)[0]
            else:
                attn_pf = torch.zeros((cs,) + q.shape[2:], dtype=q.dtype,
                                      device=q.device)
            h = self._block_out(p, h, torch.cat([attn_dec, attn_pf])[None], i)
        return self._logits(params, h[:, :b])[0], pool


# ---------------------------------------------------------------------------
# SigLIP vision tower + projector
# ---------------------------------------------------------------------------


class SigLipVision:
    """The SigLIP encoder and Gemma-3's multimodal projector (module
    docstring), over a plain dict of tensors: ``patch_w`` [D, C, P, P],
    ``patch_b``, ``pos`` [patches, D], ``post_ln_w`` / ``post_ln_b``,
    ``encoder`` (per-block weights stacked over blocks, linear ones [K, N])
    and the projector's ``proj_norm`` [D] and ``proj_w`` [D, text hidden]."""

    HF_PREFIXES = ("model.vision_tower.vision_model.", "vision_tower.vision_model.")
    HF_BLOCK_MAP = {
        "ln1_w": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
        "ln2_w": "layer_norm2.weight", "ln2_b": "layer_norm2.bias",
        "wq": "self_attn.q_proj.weight", "bq": "self_attn.q_proj.bias",
        "wk": "self_attn.k_proj.weight", "bk": "self_attn.k_proj.bias",
        "wv": "self_attn.v_proj.weight", "bv": "self_attn.v_proj.bias",
        "wo": "self_attn.out_proj.weight", "bo": "self_attn.out_proj.bias",
        "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
        "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
    }
    # the projector lives beside the tower, under one of three names
    PROJ_PREFIXES = ("model.multi_modal_projector.", "multi_modal_projector.")

    def __init__(self, vcfg: dict, text_hidden: int, tokens_per_image: int):
        self.hidden_size = vcfg.get("hidden_size", 1152)
        self.image_size = vcfg.get("image_size", 224)
        self.patch_size = vcfg.get("patch_size", 14)
        self.num_layers = vcfg.get("num_hidden_layers", 27)
        self.num_heads = vcfg.get("num_attention_heads", 16)
        self.intermediate_size = vcfg.get("intermediate_size", 4304)
        self.in_channels = vcfg.get("num_channels", 3)
        self.eps = vcfg.get("layer_norm_eps", 1e-6)
        self.patches = self.image_size // self.patch_size
        self.text_hidden = text_hidden
        self.tokens_per_image = tokens_per_image

    def from_hf_state_dict(self, weights: dict, dtype=torch.bfloat16) -> dict:
        """The tower's and the projector's params from an HF state dict
        (either tower prefix; linear weights turn to [K, N] and stack over
        blocks); {} when the dict holds no tower."""
        pre = next((p for p in self.HF_PREFIXES if any(k.startswith(p) for k in weights)),
                   None)
        if pre is None:
            return {}
        g = lambda k: as_tensor(weights[pre + k]).to(dtype).contiguous()
        enc = {}
        for ours, theirs in self.HF_BLOCK_MAP.items():
            mats = []
            for i in range(self.num_layers):
                m = as_tensor(weights[pre + f"encoder.layers.{i}." + theirs]).to(dtype)
                mats.append(m.T if m.dim() == 2 else m)
            enc[ours] = torch.stack(mats).contiguous()
        top = pre.replace("vision_tower.vision_model.", "")

        def gp(k):
            for cand in (top + "multi_modal_projector." + k,
                         *(p + k for p in self.PROJ_PREFIXES)):
                if cand in weights:
                    return as_tensor(weights[cand]).to(dtype).contiguous()
            raise KeyError(k)

        return {
            "patch_w": g("embeddings.patch_embedding.weight"),  # [D, C, P, P]
            "patch_b": g("embeddings.patch_embedding.bias"),
            "pos": g("embeddings.position_embedding.weight"),
            "post_ln_w": g("post_layernorm.weight"),
            "post_ln_b": g("post_layernorm.bias"),
            "encoder": enc,
            "proj_norm": gp("mm_soft_emb_norm.weight"),
            "proj_w": gp("mm_input_projection_weight"),
        }

    def init_params(self, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> dict:
        """Random tower and projector params (synthetic runs): weights at
        1/sqrt(fan-in), layer norms at one, biases and the position table
        small, the projector's (1 + w) norm at zero."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d, l, di = self.hidden_size, self.num_layers, self.intermediate_size
        pdim = self.in_channels * self.patch_size ** 2

        def w(*shape, fan_in=None):
            std = 1.0 / np.sqrt(fan_in or shape[-2])
            return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

        def small(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

        ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)
        return {
            "patch_w": w(d, self.in_channels, self.patch_size, self.patch_size,
                         fan_in=pdim),
            "patch_b": small(d), "pos": small(self.patches ** 2, d),
            "post_ln_w": ones(d), "post_ln_b": small(d),
            "encoder": {
                "ln1_w": ones(l, d), "ln1_b": small(l, d),
                "ln2_w": ones(l, d), "ln2_b": small(l, d),
                "wq": w(l, d, d), "bq": small(l, d), "wk": w(l, d, d), "bk": small(l, d),
                "wv": w(l, d, d), "bv": small(l, d), "wo": w(l, d, d), "bo": small(l, d),
                "fc1_w": w(l, d, di), "fc1_b": small(l, di),
                "fc2_w": w(l, di, d), "fc2_b": small(l, d),
            },
            "proj_norm": torch.zeros((d,), dtype=dtype, device=dev),
            "proj_w": w(d, self.text_hidden),
        }

    def forward(self, vp: dict, pixel_values) -> torch.Tensor:
        """pixel_values [N, C, H, W] (a tensor or a host array; moved to the
        tower's device) -> the post-LN features [N, patches^2, D], in the
        promoted dtype of the pixels and the weights."""
        x = torch.as_tensor(pixel_values, device=vp["patch_w"].device)
        n, c = x.shape[0], x.shape[1]
        p = self.patch_size
        gh, gw = x.shape[2] // p, x.shape[3] // p
        # the stride-P convolution as unfold + product (VALID: a ragged edge
        # is dropped)
        x = x[:, :, :gh * p, :gw * p].reshape(n, c, gh, p, gw, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(n, gh * gw, c * p * p)
        d = vp["patch_w"].shape[0]
        h = matmul_promoted(x, vp["patch_w"].reshape(d, -1).T, vp["patch_b"])
        h = h + vp["pos"][: gh * gw].to(h.dtype)
        t = gh * gw
        heads = self.num_heads
        hd = d // heads
        enc = vp["encoder"]
        for i in range(enc["wq"].shape[0]):
            lp = {k: a[i] for k, a in enc.items()}
            x = layer_norm(h, lp["ln1_w"], lp["ln1_b"], self.eps)
            q = matmul_promoted(x, lp["wq"], lp["bq"]).reshape(n, t, heads, hd)
            k = matmul_promoted(x, lp["wk"], lp["bk"]).reshape(n, t, heads, hd)
            v = matmul_promoted(x, lp["wv"], lp["bv"]).reshape(n, t, heads, hd)
            attn = sdpa(q, k, v, None, hd ** -0.5)
            h = h + matmul_promoted(attn.reshape(n, t, d), lp["wo"], lp["bo"])
            x = layer_norm(h, lp["ln2_w"], lp["ln2_b"], self.eps)
            y = _gelu_tanh(matmul_promoted(x, lp["fc1_w"], lp["fc1_b"]))
            h = h + matmul_promoted(y, lp["fc2_w"], lp["fc2_b"])
        return layer_norm(h, vp["post_ln_w"], vp["post_ln_b"], self.eps)

    def project(self, vp: dict, feats: torch.Tensor) -> torch.Tensor:
        """[N, patches^2, D] features -> [N, mm_tokens_per_image, text hidden]:
        the k x k average pool of the patch grid, the (1 + w) RMS norm (eps
        1e-6), the product, in the features' dtype."""
        n, t, d = feats.shape
        side = int(round(t ** 0.5))
        ts = int(round(self.tokens_per_image ** 0.5))
        k = side // ts
        x = feats.reshape(n, ts, k, ts, k, d).mean(dim=(2, 4)).reshape(n, ts * ts, d)
        x = _gemma_rms(x, vp["proj_norm"], 1e-6)
        return torch.matmul(x, vp["proj_w"].to(x.dtype))
