"""Qwen2-VL / Qwen2.5-VL in PyTorch: the M-RoPE text decoder and both
vision towers.

Port of the JAX package's ``pie_tpu/models/qwen2_vl.py``. The decoder is a
Llama with q/k/v biases, rope base 1e6 and M-RoPE: each rotary frequency
is driven by one of three position streams (t, h, w), split by
``mrope_section``. Text tokens carry three equal streams, so M-RoPE
collapses to plain rope; an image run carries its t/h/w grid
(``mrope_positions``, the host-side ``get_rope_index``), and the text
after it resumes at the grid's max + 1, so a sequence's later rope
positions run ``pos_delta`` behind its KV slots. Three forwards, as in
JAX: ``__call__`` over a contiguous bf16 or INT8 cache (``inputs_embeds``
and ``positions3`` for an image prompt), ``paged_forward`` (``pos_delta``
per lane) and ``mixed_forward`` (a rider slice of token ids or of image
embeddings, ``pf_pos3``, ``pos_delta``) over the paged pool, decode lanes
through the paged decode-attention kernel (K3 on the card).

Projections mirror JAX: ``wq`` / ``wk`` / ``wv`` apart with their biases,
``wg`` / ``wu`` apart, quantized ones through ``ops.quant.quantized_matmul``
(K1 at M <= 32, K2 above) with no ln prologue and no rope epilogue (the
biases come first, then M-RoPE on the host-built tables). The untied head
is quantized too (K1 / K2); a tied one is a plain product.

``Qwen2VisionTower`` is the ViT of both variants: patch embedding as a
matmul, 2-D rotary over merge-unit-grouped (h, w) positions, attention
under block-diagonal masks built from segment ids (per frame; for
Qwen2.5 per window, with full attention only at
``fullatt_block_indexes``), LayerNorm / GELU blocks (Qwen2-VL) or RMSNorm /
gated-SiLU blocks (Qwen2.5-VL), and the 2x2 PatchMerger. Its products are
plain large matmuls (``torch.matmul``) and its attention the port's
``sdpa``; it stays dense (never quantized) and runs eagerly, before the
prefill. Its MLPs follow the checkpoint's ``hidden_act`` (``quick_gelu``
for Qwen2-VL in the published configs, ``silu`` for Qwen2.5-VL), where the
JAX tower always uses the exact GELU and SiLU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from pie_tpu_torch.cache.kv_cache import QuantizedKVCache, quantize_kv, scatter_drop
from pie_tpu_torch.cache.paged import page_slots, scatter_tokens
from pie_tpu_torch.models.config import BaseConfig, _filter_kwargs
from pie_tpu_torch.models.llama import (
    _f32_dot,
    _prefill_mask,
    _silu,
    linear,
    prefill_attention,
    rms_norm,
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
class Qwen2VLConfig(BaseConfig):
    model_type: str = "qwen2_vl"
    hidden_size: int = 3584
    num_hidden_layers: int = 28
    intermediate_size: int = 18944
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    vocab_size: int = 152064
    rope_theta: float = 1000000.0
    mrope_section: tuple = (16, 24, 24)
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 32768
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision: Optional[dict] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Qwen2VLConfig":
        dd = dict(d)
        rs = dd.get("rope_scaling") or {}
        if "mrope_section" in rs:
            dd["mrope_section"] = tuple(rs["mrope_section"])
        if "vision_config" in dd:
            dd["vision"] = dd["vision_config"]
        return cls(**_filter_kwargs(cls, dd))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


def mrope_tables(positions3: torch.Tensor, inv_freq: torch.Tensor,
                 stream_for_dim: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [B, T, 1, D/2] of M-RoPE: frequency j turns with the
    position stream ``stream_for_dim[j]`` of ``positions3`` [3, B, T]."""
    pos = positions3[stream_for_dim]  # [D/2, B, T]
    freqs = pos.to(torch.float32) * inv_freq[:, None, None]
    return (torch.cos(freqs).permute(1, 2, 0)[:, :, None, :],
            torch.sin(freqs).permute(1, 2, 0)[:, :, None, :])


def stream_for_dim(sections) -> np.ndarray:
    """The position stream (0 t, 1 h, 2 w) of each rotary frequency."""
    return np.repeat(np.arange(3), np.asarray(sections))


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, inv_freq: torch.Tensor,
                sections) -> torch.Tensor:
    """M-RoPE of x [B, T, H, D] at positions3 [3, B, T]."""
    idx = torch.from_numpy(stream_for_dim(sections)).to(x.device)
    cos, sin = mrope_tables(positions3, inv_freq, idx)
    return apply_rope_tables(x, cos, sin)


def text_positions3(positions: torch.Tensor) -> torch.Tensor:
    """Text tokens: all three streams share the position."""
    return positions[None].expand((3,) + tuple(positions.shape))


def mrope_positions(input_ids: np.ndarray, image_token_id: int,
                    grid_thw: Optional[np.ndarray],
                    spatial_merge_size: int = 2) -> np.ndarray:
    """[3, B, T] t/h/w position streams (HF Qwen2-VL get_rope_index for
    image sequences), on the host."""
    b, t = input_ids.shape
    out = np.zeros((3, b, t), np.int64)
    for bi in range(b):
        ids = input_ids[bi]
        pos = 0  # running text position
        img_i = 0
        j = 0
        while j < t:
            if grid_thw is not None and ids[j] == image_token_id:
                tt, hh, ww = grid_thw[img_i]
                hh2, ww2 = hh // spatial_merge_size, ww // spatial_merge_size
                n = tt * hh2 * ww2
                tpos = np.repeat(np.arange(tt), hh2 * ww2)
                hpos = np.tile(np.repeat(np.arange(hh2), ww2), tt)
                wpos = np.tile(np.arange(ww2), tt * hh2)
                out[0, bi, j:j + n] = pos + tpos
                out[1, bi, j:j + n] = pos + hpos
                out[2, bi, j:j + n] = pos + wpos
                pos = pos + int(max(tt, hh2, ww2))
                j += n
                img_i += 1
            else:
                out[:, bi, j] = pos
                pos += 1
                j += 1
    return out


def image_positions(model, ids: np.ndarray, grid_thw, length: int) -> tuple:
    """(positions3 [3, B, T] int32, pos_delta) of an image prompt: the
    M-RoPE streams of ids [B, T] (host) and the decode offset of a prompt of
    ``length`` real tokens, ``length - (max position + 1)``: the rope
    position of the token at KV slot s after the prompt is s - pos_delta."""
    merge = getattr(model.vision, "spatial_merge_size", 2) or 2
    p3 = mrope_positions(np.asarray(ids), model.config.image_token_id,
                         np.asarray(grid_thw), spatial_merge_size=merge)
    return p3.astype(np.int32), length - (int(p3[:, :, :length].max()) + 1)


@register_model("qwen2_vl")
class Qwen2VLModel:
    """Qwen2-VL / Qwen2.5-VL over a plain dict of tensors (the JAX package's
    params layout: stacked decoder layers, ``vision`` for the tower)."""

    config_class = Qwen2VLConfig
    #: the engines pass M-RoPE streams and per-sequence decode offsets
    uses_mrope = True

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
    }
    HF_BIAS_MAP = {
        "bq": "self_attn.q_proj.bias",
        "bk": "self_attn.k_proj.bias",
        "bv": "self_attn.v_proj.bias",
    }

    #: the ("dp", "tp") mesh this rank's model runs over (None: unsharded;
    #: the collectives as in ``LlamaModel``, the tower replicated)
    mesh = None

    def __init__(self, config: Qwen2VLConfig):
        self.config = config
        self.inv_freq_np = make_inv_freq(config.resolved_head_dim, config.rope_theta)
        self.stream_np = stream_for_dim(config.mrope_section)
        self._consts: dict = {}
        self.vision = Qwen2VisionTower(config.vision) if config.vision else None

    def _dev(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(inv_freq, stream per frequency) on ``device``, made once: a
        captured step reads them and copies nothing from the host."""
        key = str(device)
        if key not in self._consts:
            self._consts[key] = (torch.from_numpy(self.inv_freq_np).to(device),
                                 torch.from_numpy(self.stream_np).to(device))
        return self._consts[key]

    def _rope(self, positions: torch.Tensor, positions3=None) -> tuple:
        """cos / sin tables: M-RoPE at positions3 [3, B, T], or, for text
        tokens, plain rope at positions [B, T] (the same values)."""
        inv, streams = self._dev(positions.device)
        if positions3 is None:
            return rope_tables(positions, inv)
        return mrope_tables(positions3, inv, streams)

    # -- parameters ---------------------------------------------------------

    def _shapes(self) -> dict:
        cfg = self.config
        d, dh, di = cfg.hidden_size, cfg.resolved_head_dim, cfg.intermediate_size
        hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        return {"wq": (d, hq * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
                "wo": (hq * dh, d), "wg": (d, di), "wu": (d, di), "wd": (di, d)}

    def init_params(self, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> dict:
        """Random dense text-decoder params, zero biases (tests / synthetic
        runs); the tower's come from ``vision.init_params``."""
        dev = resolve_device(device)
        cfg = self.config
        d, l = cfg.hidden_size, cfg.num_hidden_layers
        gen = torch.Generator(device=dev).manual_seed(seed)

        def w(*shape, scale=None):
            scale = scale or (0.02 / np.sqrt(shape[-2]))
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

        layers = {name: w(l, *shape) for name, shape in self._shapes().items()}
        for name, src in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
            layers[name] = torch.zeros((l, self._shapes()[src][1]), dtype=dtype,
                                       device=dev)
        layers["ln1"] = torch.ones((l, d), dtype=dtype, device=dev)
        layers["ln2"] = torch.ones((l, d), dtype=dtype, device=dev)
        params = {"embed": w(cfg.vocab_size, d, scale=0.02), "layers": layers,
                  "norm": torch.ones((d,), dtype=dtype, device=dev)}
        if not cfg.tie_word_embeddings:
            params["lm_head"] = w(d, cfg.vocab_size, scale=0.02)
        return params

    def init_quantized_params(self, seed: int = 0, group_size: int = 64, bits: int = 4,
                              dtype=torch.bfloat16, device="cuda") -> dict:
        """Random text params built directly in quantized form on
        ``device`` (random codes, scales that keep each projection's output
        near unit scale; dense biases of std 0.1, so they count), for
        geometries whose dense init would not fit. The tower's come from
        ``vision.init_params``."""
        dev = resolve_device(device)
        cfg = self.config
        d, l = cfg.hidden_size, cfg.num_hidden_layers
        ep = 32 // bits
        gen = torch.Generator(device=dev).manual_seed(seed)

        def rq(ll, k, n):
            kp = -(-k // 512) * 512
            sc = 0.02 / np.sqrt(k)
            packed = torch.randint(-(2**31), 2**31, (ll, kp // ep, n), generator=gen,
                                   dtype=torch.int32, device=dev)
            scales = torch.full((ll, kp // group_size, n), sc, dtype=dtype, device=dev)
            biases = torch.full((ll, kp // group_size, n), -sc * (2**bits - 1) / 2,
                                dtype=dtype, device=dev)
            return QuantizedTensor(packed=packed, scales=scales, biases=biases,
                                   bits=bits, group_size=group_size, shape=(k, n))

        shapes = self._shapes()
        layers = {name: rq(l, *shape) for name, shape in shapes.items()}
        for name, src in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
            layers[name] = (torch.randn((l, shapes[src][1]), generator=gen, device=dev)
                            * 0.1).to(dtype)
        layers["ln1"] = torch.ones((l, d), dtype=dtype, device=dev)
        layers["ln2"] = torch.ones((l, d), dtype=dtype, device=dev)
        embed = torch.randn((cfg.vocab_size, d), generator=gen, device=dev,
                            dtype=torch.float32).mul_(0.02).to(dtype)
        params = {"embed": embed, "layers": layers,
                  "norm": torch.ones((d,), dtype=dtype, device=dev)}
        if not cfg.tie_word_embeddings:
            params["lm_head"] = rq(1, d, cfg.vocab_size).layer(0)
        return params

    def from_hf_state_dict(self, weights: dict, dtype=torch.bfloat16) -> dict:
        """Params on the host from an HF state dict (CPU tensors or numpy
        arrays; ``model.layers.*`` or ``model.language_model.layers.*``):
        linear weights turn to [K, N], per-layer weights stack over layers,
        the tower's under ``vision``."""
        cfg = self.config
        as_t = as_tensor
        prefix, top = "model.layers.{i}.", "model."
        if not any(k.startswith("model.layers.0.") for k in weights):
            prefix, top = "model.language_model.layers.{i}.", "model.language_model."
        layers = {}
        for name, suffix in {**self.HF_LAYER_MAP, **self.HF_BIAS_MAP}.items():
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
        if not cfg.tie_word_embeddings and "lm_head.weight" in weights:
            params["lm_head"] = as_t(weights["lm_head.weight"]).to(dtype).T.contiguous()
        if self.vision is not None:
            params["vision"] = self.vision.from_hf_state_dict(weights, dtype)
        return params

    def quantize_params(self, params: dict, group_size: int = 64, bits: int = 4) -> dict:
        """Group-wise quantize every decoder projection (each apart, as in
        JAX) and the untied head; the embedding, the biases, the norms and
        the vision tower stay dense."""
        out = dict(params)
        layers = dict(params["layers"])
        for name in self.LINEAR_KEYS:
            layers[name] = quantize(layers[name], group_size, bits)
        out["layers"] = layers
        if "lm_head" in params:
            out["lm_head"] = quantize(params["lm_head"], group_size, bits)
        return out

    # -- embedding / head ---------------------------------------------------

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        return mesh_ops(self.mesh).embed(params["embed"], input_ids)

    def unembed(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """Vocab logits: the untied head (quantized or dense), or, tied, a
        product against the embedding table (f32 on the CPU as JAX's
        einsum, a bf16 GEMM with f32 accumulation on the card)."""
        if "lm_head" in params:
            logits = linear(h, params["lm_head"])
        else:
            e = params["embed"].to(h.dtype)
            if h.device.type == "cpu":
                logits = _f32_dot(h, e.T)
            else:
                logits = torch.matmul(h, e.T).to(torch.float32)
        return mesh_ops(self.mesh).gather_vocab(logits)

    def embed_with_images(self, params: dict, input_ids: torch.Tensor,
                          pixel_values=None, grid_thw=None) -> torch.Tensor:
        """Token embeddings [B, T, D] with the tower's merged features over
        the image / video placeholders (runs the tower eagerly: grid_thw,
        a host array, sets the window order and the masks)."""
        h = self.embed(params, input_ids)
        if pixel_values is None or self.vision is None:
            return h
        feats = self.vision.forward(params["vision"], pixel_values, grid_thw)
        cfg = self.config
        return scatter_image_features(h, input_ids, feats,
                                      (cfg.image_token_id, cfg.video_token_id))

    # -- one decoder layer, around its attention ------------------------------

    def _qkv(self, p, h, i, rope):
        """ln1, the biased projections apart, M-RoPE: q [B, T, Hq, dh],
        k / v [B, T, Hkv, dh]."""
        cfg = self.config
        b, t = h.shape[0], h.shape[1]
        dh = cfg.resolved_head_dim
        x = rms_norm(h, p["ln1"][i], cfg.rms_norm_eps)
        q = linear(x, p["wq"], p.get("bq"), layer=i).reshape(b, t, -1, dh)
        k = linear(x, p["wk"], p.get("bk"), layer=i).reshape(b, t, -1, dh)
        v = linear(x, p["wv"], p.get("bv"), layer=i).reshape(b, t, -1, dh)
        cos, sin = rope
        return apply_rope_tables(q, cos, sin), apply_rope_tables(k, cos, sin), v

    def _block_out(self, p, h, attn, i):
        """wo and the residual, ln2, the gated-SiLU MLP and the residual."""
        eps = self.config.rms_norm_eps
        b, t = h.shape[0], h.shape[1]
        par = mesh_ops(self.mesh)
        h = h + par.tp_sum(linear(attn.reshape(b, t, -1), p["wo"], layer=i))
        x = rms_norm(h, p["ln2"][i], eps)
        g = linear(x, p["wg"], layer=i)
        u = linear(x, p["wu"], layer=i)
        return h + par.tp_sum(linear(_silu(g) * u, p["wd"], layer=i))

    def _logits(self, params, h):
        return self.unembed(params, rms_norm(h, params["norm"],
                                             self.config.rms_norm_eps)).to(torch.float32)

    @property
    def _scale(self) -> float:
        return self.config.resolved_head_dim ** -0.5

    # -- forward over a contiguous cache ---------------------------------------

    def __call__(self, params: dict, input_ids: torch.Tensor, cache,
                 positions: torch.Tensor, inputs_embeds: Optional[torch.Tensor] = None,
                 pixel_values=None, grid_thw=None,
                 positions3: Optional[torch.Tensor] = None,
                 valid_lens: Optional[torch.Tensor] = None):
        """Forward writing this chunk's K/V into the cache IN PLACE.

        input_ids [B, T]; cache a KVCache / QuantizedKVCache already advanced
        for these positions; positions [B, T] (the KV slots); inputs_embeds
        [B, T, D] (an image prompt's embeddings) or pixel_values + grid_thw
        (the tower runs here); positions3 [3, B, T] the rope streams (None:
        text, the positions themselves). Returns (logits [B, T, V] f32,
        cache)."""
        if inputs_embeds is None:
            inputs_embeds = self.embed_with_images(params, input_ids, pixel_values,
                                                   grid_thw)
        h = inputs_embeds
        quantized = isinstance(cache, QuantizedKVCache)
        mask = attention_mask(positions, cache.slot_positions, None)
        slots = cache.write_slot(positions).long()
        rope = self._rope(positions, positions3)
        p = params["layers"]
        for i in range(self.config.num_hidden_layers):
            q, k, v = self._qkv(p, h, i, rope)
            if quantized:
                for store, val in zip((cache.k_q, cache.k_scale, cache.v_q, cache.v_scale),
                                      (*quantize_kv(k), *quantize_kv(v))):
                    scatter_drop(store[i], slots, val)
                attn = sdpa_quantized(q, cache.k_q[i], cache.k_scale[i], cache.v_q[i],
                                      cache.v_scale[i], mask, self._scale)
            else:
                scatter_drop(cache.k[i], slots, k)
                scatter_drop(cache.v[i], slots, v)
                attn = sdpa(q, cache.k[i].to(q.dtype), cache.v[i].to(q.dtype), mask,
                            self._scale)
            h = self._block_out(p, h, attn, i)
        return self._logits(params, h), cache

    # -- forwards over the paged pool (continuous batching) -------------------

    def paged_forward(
        self,
        params: dict,
        input_ids: torch.Tensor,  # [B, T]
        pool,  # PagedKVPool, written in place
        block_tables: torch.Tensor,  # [B, maxP] int32 (-1 pad)
        positions: torch.Tensor,  # [B, T] int32 (-1 = no write)
        context_lens: torch.Tensor,  # [B] int32 lens AFTER this chunk
        with_logits: bool = True,
        pos_delta: Optional[torch.Tensor] = None,  # [B] int32 M-RoPE offset
        last_idx: Optional[torch.Tensor] = None,  # [1] row to unembed
        lane_split: bool = False,  # the rows are decode lanes (split over dp)
    ):
        """Forward over the global paged pool. Rope turns at positions -
        pos_delta (an image-bearing sequence's rope stream lags its KV
        slots; None or zeros: text) while the pool writes at positions.
        Decode (T == 1) attends through the paged decode-attention kernel, a
        prefill chunk through ``prefill_attention``. Returns (logits
        [B, T, V] f32, pool); with_logits=False returns (None, pool);
        ``last_idx`` unembeds that one row only (logits [B, 1, V]);
        ``lane_split`` as in ``LlamaModel``."""
        par = mesh_ops(self.mesh)
        split = lane_split and par.dp > 1
        phys, slot = page_slots(block_tables, positions, pool.num_pages)
        if split:
            input_ids, positions, block_tables, context_lens, pos_delta = (
                par.split_lanes(input_ids, positions, block_tables, context_lens,
                                pos_delta))
        h = self.embed(params, torch.clamp(input_ids, min=0))
        decode = h.shape[1] == 1
        rope_pos = positions
        if pos_delta is not None:
            rope_pos = torch.where(positions >= 0, positions - pos_delta[:, None],
                                   positions)
        rope = self._rope(rope_pos)
        if not decode:
            mask = _prefill_mask(pool, self.config.resolved_head_dim, h.device, positions,
                                 block_tables, context_lens)
        p = params["layers"]
        for i in range(self.config.num_hidden_layers):
            q, k, v = self._qkv(p, h, i, rope)
            if split:
                k, v = par.gather_rows(k), par.gather_rows(v)
            scatter_tokens(pool, i, phys, slot, k, v)
            if decode:
                attn = paged_attention_decode(
                    q[:, 0].contiguous(), pool.k, pool.v, pool.k_scale, pool.v_scale,
                    i, block_tables, context_lens, self._scale)[:, None]
            else:
                attn = prefill_attention(pool, i, block_tables, q, positions,
                                         context_lens, self._scale, mask)
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
        pf_embeds_valid=True,  # bool tensor []: whether pf_embeds applies
        pf_pos3: Optional[torch.Tensor] = None,  # [3, Cs] the rider's M-RoPE
        #          streams (None: text, its positions)
        pos_delta: Optional[torch.Tensor] = None,  # [B] decode-lane offset
    ):
        """One mixed continuous-batching step (the contract of
        ``LlamaModel.mixed_forward``): every decode lane advances one token
        through the paged decode-attention kernel at rope position
        ``dec_positions - pos_delta``, and a rider slice (token ids, or the
        image prompt's embeddings) writes its K/V through the same pass over
        the weights at the M-RoPE streams ``pf_pos3``, attending by masked
        attention over its lane's pages (``prefill_attention``). Returns (decode
        logits [B, V] f32, pool); under dp > 1 as
        ``LlamaModel.mixed_forward``."""
        par = mesh_ops(self.mesh)
        pf_table = block_tables[pf_lane.long()]  # [1, maxP]
        dec_phys, dec_slot = page_slots(block_tables, dec_positions[:, None],
                                        pool.num_pages)
        dec_tokens, dec_positions, dec_ctx, block_tables, pos_delta = par.split_lanes(
            dec_tokens, dec_positions, dec_ctx, block_tables, pos_delta)
        b = dec_tokens.shape[0]
        cs = pf_ids.shape[0]
        positions = torch.cat([dec_positions, pf_positions])  # [M]
        if pos_delta is None and pf_pos3 is None:
            rope = self._rope(positions[None])
        else:
            dec_rope = dec_positions
            if pos_delta is not None:
                dec_rope = torch.where(dec_positions >= 0, dec_positions - pos_delta,
                                       dec_positions)
            pf3 = pf_pos3 if pf_pos3 is not None else text_positions3(pf_positions)
            positions3 = torch.cat([text_positions3(dec_rope), pf3], dim=1)[:, None, :]
            rope = self._rope(positions[None], positions3)
        h = self.embed(params, torch.clamp(torch.cat([dec_tokens, pf_ids]), min=0)[None])
        if pf_embeds is not None:
            pf_part = pf_embeds.to(h.dtype)
            if pf_embeds_valid is not True:
                pf_part = torch.where(pf_embeds_valid, pf_part, h[0, b:])
            h = torch.cat([h[:, :b], pf_part[None]], dim=1)
        pf_phys, pf_slot = page_slots(pf_table, pf_positions[None], pool.num_pages)
        phys = torch.cat([dec_phys[:, 0], pf_phys[0]])
        slot = torch.cat([dec_slot[:, 0], pf_slot[0]])
        if pf_any:
            pf_mask = _prefill_mask(pool, self.config.resolved_head_dim, h.device,
                                    pf_positions[None], pf_table, pf_ctx)
        p = params["layers"]
        for i in range(self.config.num_hidden_layers):
            q, k, v = self._qkv(p, h, i, rope)  # [1, M, H, dh]
            scatter_tokens(pool, i, phys, slot, *par.gather_lead(b, k[0], v[0]))
            attn_dec = paged_attention_decode(
                q[0, :b].contiguous(), pool.k, pool.v, pool.k_scale, pool.v_scale,
                i, block_tables, dec_ctx, self._scale)
            if pf_any:
                attn_pf = prefill_attention(pool, i, pf_table, q[:, b:],
                                            pf_positions[None], pf_ctx, self._scale,
                                            pf_mask)[0]
            else:
                attn_pf = torch.zeros((cs,) + q.shape[2:], dtype=q.dtype,
                                      device=q.device)
            h = self._block_out(p, h, torch.cat([attn_dec, attn_pf])[None], i)
        return self._logits(params, h[:, :b])[0], pool


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------


def _rms(x, w, eps):
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * w.to(torch.float32)).to(x.dtype)


def _gelu(x):
    return torch.nn.functional.gelu(x)  # the exact (erf) form


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


_ACTS = {"gelu": _gelu, "quick_gelu": _quick_gelu, "silu": _silu}


class Qwen2VisionTower:
    """The Qwen2-VL / Qwen2.5-VL ViT (module docstring)."""

    def __init__(self, vcfg: dict):
        self.embed_dim = vcfg.get("embed_dim", vcfg.get("hidden_size", 1280))
        self.depth = vcfg.get("depth", vcfg.get("num_hidden_layers", 32))
        self.num_heads = vcfg.get("num_heads", vcfg.get("num_attention_heads", 16))
        self.patch_size = vcfg.get("patch_size", 14)
        self.temporal_patch_size = vcfg.get("temporal_patch_size", 2)
        self.spatial_merge_size = vcfg.get("spatial_merge_size", 2)
        self.mlp_ratio = vcfg.get("mlp_ratio", 4)
        self.intermediate_size = vcfg.get("intermediate_size")
        self.out_hidden = vcfg.get("out_hidden_size", vcfg.get("hidden_size", 3584))
        self.in_channels = vcfg.get("in_channels", 3)
        # Qwen2.5-VL: windowed attention with full attention only at
        # fullatt_block_indexes, RMSNorm blocks, gated-SiLU MLP
        self.window_size = vcfg.get("window_size")
        self.fullatt_block_indexes = vcfg.get("fullatt_block_indexes")
        self.windowed = (self.window_size is not None
                         and self.fullatt_block_indexes is not None)
        # the MLP's activation (HF's defaults: quick_gelu for Qwen2-VL, silu
        # for Qwen2.5-VL's gate)
        self.act = _ACTS[vcfg.get("hidden_act", "silu" if self.windowed else "quick_gelu")]

    def _names(self) -> dict:
        if self.windowed:  # Qwen2.5 blocks: RMSNorm + gated-SiLU MLP
            return {
                "ln1_w": "norm1.weight", "ln2_w": "norm2.weight",
                "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
                "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
                "gate_w": "mlp.gate_proj.weight", "gate_b": "mlp.gate_proj.bias",
                "up_w": "mlp.up_proj.weight", "up_b": "mlp.up_proj.bias",
                "down_w": "mlp.down_proj.weight", "down_b": "mlp.down_proj.bias",
            }
        return {
            "ln1_w": "norm1.weight", "ln1_b": "norm1.bias",
            "ln2_w": "norm2.weight", "ln2_b": "norm2.bias",
            "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
            "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
            "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
            "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
        }

    def from_hf_state_dict(self, weights: dict, dtype=torch.bfloat16) -> dict:
        pre = ("visual." if any(k.startswith("visual.") for k in weights)
               else "model.visual.")
        g = lambda k: as_tensor(weights[pre + k]).to(dtype).contiguous()
        blocks = {}
        for ours, theirs in self._names().items():
            mats = []
            for i in range(self.depth):
                m = as_tensor(weights[pre + f"blocks.{i}." + theirs]).to(dtype)
                mats.append(m.T if m.dim() == 2 else m)
            blocks[ours] = torch.stack(mats).contiguous()
        out = {
            "patch_w": g("patch_embed.proj.weight"),  # [D, C, Tp, P, P]
            "blocks": blocks,
            "merger_ln_w": g("merger.ln_q.weight"),
            "merger_fc1_w": g("merger.mlp.0.weight").T.contiguous(),
            "merger_fc1_b": g("merger.mlp.0.bias"),
            "merger_fc2_w": g("merger.mlp.2.weight").T.contiguous(),
            "merger_fc2_b": g("merger.mlp.2.bias"),
        }
        if not self.windowed:  # Qwen2.5's merger norm is RMSNorm (no bias)
            out["merger_ln_b"] = g("merger.ln_q.bias")
        return out

    def init_params(self, seed: int = 0, dtype=torch.bfloat16, device="cuda") -> dict:
        """Random tower params (synthetic runs): weights at 1/sqrt(fan-in),
        norms at one, biases small."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d, l = self.embed_dim, self.depth
        inter = (self.intermediate_size if self.windowed
                 else int(d * self.mlp_ratio))
        m2d = d * self.spatial_merge_size ** 2
        pdim = self.in_channels * self.temporal_patch_size * self.patch_size ** 2

        def w(*shape, fan_in=None):
            std = 1.0 / np.sqrt(fan_in or shape[-2])
            return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

        def small(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

        ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)
        blocks = {"ln1_w": ones(l, d), "ln2_w": ones(l, d),
                  "qkv_w": w(l, d, 3 * d), "qkv_b": small(l, 3 * d),
                  "proj_w": w(l, d, d), "proj_b": small(l, d)}
        if self.windowed:
            blocks.update(gate_w=w(l, d, inter), gate_b=small(l, inter),
                          up_w=w(l, d, inter), up_b=small(l, inter),
                          down_w=w(l, inter, d), down_b=small(l, d))
        else:
            blocks.update(ln1_b=small(l, d), ln2_b=small(l, d),
                          fc1_w=w(l, d, inter), fc1_b=small(l, inter),
                          fc2_w=w(l, inter, d), fc2_b=small(l, d))
        out = {"patch_w": w(d, self.in_channels, self.temporal_patch_size,
                            self.patch_size, self.patch_size, fan_in=pdim),
               "blocks": blocks, "merger_ln_w": ones(d),
               "merger_fc1_w": w(m2d, m2d), "merger_fc1_b": small(m2d),
               "merger_fc2_w": w(m2d, self.out_hidden), "merger_fc2_b": small(self.out_hidden)}
        if not self.windowed:
            out["merger_ln_b"] = small(d)
        return out

    def _rot_pos(self, grid_thw: np.ndarray) -> np.ndarray:
        """[total_patches, 2] rotary (h, w) positions in the token order of
        the patches: merge-unit grouped ((h_block, w_block, mh, mw) raster),
        as HF rot_pos_emb."""
        out = []
        m = self.spatial_merge_size
        for tt, hh, ww in grid_thw:
            hpos = np.broadcast_to(np.arange(hh)[:, None], (hh, ww))
            wpos = np.broadcast_to(np.arange(ww)[None, :], (hh, ww))

            def grouped(p):
                return p.reshape(hh // m, m, ww // m, m).transpose(0, 2, 1, 3).reshape(-1)

            hw = np.stack([grouped(hpos), grouped(wpos)], -1)  # [hh*ww, 2]
            out.append(np.tile(hw, (tt, 1)))
        return np.concatenate(out, 0)

    def _window_order(self, grid: np.ndarray):
        """Window partition of the Qwen2.5 tower: (order [Nu], the merge-unit
        permutation into window-contiguous order; win_seg [N], the window
        of each permuted patch token; frame_seg [N], its frame). Edge
        windows are ragged."""
        m = self.spatial_merge_size
        ws = self.window_size // m // self.patch_size
        order, win_u, frame_u = [], [], []
        base = wid = frame0 = 0
        for tt, hh, ww in grid:
            lh, lw = hh // m, ww // m
            for t in range(tt):
                for bh in range(0, lh, ws):
                    for bw in range(0, lw, ws):
                        rows = np.arange(bh, min(bh + ws, lh))
                        cols = np.arange(bw, min(bw + ws, lw))
                        units = (t * lh * lw + rows[:, None] * lw
                                 + cols[None, :]).reshape(-1)
                        order.append(units + base)
                        win_u.append(np.full(units.size, wid))
                        frame_u.append(np.full(units.size, frame0 + t))
                        wid += 1
            base += tt * lh * lw
            frame0 += tt
        m2 = m * m
        return (np.concatenate(order), np.repeat(np.concatenate(win_u), m2),
                np.repeat(np.concatenate(frame_u), m2))

    @staticmethod
    def _frame_seg(grid: np.ndarray) -> np.ndarray:
        """Frame id per patch token in natural order (full attention is per
        frame)."""
        segs, f = [], 0
        for tt, hh, ww in grid:
            segs.append(np.repeat(np.arange(f, f + tt), hh * ww))
            f += tt
        return np.concatenate(segs)

    def forward(self, vp: dict, pixel_values, grid_thw) -> torch.Tensor:
        """pixel_values [total_patches, C*Tp*P*P] (a tensor on the tower's
        device, or a host array); grid_thw [n_images, 3] on the host.
        Returns the merged tokens [N_merged, out_hidden]."""
        dev = vp["patch_w"].device
        x = torch.as_tensor(pixel_values, device=dev)
        d = vp["patch_w"].shape[0]
        h = matmul_promoted(x, vp["patch_w"].reshape(d, -1).T)  # patch embedding
        grid = np.asarray(grid_thw)
        hw = self._rot_pos(grid)  # [N, 2]
        n = h.shape[0]
        m2 = self.spatial_merge_size ** 2
        seg = lambda s: torch.from_numpy(s[:, None] == s[None, :])[None].to(dev)
        order = None
        if self.windowed:
            order, win_seg, frame_seg = self._window_order(grid)
            perm = torch.from_numpy(order).to(dev)
            h = h.reshape(n // m2, m2, -1)[perm].reshape(n, -1)
            hw = hw.reshape(n // m2, m2, 2)[order].reshape(n, 2)
            mask_win, mask_full = seg(win_seg), seg(frame_seg)
            is_full = set(self.fullatt_block_indexes)
        else:
            mask_full = mask_win = seg(self._frame_seg(grid))
            is_full = set(range(self.depth))
        heads = self.num_heads
        head_dim = self.embed_dim // heads
        half = head_dim // 2
        inv = 1.0 / (10000.0 ** (np.arange(0, half, 2, dtype=np.float64) / half))
        freqs = np.concatenate([hw[:, 0:1] * inv[None], hw[:, 1:2] * inv[None]], -1)
        cos = torch.from_numpy(np.cos(freqs).astype(np.float32)).to(dev)[None, :, None]
        sin = torch.from_numpy(np.sin(freqs).astype(np.float32)).to(dev)[None, :, None]
        blocks = vp["blocks"]
        for i in range(blocks["qkv_w"].shape[0]):
            p = {k: a[i] for k, a in blocks.items()}
            if self.windowed:
                x = _rms(h, p["ln1_w"], 1e-6)
            else:
                x = layer_norm(h, p["ln1_w"], p["ln1_b"], 1e-6)
            qkv = matmul_promoted(x, p["qkv_w"], p["qkv_b"]).reshape(n, 3, heads, head_dim)
            q = apply_rope_tables(qkv[None, :, 0], cos, sin)
            k = apply_rope_tables(qkv[None, :, 1], cos, sin)
            attn = sdpa(q, k, qkv[None, :, 2], mask_full if i in is_full else mask_win,
                        head_dim ** -0.5)[0]
            h = h + matmul_promoted(attn.reshape(n, -1), p["proj_w"], p["proj_b"])
            if self.windowed:  # gated SiLU
                x = _rms(h, p["ln2_w"], 1e-6)
                y = (self.act(matmul_promoted(x, p["gate_w"], p["gate_b"]))
                     * matmul_promoted(x, p["up_w"], p["up_b"]))
                y = matmul_promoted(y, p["down_w"], p["down_b"])
            else:
                x = layer_norm(h, p["ln2_w"], p["ln2_b"], 1e-6)
                y = self.act(matmul_promoted(x, p["fc1_w"], p["fc1_b"]))
                y = matmul_promoted(y, p["fc2_w"], p["fc2_b"])
            h = h + y
        # PatchMerger: norm, group each merge unit, MLP
        if self.windowed:
            h = _rms(h, vp["merger_ln_w"], 1e-6)
        else:
            h = layer_norm(h, vp["merger_ln_w"], vp["merger_ln_b"], 1e-6)
        h = h.reshape(-1, m2 * self.embed_dim)
        y = _gelu(matmul_promoted(h, vp["merger_fc1_w"], vp["merger_fc1_b"]))
        out = matmul_promoted(y, vp["merger_fc2_w"], vp["merger_fc2_b"])
        if order is not None:  # undo the window permutation
            out = out[torch.from_numpy(np.argsort(order)).to(dev)]
        return out
