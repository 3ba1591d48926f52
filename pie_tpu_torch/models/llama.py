"""Llama-3 family decoder in PyTorch (also mistral / qwen2 config flags).

Port of the JAX package's ``pie_tpu/models/llama.py``: the single-stream
forward (``LlamaModel.__call__``) and the two forwards of the
continuous-batching path over the paged KV pool (``paged_forward`` and
``mixed_forward``), with the same parameter dictionary (decoder layers
stacked on a leading axis, fused ``wqkv``/``wgu`` when quantized), the same
fused-ln / fused-rope / fused-MLP gates and the same cast points, and the
HF checkpoint mapping (``from_hf_state_dict``). The layer ``scan`` becomes
a Python loop; the KV cache and the paged pool are written IN PLACE (see
``cache/kv_cache.py`` and ``cache/paged.py``). Quantized projections go
through ``ops.quant.quantized_matmul``, the decode MLP block through
``ops.fused_mlp.fused_mlp_stacked`` and decode lanes through
``ops.paged_attention.paged_attention_decode``: the CUDA kernels for
tensors on the card, the plain versions for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from pie_tpu_torch.cache.kv_cache import QuantizedKVCache, quantize_kv, scatter_drop
from pie_tpu_torch.cache.paged import (
    PAGE_SIZE,
    gather_pages,
    page_slots,
    scatter_tokens,
)
from pie_tpu_torch.models.config import BaseConfig, _filter_kwargs
from pie_tpu_torch.models.registry import register_model
from pie_tpu_torch.ops.attention import attention_mask, sdpa, sdpa_quantized
from pie_tpu_torch.ops.fused_mlp import fused_mlp_stacked, fused_mlp_supported
from pie_tpu_torch.ops.paged_attention import paged_attention_decode
from pie_tpu_torch.ops.quant import (
    QuantizedTensor,
    pack_codes,
    quantize,
    quantized_matmul,
    unpack_tpu_codes_np,
)
from pie_tpu_torch.ops.rope import (
    RopeScalingConfig,
    apply_rope_cs,
    apply_rope_tables,
    make_inv_freq,
    rope_qkv_cs,
    rope_tables,
)
from pie_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig(BaseConfig):
    model_type: str = "llama"
    hidden_size: int = 2048
    num_hidden_layers: int = 16
    intermediate_size: int = 8192
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    vocab_size: int = 128256
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    mlp_bias: bool = False
    max_position_embeddings: int = 131072

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LlamaConfig":
        return cls(**_filter_kwargs(cls, d))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


def _f32_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=f32)``: widen, then an f32
    product (exact products of bf16 operands, f32 sums)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * w.to(torch.float32)).to(x.dtype)


def _row(a: torch.Tensor, layer) -> torch.Tensor:
    """Layer ``layer`` of a stacked [L, ...] array (a view)."""
    return a[layer]


def linear(
    x: torch.Tensor, w, bias=None, layer=None, rope_cs=None, rope_dim=0,
    ln_w=None, ln_eps=0.0,
) -> torch.Tensor:
    """A (possibly quantized, possibly layer-stacked) linear layer with the
    optional rms-norm prologue and fused-QKV rope epilogue."""
    if isinstance(w, QuantizedTensor):
        y = quantized_matmul(x, w, layer=layer, rope_cs=rope_cs,
                             rope_dim=rope_dim, ln_w=ln_w, ln_eps=ln_eps)
    else:
        if ln_w is not None:
            lw = _row(ln_w, layer) if layer is not None and ln_w.dim() == 2 else ln_w
            x = rms_norm(x, lw, ln_eps)
        if layer is not None and w.dim() == 3:
            w = _row(w, layer)
        y = _f32_dot(x, w.to(x.dtype)).to(x.dtype)
        if rope_dim:
            shp = y.shape
            y = apply_rope_cs(
                y.reshape(-1, shp[-1]), rope_cs[0], rope_cs[1], rope_dim
            ).reshape(shp)
    if bias is not None:
        assert rope_dim == 0, "rope epilogue requires a bias-free projection"
        if layer is not None and bias.dim() == 2:
            bias = _row(bias, layer)
        y = y + bias.to(y.dtype)
    return y


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)  # jax.nn.silu's formula


def _to_torch(a) -> torch.Tensor:
    """numpy array (ml_dtypes bfloat16 included) -> CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16
        )
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def from_jax_params(params_np, device):
    """Carry the JAX package's Llama params across to ``device``.

    ``params_np`` is the JAX tree with every array converted by
    ``np.asarray`` and every QuantizedTensor given as a dict with keys
    packed, scales, biases, bits, group_size, shape. Codes are unpacked
    from the TPU's plane-paired packing and repacked in the port's layout;
    nothing is re-quantized."""
    dev = resolve_device(device)
    if isinstance(params_np, dict):
        if {"packed", "scales", "biases", "bits"} <= params_np.keys():
            bits = int(params_np["bits"])
            codes = unpack_tpu_codes_np(params_np["packed"], bits)
            return QuantizedTensor(
                packed=pack_codes(torch.from_numpy(codes), bits).to(dev),
                scales=_to_torch(params_np["scales"]).to(dev),
                biases=_to_torch(params_np["biases"]).to(dev),
                bits=bits,
                group_size=int(params_np["group_size"]),
                shape=tuple(int(s) for s in params_np["shape"]),
            )
        return {k: from_jax_params(v, dev) for k, v in params_np.items()}
    return _to_torch(params_np).to(dev)


@register_model("llama")
class LlamaModel:
    """Llama decoder over a plain dict of tensors (the JAX package's
    params layout)."""

    # names of layer weights that are linear (quantizable)
    LINEAR_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")

    # HF checkpoint key mapping: our name -> HF per-layer suffix
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
    HF_PREFIX = "model.layers.{i}."
    HF_TOP = {
        "embed": "model.embed_tokens.weight",
        "norm": "model.norm.weight",
        "lm_head": "lm_head.weight",
    }

    def __init__(self, config: LlamaConfig):
        self.config = config
        self.inv_freq_np = make_inv_freq(
            config.resolved_head_dim,
            config.rope_theta,
            RopeScalingConfig.from_dict(config.rope_scaling),
        )
        self._inv_freq: dict = {}

    def inv_freq(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._inv_freq:
            self._inv_freq[key] = torch.from_numpy(self.inv_freq_np).to(device)
        return self._inv_freq[key]

    # -- parameter construction ------------------------------------------

    def init_params(self, seed: int = 0, dtype=torch.bfloat16,
                    device="cuda") -> dict:
        """Random-init dense params (tests / synthetic runs)."""
        dev = resolve_device(device)
        cfg = self.config
        d, dh = cfg.hidden_size, cfg.resolved_head_dim
        hq, hkv, di = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.intermediate_size)
        l = cfg.num_hidden_layers
        gen = torch.Generator(device=dev).manual_seed(seed)

        def w(*shape, scale=None):
            scale = scale or (1.0 / np.sqrt(shape[-2]))
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

        params = {
            "embed": w(cfg.vocab_size, d, scale=0.02),
            "layers": {
                "wq": w(l, d, hq * dh), "wk": w(l, d, hkv * dh),
                "wv": w(l, d, hkv * dh), "wo": w(l, hq * dh, d),
                "wg": w(l, d, di), "wu": w(l, d, di), "wd": w(l, di, d),
                "ln1": torch.ones((l, d), dtype=dtype, device=dev),
                "ln2": torch.ones((l, d), dtype=dtype, device=dev),
            },
            "norm": torch.ones((d,), dtype=dtype, device=dev),
        }
        if not cfg.tie_word_embeddings:
            params["lm_head"] = w(d, cfg.vocab_size, scale=0.02)
        return params

    def from_hf_state_dict(self, weights: dict, dtype=torch.bfloat16) -> dict:
        """Params on the host from an HF-style state dict (CPU tensors or
        numpy arrays, linear weights [N, K]): linear weights turn to [K, N]
        and every per-layer weight stacks over layers. Attention biases are
        kept when the config asks for them and the checkpoint has them; a
        tied model gets no ``lm_head``."""
        cfg = self.config
        as_t = lambda a: a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))
        use_bias = cfg.attention_bias and (
            self.HF_PREFIX.format(i=0) + self.HF_BIAS_MAP["bq"]) in weights
        names = {**self.HF_LAYER_MAP, **(self.HF_BIAS_MAP if use_bias else {})}
        layers = {}
        for name, suffix in names.items():
            mats = []
            for i in range(cfg.num_hidden_layers):
                m = as_t(weights[self.HF_PREFIX.format(i=i) + suffix]).to(dtype)
                mats.append(m.T if name in self.LINEAR_KEYS else m)
            layers[name] = torch.stack(mats)
        params = {
            "embed": as_t(weights[self.HF_TOP["embed"]]).to(dtype).contiguous(),
            "layers": layers,
            "norm": as_t(weights[self.HF_TOP["norm"]]).to(dtype).contiguous(),
        }
        if not cfg.tie_word_embeddings:
            params["lm_head"] = as_t(weights[self.HF_TOP["lm_head"]]).to(dtype).T.contiguous()
        return params

    def quantize_params(
        self, params: dict, group_size: int = 64, bits: int = 4,
        fuse_projections: bool = True, quantize_lm_head: bool = True,
    ) -> dict:
        """Group-wise quantize every linear weight; fuse QKV and gate/up
        along the output dim (fewer, larger launches on the decode path)."""
        out = dict(params)
        layers = dict(params["layers"])
        fuse = fuse_projections and "bq" not in layers
        names = list(self.LINEAR_KEYS)
        if fuse:
            layers["wqkv"] = quantize(
                torch.cat([layers.pop("wq"), layers.pop("wk"), layers.pop("wv")],
                          dim=-1), group_size, bits,
            )
            layers["wgu"] = quantize(
                torch.cat([layers.pop("wg"), layers.pop("wu")], dim=-1),
                group_size, bits,
            )
            names = ["wo", "wd"]
        for name in names:
            layers[name] = quantize(layers[name], group_size, bits)
        out["layers"] = layers
        if "lm_head" in params:
            out["lm_head"] = quantize(params["lm_head"], group_size, bits)
        elif quantize_lm_head:
            # tied embeddings: keep the table for lookups, quantize the head
            out["lm_head"] = quantize(
                params["embed"].T.to(torch.float32), group_size, bits
            )
        return out

    def init_quantized_params(
        self, seed: int = 0, group_size: int = 64, bits: int = 4,
        dtype=torch.bfloat16, device="cuda",
    ) -> dict:
        """Random params built directly in quantized form on ``device``
        (random packed codes + sane scales), as the JAX package does for
        geometries whose dense init would not fit."""
        dev = resolve_device(device)
        cfg = self.config
        d, dh = cfg.hidden_size, cfg.resolved_head_dim
        hq, hkv, di = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.intermediate_size)
        l = cfg.num_hidden_layers
        ep = 32 // bits
        gen = torch.Generator(device=dev).manual_seed(seed)

        def rq(ll, k, n):
            kp = -(-k // 512) * 512
            g = group_size
            sc = 0.02 / np.sqrt(k)
            packed = torch.randint(
                -(2**31), 2**31, (ll, kp // ep, n), generator=gen,
                dtype=torch.int32, device=dev,
            )
            scales = torch.full((ll, kp // g, n), sc, dtype=dtype, device=dev)
            biases = torch.full((ll, kp // g, n), -sc * (2**bits - 1) / 2,
                                dtype=dtype, device=dev)
            return QuantizedTensor(packed=packed, scales=scales, biases=biases,
                                   bits=bits, group_size=g, shape=(k, n))

        layers = {
            "wqkv": rq(l, d, (hq + 2 * hkv) * dh),
            "wo": rq(l, hq * dh, d),
            "wgu": rq(l, d, 2 * di),
            "wd": rq(l, di, d),
            "ln1": torch.ones((l, d), dtype=dtype, device=dev),
            "ln2": torch.ones((l, d), dtype=dtype, device=dev),
        }
        embed = torch.randn((cfg.vocab_size, d), generator=gen, device=dev,
                            dtype=torch.float32).mul_(0.02).to(dtype)
        params = {
            "embed": embed,
            "layers": layers,
            "norm": torch.ones((d,), dtype=dtype, device=dev),
            "lm_head": rq(1, d, cfg.vocab_size).layer(0),
        }
        return params

    # -- projection helpers ------------------------------------------------

    def _attn_proj(self, p, x, b, t, layer=None, rope_cs=None, rope_dim=0,
                   ln_w=None, ln_eps=0.0):
        cfg = self.config
        dh = cfg.resolved_head_dim
        hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        if "wqkv" in p:
            y = linear(x, p["wqkv"], layer=layer, rope_cs=rope_cs,
                       rope_dim=rope_dim, ln_w=ln_w, ln_eps=ln_eps)
            nq, nk = hq * dh, hkv * dh
            q, k, v = y[..., :nq], y[..., nq:nq + nk], y[..., nq + nk:]
        else:
            if ln_w is not None:
                lw = _row(ln_w, layer) if layer is not None and ln_w.dim() == 2 else ln_w
                x = rms_norm(x, lw, ln_eps)
            q = linear(x, p["wq"], p.get("bq"), layer=layer)
            k = linear(x, p["wk"], p.get("bk"), layer=layer)
            v = linear(x, p["wv"], p.get("bv"), layer=layer)
        return (q.reshape(b, t, hq, dh), k.reshape(b, t, hkv, dh),
                v.reshape(b, t, hkv, dh))

    def _mlp(self, p, x, layer=None, ln_w=None, ln_eps=0.0):
        if "wgu" in p:
            y = linear(x, p["wgu"], layer=layer, ln_w=ln_w, ln_eps=ln_eps)
            di = y.shape[-1] // 2
            g, u = y[..., :di], y[..., di:]
        else:
            if ln_w is not None:
                lw = _row(ln_w, layer) if layer is not None and ln_w.dim() == 2 else ln_w
                x = rms_norm(x, lw, ln_eps)
            g = linear(x, p["wg"], layer=layer)
            u = linear(x, p["wu"], layer=layer)
        return linear(_silu(g) * u, p["wd"], layer=layer)

    def _fused_mlp_ok(self, p, m: int) -> bool:
        """The JAX package's auto policy for the one-launch decode MLP block
        (K4 on the card, its plain version on the CPU): small models
        (hidden <= 2048), stacked quantized wo / wgu / wd, M <= 8 and the
        kernel's own gate."""
        if self.config.hidden_size > 2048:
            return False
        if not ("wo" in p and "wgu" in p and "wd" in p):
            return False
        if not isinstance(p["wo"], QuantizedTensor):
            return False
        return fused_mlp_supported(p["wo"], p["wgu"], p["wd"], m)

    def _mlp_block(self, p, h, attn_flat, layer, eps, fused, fused_ln=False):
        """wo projection + residual + ln2 + gated MLP + residual: one
        launch (fused_mlp_stacked) when ``fused``."""
        if fused:
            b, t, dm = h.shape
            out = fused_mlp_stacked(
                attn_flat.reshape(b * t, -1).contiguous(), h.reshape(b * t, dm),
                p["ln2"], layer, p["wo"], p["wgu"], p["wd"], eps=eps,
            )
            return out.reshape(b, t, dm)
        h = h + linear(attn_flat, p["wo"], layer=layer)
        if fused_ln:
            # ln2 folds into the wgu kernel prologue
            return h + self._mlp(p, h, layer=layer, ln_w=p["ln2"], ln_eps=eps)
        x = rms_norm(h, _row(p["ln2"], layer), eps)
        return h + self._mlp(p, x, layer=layer)

    def embed(self, params: dict, input_ids: torch.Tensor) -> torch.Tensor:
        return params["embed"][input_ids]

    def unembed(self, params: dict, h: torch.Tensor, ln_w=None,
                ln_eps: float = 0.0) -> torch.Tensor:
        """Vocab logits. ln_w: the final norm folded into the lm_head
        prologue (callers then pass the pre-norm hidden state)."""
        if ln_w is not None and "lm_head" not in params:
            h = rms_norm(h, ln_w, ln_eps)
            ln_w = None
        if "lm_head" in params:
            return linear(h, params["lm_head"], ln_w=ln_w, ln_eps=ln_eps)
        return torch.einsum(
            "btd,vd->btv", h.to(torch.float32),
            params["embed"].to(h.dtype).to(torch.float32),
        )

    # -- forward -------------------------------------------------------------

    def __call__(
        self,
        params: dict,
        input_ids: torch.Tensor,
        cache,
        positions: torch.Tensor,
        inputs_embeds: Optional[torch.Tensor] = None,
        valid_lens: Optional[torch.Tensor] = None,
    ):
        """Forward pass writing this chunk's K/V into the cache IN PLACE.

        input_ids: [B, T]; cache: KVCache / QuantizedKVCache already advanced
        for these positions; positions: [B, T]. Returns (logits [B, T, V]
        f32, cache). inputs_embeds [B, T, D]: embeddings in place of the
        ids' (as in JAX).
        """
        cfg = self.config
        dh = cfg.resolved_head_dim
        hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        h = self.embed(params, input_ids) if inputs_embeds is None else inputs_embeds
        b, t = h.shape[0], h.shape[1]
        dev = h.device
        quantized = isinstance(cache, QuantizedKVCache)
        mask = attention_mask(positions, cache.slot_positions, cache.window)
        write_slots = cache.write_slot(positions)
        if valid_lens is not None and cache.window is not None:
            # rotating slots alias once positions wrap: pads must not write
            valid = torch.arange(t, device=dev)[None, :] < valid_lens[:, None]
            write_slots = torch.where(
                valid, write_slots, torch.full_like(write_slots, cache.capacity)
            )
        write_slots = write_slots.long()
        p = params["layers"]
        # decode with a fused bias-free QKV projection: the rotation is the
        # projection kernel's epilogue
        fused_rope = t == 1 and "wqkv" in p and dh in (64, 128)
        inv_freq = self.inv_freq(dev)
        rope_cs = None
        if fused_rope:
            rope_cs = rope_qkv_cs(positions[:, 0], inv_freq, hq, hkv, dh)
        else:
            cos, sin = rope_tables(positions, inv_freq)
        scale = dh**-0.5
        eps = cfg.rms_norm_eps
        # decode: ln1 / ln2 fold into the projection kernels' prologue
        fused_ln = t == 1 and b * t <= 32
        use_fused_mlp = self._fused_mlp_ok(p, b * t)
        if not quantized and cache.window is None:
            # contiguous slots: a dynamic_update_slice per sequence, whose
            # start clamps so the update fits (XLA semantics)
            start = torch.clamp(positions[:, 0], 0, cache.capacity - t)
            rows = torch.arange(b, device=dev)[:, None]
            cols = (start[:, None] + torch.arange(t, device=dev)[None, :]).long()

        for i in range(cfg.num_hidden_layers):
            if fused_ln:
                x, ln_kw = h, dict(ln_w=p["ln1"], ln_eps=eps)
            else:
                x, ln_kw = rms_norm(h, _row(p["ln1"], i), eps), {}
            q, k, v = self._attn_proj(
                p, x, b, t, layer=i, rope_cs=rope_cs,
                rope_dim=dh if fused_rope else 0, **ln_kw,
            )
            if not fused_rope:
                q = apply_rope_tables(q, cos, sin)
                k = apply_rope_tables(k, cos, sin)
            if quantized:
                kq, ks = quantize_kv(k)
                vq, vs = quantize_kv(v)
                # in place: this layer's slices of the int8 cache
                scatter_drop(cache.k_q[i], write_slots, kq)
                scatter_drop(cache.k_scale[i], write_slots, ks)
                scatter_drop(cache.v_q[i], write_slots, vq)
                scatter_drop(cache.v_scale[i], write_slots, vs)
                attn = sdpa_quantized(
                    q, cache.k_q[i], cache.k_scale[i], cache.v_q[i],
                    cache.v_scale[i], mask, scale,
                )
            else:
                ck, cv = cache.k[i], cache.v[i]
                if cache.window is None:
                    ck[rows, cols] = k.to(ck.dtype)  # in place
                    cv[rows, cols] = v.to(cv.dtype)
                else:
                    scatter_drop(ck, write_slots, k.to(ck.dtype))
                    scatter_drop(cv, write_slots, v.to(cv.dtype))
                attn = sdpa(q, ck.to(q.dtype), cv.to(q.dtype), mask, scale)
            h = self._mlp_block(p, h, attn.reshape(b, t, hq * dh), i, eps,
                                use_fused_mlp, fused_ln=fused_ln)
        if fused_ln and "lm_head" in params:
            logits = self.unembed(params, h, params["norm"], eps)
        else:
            logits = self.unembed(params, rms_norm(h, params["norm"], eps))
        return logits.to(torch.float32), cache

    # -- paged-pool forwards (continuous-batching path) ----------------------

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
    ):
        """Forward over the global paged KV pool. Decode (T == 1) attends
        through the paged decode-attention kernel (K3 on the card); a
        prefill chunk gathers its pages to dense KV. Returns (logits
        [B, T, V] f32, pool); with_logits=False stops after the last layer
        (a prefill whose logits nobody reads) and returns (None, pool);
        ``last_idx`` unembeds that one row only (logits [B, 1, V])."""
        cfg = self.config
        dh = cfg.resolved_head_dim
        hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        h = self.embed(params, input_ids)
        b, t = h.shape[0], h.shape[1]
        dev = h.device
        decode = t == 1
        p = params["layers"]
        inv_freq = self.inv_freq(dev)
        # decode: rope is the QKV projection's epilogue, ln1 its prologue
        fused_rope = decode and "wqkv" in p and dh in (64, 128)
        rope_cs = None
        if fused_rope:
            rope_cs = rope_qkv_cs(positions[:, 0], inv_freq, hq, hkv, dh)
        else:
            cos, sin = rope_tables(positions, inv_freq)
        scale = dh**-0.5
        eps = cfg.rms_norm_eps
        fused_ln = decode and b * t <= 32
        use_fused_mlp = decode and self._fused_mlp_ok(p, b * t)
        phys, slot = page_slots(block_tables, positions, pool.num_pages)
        if not decode:
            mask = attention_mask(positions,
                                  _paged_kv_positions(block_tables, context_lens))

        for i in range(cfg.num_hidden_layers):
            if fused_ln:
                x, ln_kw = h, dict(ln_w=p["ln1"], ln_eps=eps)
            else:
                x, ln_kw = rms_norm(h, _row(p["ln1"], i), eps), {}
            q, k, v = self._attn_proj(
                p, x, b, t, layer=i, rope_cs=rope_cs,
                rope_dim=dh if fused_rope else 0, **ln_kw,
            )
            if not fused_rope:
                q = apply_rope_tables(q, cos, sin)
                k = apply_rope_tables(k, cos, sin)
            scatter_tokens(pool, i, phys, slot, k, v)
            if decode:
                attn = paged_attention_decode(
                    q[:, 0].contiguous(), pool.k, pool.v, pool.k_scale,
                    pool.v_scale, i, block_tables, context_lens, scale,
                )[:, None]
            else:
                attn = gathered_attention(pool, i, block_tables, q, mask, scale)
            h = self._mlp_block(p, h, attn.reshape(b, t, hq * dh), i, eps,
                                use_fused_mlp)
        if not with_logits:
            return None, pool
        if last_idx is not None:
            h = h.index_select(1, last_idx)
        if fused_ln and "lm_head" in params:
            logits = self.unembed(params, h, params["norm"], eps)
        else:
            logits = self.unembed(params, rms_norm(h, params["norm"], eps))
        return logits.to(torch.float32), pool

    def mixed_forward(
        self,
        params: dict,
        pool,  # PagedKVPool, written in place
        dec_tokens: torch.Tensor,  # [B] int decode-lane tokens
        dec_positions: torch.Tensor,  # [B] write position per lane (-1 frozen)
        dec_ctx: torch.Tensor,  # [B] int32 context len incl. this token (>= 1)
        block_tables: torch.Tensor,  # [B, maxP] int32
        pf_ids: torch.Tensor,  # [Cs] prefill-rider tokens (-1 pad)
        pf_positions: torch.Tensor,  # [Cs] their positions (-1 pad)
        pf_lane: torch.Tensor,  # [1] int: the rider's lane
        pf_ctx: torch.Tensor,  # [1] int32: rider-lane tokens
        #          in the pool AFTER this slice
        pf_any: bool = True,  # the rider carries a token
    ):
        """One mixed continuous-batching step: every decode lane advances one
        token AND a chunk of prefill tokens rides along, sharing one pass
        over the weights (flat token axis M = B + Cs). Lanes attend through
        the paged decode-attention kernel, the rider by masked dense
        attention over its lane's gathered pages. The rider's lane and
        context are device tensors, so a captured step reads them anew at
        every replay; its emptiness is a host value from the scheduler's
        plan (JAX's ``lax.cond`` on the device becomes a branch on the
        host, as ``use_rider`` picks one of two programs), so nothing is
        read back. Returns (decode logits [B, V] f32, pool)."""
        cfg = self.config
        dh = cfg.resolved_head_dim
        hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        b = dec_tokens.shape[0]
        cs = pf_ids.shape[0]
        m = b + cs
        dev = dec_tokens.device
        scale = dh**-0.5
        eps = cfg.rms_norm_eps
        p = params["layers"]
        inv_freq = self.inv_freq(dev)

        flat_ids = torch.cat([dec_tokens, pf_ids])  # [M]
        positions = torch.cat([dec_positions, pf_positions])  # [M]
        # rope fused into the QKV projection epilogue at any M (K1 / K2); pad
        # rows rotate by garbage angles, their K is not kept and their
        # attention output is discarded
        fused_rope = "wqkv" in p and dh in (64, 128)
        if fused_rope:
            rope_cs = rope_qkv_cs(positions, inv_freq, hq, hkv, dh)
        else:
            cos, sin = rope_tables(positions[None], inv_freq)
        h = self.embed(params, torch.clamp(flat_ids, min=0)[None])  # [1, M, D]

        pf_table = block_tables[pf_lane.long()]  # [1, maxP]
        dec_phys, dec_slot = page_slots(block_tables, dec_positions[:, None],
                                        pool.num_pages)
        pf_phys, pf_slot = page_slots(pf_table, pf_positions[None],
                                      pool.num_pages)
        phys = torch.cat([dec_phys[:, 0], pf_phys[0]])
        slot = torch.cat([dec_slot[:, 0], pf_slot[0]])
        if pf_any:
            pf_mask = attention_mask(
                pf_positions[None],
                _paged_kv_positions(pf_table, pf_ctx))

        for i in range(cfg.num_hidden_layers):
            x = rms_norm(h, _row(p["ln1"], i), eps)
            q, k, v = self._attn_proj(
                p, x, 1, m, layer=i, rope_cs=rope_cs if fused_rope else None,
                rope_dim=dh if fused_rope else 0,
            )  # [1, M, H, dh]
            if not fused_rope:
                q = apply_rope_tables(q, cos, sin)
                k = apply_rope_tables(k, cos, sin)
            scatter_tokens(pool, i, phys, slot, k[0], v[0])
            attn_dec = paged_attention_decode(
                q[0, :b].contiguous(), pool.k, pool.v, pool.k_scale,
                pool.v_scale, i, block_tables, dec_ctx, scale,
            )
            if pf_any:
                attn_pf = gathered_attention(pool, i, pf_table, q[:, b:],
                                             pf_mask, scale)[0]
            else:
                attn_pf = torch.zeros((cs, hq, dh), dtype=q.dtype, device=dev)
            attn = torch.cat([attn_dec, attn_pf])[None]  # [1, M, Hq, dh]
            h2 = h + linear(attn.reshape(1, m, hq * dh), p["wo"], layer=i)
            x = rms_norm(h2, _row(p["ln2"], i), eps)
            h = h2 + self._mlp(p, x, layer=i)
        h = rms_norm(h[:, :b], params["norm"], eps)  # lanes only
        return self.unembed(params, h)[0].to(torch.float32), pool


def gathered_attention(pool, layer: int, tables: torch.Tensor, q: torch.Tensor,
                       mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Masked dense attention of q [B, T, Hq, dh] over the pages that
    ``tables`` [B, maxP] names, gathered from layer ``layer`` of the pool
    (INT8 pages stay int8; their scales fold into the dots)."""
    k = gather_pages(pool.k, layer, tables)
    v = gather_pages(pool.v, layer, tables)
    if pool.quantized:
        ks = gather_pages(pool.k_scale, layer, tables)[..., None]
        vs = gather_pages(pool.v_scale, layer, tables)[..., None]
        return sdpa_quantized(q, k, ks, v, vs, mask, scale)
    return sdpa(q, k.to(q.dtype), v.to(q.dtype), mask, scale)


def _paged_kv_positions(block_tables: torch.Tensor,
                        context_lens: torch.Tensor) -> torch.Tensor:
    """kv slot positions [B, maxP*PAGE] of gathered paged KV: slot j of
    logical page i holds position i*PAGE + j when < context_len, else -1."""
    b, mp = block_tables.shape
    pos = torch.arange(mp * PAGE_SIZE, device=block_tables.device)[None, :]
    valid = (pos < context_lens[:, None]) & torch.repeat_interleave(
        block_tables >= 0, PAGE_SIZE, dim=1
    )
    return torch.where(valid, pos, torch.full_like(pos, -1))
