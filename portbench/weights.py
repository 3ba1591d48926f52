"""Seeded bf16 weights in the Hugging Face layout, made on the device.

The benchmark's one source of weights: the program under test receives the
whole state dict (``state_dict``) and quantizes it on load as a server does;
the plain reference regenerates the same tensors layer by layer
(``layer_weights``, ``top_weights``) after the program is gone, so neither
side takes anything the other made.

Each layer is one ``torch.randn`` call of all its matrices from a generator
seeded by (seed, layer), cut into views and scaled: linear weights
N(0, 1 / fan_in), so every projection keeps its input's scale; attention
biases N(0, 0.5) where the config has them; norm weights 1 + N(0, 0.1).
The embedding is N(0, 1) and the untied head N(0, 1 / hidden).
"""

from __future__ import annotations

import hashlib

import torch

DTYPE = torch.bfloat16
BIAS_STD = 0.5
NORM_STD = 0.1


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for one part of the weights."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def shapes(cfg: dict) -> dict:
    """HF names -> shapes [out, in] of one decoder layer's tensors."""
    d, di = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // hq
    out = {
        "self_attn.q_proj.weight": (hq * dh, d),
        "self_attn.k_proj.weight": (hkv * dh, d),
        "self_attn.v_proj.weight": (hkv * dh, d),
        "self_attn.o_proj.weight": (d, hq * dh),
        "mlp.gate_proj.weight": (di, d),
        "mlp.up_proj.weight": (di, d),
        "mlp.down_proj.weight": (d, di),
    }
    if has_qkv_bias(cfg):
        out.update({
            "self_attn.q_proj.bias": (hq * dh,),
            "self_attn.k_proj.bias": (hkv * dh,),
            "self_attn.v_proj.bias": (hkv * dh,),
        })
    out["input_layernorm.weight"] = (d,)
    out["post_attention_layernorm.weight"] = (d,)
    return out


def has_qkv_bias(cfg: dict) -> bool:
    """Qwen2 decoders carry q / k / v biases; Llama and Mistral do not."""
    return cfg["model_type"].startswith("qwen2") or bool(cfg.get("attention_bias"))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def layer_weights(cfg: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s tensors, HF names without the layer prefix, bf16."""
    sh = shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, f"layer{layer}"))
    flat = torch.randn((sum(_numel(s) for s in sh.values()),), generator=gen,
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in sh.items():
        n = _numel(shape)
        part = flat[at:at + n].view(shape)
        at += n
        if name.endswith("layernorm.weight"):
            t = 1.0 + NORM_STD * part
        elif name.endswith(".bias"):
            t = BIAS_STD * part
        else:
            t = part * shape[1] ** -0.5
        out[name] = t.to(DTYPE)
    return out


def top_weights(cfg: dict, seed: int, device, head: bool = True) -> dict:
    """The embedding, the final norm and (untied, ``head``) the head."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "top"))
    out = {"model.embed_tokens.weight": torch.randn(
        (v, d), generator=gen, device=device, dtype=torch.float32).to(DTYPE)}
    out["model.norm.weight"] = (1.0 + NORM_STD * torch.randn(
        (d,), generator=gen, device=device, dtype=torch.float32)).to(DTYPE)
    if head and not cfg.get("tie_word_embeddings", False):
        gen_h = torch.Generator(device=device).manual_seed(sub_seed(seed, "head"))
        out["lm_head.weight"] = (torch.randn(
            (v, d), generator=gen_h, device=device, dtype=torch.float32)
            * d ** -0.5).to(DTYPE)
    return out


def state_dict(cfg: dict, seed: int, device) -> dict:
    """The whole model's state dict, as a checkpoint would hold it."""
    sd = top_weights(cfg, seed, device)
    for i in range(cfg["num_hidden_layers"]):
        for name, t in layer_weights(cfg, seed, i, device).items():
            sd[f"model.layers.{i}.{name}"] = t
    return sd
