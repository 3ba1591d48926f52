"""GGUF weight loading (pure numpy reader).

The port's own copy of the JAX package's ``pie_tpu/models/gguf.py``: GGUF
v2/v3 header and metadata parsing, the tensor table, dequantization of the
common GGML quant types (Q8_0, Q4_0, Q4_1) to float32, and the
llama-architecture name/config mapping, so a .gguf checkpoint loads through
the same ``from_hf_state_dict`` path as safetensors. Only
``load_gguf_model`` differs: torch dtypes and a device.
"""

from __future__ import annotations

import logging
import struct
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

logger = logging.getLogger(__name__)

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = range(8, 13)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
    _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor dtypes we support
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q4_1 = 3
GGML_Q8_0 = 8
GGML_I8 = 24
GGML_I16 = 25
GGML_I32 = 26
GGML_I64 = 27
GGML_F64 = 28
GGML_BF16 = 30

_PLAIN_DTYPES = {
    GGML_F32: np.dtype("<f4"),
    GGML_F16: np.dtype("<f2"),
    GGML_I8: np.dtype("<i1"),
    GGML_I16: np.dtype("<i2"),
    GGML_I32: np.dtype("<i4"),
    GGML_I64: np.dtype("<i8"),
    GGML_F64: np.dtype("<f8"),
}

# (block_bytes, elements_per_block)
_QUANT_BLOCKS = {
    GGML_Q4_0: (18, 32),   # f16 scale + 16 nibble bytes
    GGML_Q4_1: (20, 32),   # f16 scale + f16 min + 16 nibble bytes
    GGML_Q8_0: (34, 32),   # f16 scale + 32 int8
}


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        fmt = _SCALAR_FMT[vtype]
        return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
    if vtype == _T_BOOL:
        return bool(f.read(1)[0])
    if vtype == _T_STRING:
        return _read_string(f)
    if vtype == _T_ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(count)]
    raise ValueError(f"unknown gguf metadata type {vtype}")


def _dequant_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 34)
    scale = blocks[:, :2].copy().view("<f2").astype(np.float32)  # [B,1]
    q = blocks[:, 2:].view(np.int8).astype(np.float32)  # [B,32]
    return (q * scale).reshape(-1)[:n]


def _unpack_nibbles(b: np.ndarray) -> np.ndarray:
    """[B,16] uint8 -> [B,32] int: low nibbles then high nibbles (ggml
    layout: element i in [0,16) is low nibble of byte i, element i+16 the
    high nibble)."""
    lo = (b & 0x0F).astype(np.int32)
    hi = (b >> 4).astype(np.int32)
    return np.concatenate([lo, hi], axis=1)


def _dequant_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 18)
    scale = blocks[:, :2].copy().view("<f2").astype(np.float32)
    q = _unpack_nibbles(blocks[:, 2:])
    return ((q - 8).astype(np.float32) * scale).reshape(-1)[:n]


def _dequant_q4_1(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 20)
    scale = blocks[:, :2].copy().view("<f2").astype(np.float32)
    minv = blocks[:, 2:4].copy().view("<f2").astype(np.float32)
    q = _unpack_nibbles(blocks[:, 4:])
    return (q.astype(np.float32) * scale + minv).reshape(-1)[:n]


_DEQUANT = {
    GGML_Q4_0: _dequant_q4_0,
    GGML_Q4_1: _dequant_q4_1,
    GGML_Q8_0: _dequant_q8_0,
}


def read_gguf(path: str | Path) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
    """Parse a .gguf file -> (metadata, {tensor_name: array}).

    Quantized tensors (Q4_0/Q4_1/Q8_0) are dequantized to float32; F16/BF16
    stay in their storage dtype.
    """
    path = Path(path)
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path} is not a GGUF file")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))

        metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_string(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            metadata[key] = _read_value(f, vtype)

        infos = []
        for _ in range(n_tensors):
            name = _read_string(f)
            (n_dims,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
            gtype, offset = struct.unpack("<IQ", f.read(12))
            # ggml dims are fastest-varying first; numpy wants the reverse
            shape = tuple(reversed(dims))
            infos.append((name, shape, gtype, offset))

        align = int(metadata.get("general.alignment", 32))
        data_start = f.tell()
        data_start = (data_start + align - 1) // align * align

        tensors: dict[str, np.ndarray] = {}
        for name, shape, gtype, offset in infos:
            n = int(np.prod(shape)) if shape else 1
            f.seek(data_start + offset)
            if gtype in _PLAIN_DTYPES:
                dt = _PLAIN_DTYPES[gtype]
                arr = np.frombuffer(f.read(n * dt.itemsize), dtype=dt)
            elif gtype == GGML_BF16:
                raw = np.frombuffer(f.read(n * 2), dtype="<u2")
                arr = (raw.astype(np.uint32) << 16).view(np.float32)
            elif gtype in _QUANT_BLOCKS:
                block_bytes, per_block = _QUANT_BLOCKS[gtype]
                n_blocks = (n + per_block - 1) // per_block
                raw = np.frombuffer(
                    f.read(n_blocks * block_bytes), dtype=np.uint8
                )
                arr = _DEQUANT[gtype](raw, n)
            else:
                raise ValueError(
                    f"unsupported ggml tensor type {gtype} for {name!r}"
                )
            tensors[name] = arr.reshape(shape)
        return metadata, tensors


# ---- llama-architecture mapping ------------------------------------------

_LLAMA_TENSOR_MAP = {
    "token_embd.weight": "model.embed_tokens.weight",
    "output_norm.weight": "model.norm.weight",
    "output.weight": "lm_head.weight",
}

_LLAMA_BLOCK_MAP = {
    "attn_q.weight": "self_attn.q_proj.weight",
    "attn_k.weight": "self_attn.k_proj.weight",
    "attn_v.weight": "self_attn.v_proj.weight",
    "attn_output.weight": "self_attn.o_proj.weight",
    "attn_q.bias": "self_attn.q_proj.bias",
    "attn_k.bias": "self_attn.k_proj.bias",
    "attn_v.bias": "self_attn.v_proj.bias",
    "ffn_gate.weight": "mlp.gate_proj.weight",
    "ffn_up.weight": "mlp.up_proj.weight",
    "ffn_down.weight": "mlp.down_proj.weight",
    "attn_norm.weight": "input_layernorm.weight",
    "ffn_norm.weight": "post_attention_layernorm.weight",
}


def gguf_to_hf_llama(
    metadata: dict[str, Any], tensors: dict[str, np.ndarray]
) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
    """Map GGML llama-architecture names/metadata to the HF layout consumed
    by ``LlamaModel.from_hf_state_dict``."""
    arch = metadata.get("general.architecture", "llama")

    def meta(key, default=None):
        return metadata.get(f"{arch}.{key}", default)

    n_heads = int(meta("attention.head_count", 32))
    cfg = {
        "model_type": "llama",
        "hidden_size": int(meta("embedding_length", 4096)),
        "intermediate_size": int(meta("feed_forward_length", 11008)),
        "num_hidden_layers": int(meta("block_count", 32)),
        "num_attention_heads": n_heads,
        "num_key_value_heads": int(meta("attention.head_count_kv", n_heads)),
        "rms_norm_eps": float(
            meta("attention.layer_norm_rms_epsilon", 1e-5)
        ),
        "rope_theta": float(meta("rope.freq_base", 10000.0)),
        "max_position_embeddings": int(meta("context_length", 4096)),
        "vocab_size": int(metadata.get("llama.vocab_size", 0)) or None,
    }

    sd: dict[str, np.ndarray] = {}
    for name, arr in tensors.items():
        if name in _LLAMA_TENSOR_MAP:
            sd[_LLAMA_TENSOR_MAP[name]] = arr
            continue
        if name.startswith("blk."):
            _, idx, rest = name.split(".", 2)
            mapped = _LLAMA_BLOCK_MAP.get(rest)
            if mapped is None:
                logger.warning("skipping unmapped gguf tensor %s", name)
                continue
            sd[f"model.layers.{idx}.{mapped}"] = arr
            continue
        logger.warning("skipping unmapped gguf tensor %s", name)

    if cfg["vocab_size"] is None:
        emb = sd.get("model.embed_tokens.weight")
        cfg["vocab_size"] = int(emb.shape[0]) if emb is not None else 32000
    # gguf has no explicit tie flag: tied iff the output head is absent
    cfg["tie_word_embeddings"] = "lm_head.weight" not in sd
    return cfg, sd


def load_gguf_model(path: str | Path, dtype=None, device="cuda"):
    """Load (model, params on ``device``) from a llama-architecture .gguf
    file."""
    import torch

    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from pie_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    metadata, tensors = read_gguf(path)
    arch = metadata.get("general.architecture", "llama")
    if arch not in ("llama", "mistral"):
        raise ValueError(f"gguf architecture {arch!r} not supported")
    cfg_dict, sd = gguf_to_hf_llama(metadata, tensors)
    model = LlamaModel(LlamaConfig.from_dict(cfg_dict))
    params = model.from_hf_state_dict(sd, dtype=dtype or torch.bfloat16)
    if dev.type != "cpu":
        params = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                      else v.to(dev)) for k, v in params.items()}
    return model, params
