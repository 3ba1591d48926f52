"""The yardstick: the device's peaks, and the bytes and operations that the
served work needs, counted from the configuration's shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W): 3.35 TB/s
of HBM and 989 TFLOP/s in bf16. A kernel's roofline share is the least time
its work could take on them (the larger of bytes over the bandwidth and
operations over the compute peak, per call) over its measured time.

What is counted is what the inputs need, whatever the program does: every
input byte read once and every output byte written once, the weights as
the configuration stores them (INT4 codes with one bf16 scale and one bf16
minimum per 64 rows of a column; K unpadded), KV as INT8 with one f32 scale
per (token, head), activations bf16; operations are 2 per multiply-add of
real rows (padding rows and frozen lanes of a padded batch count as bytes
read only where they are inputs).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

ACT_BYTES = 2  # bf16 activations
KV_BYTES = 1  # INT8 KV codes
KV_SCALE_BYTES = 4  # f32 per (token, head)


def geometry(cfg: dict) -> dict:
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(d=d, di=cfg["intermediate_size"], hq=hq,
                hkv=cfg["num_key_value_heads"], dh=cfg.get("head_dim") or d // hq,
                layers=cfg["num_hidden_layers"], vocab=cfg["vocab_size"])


def projections(cfg: dict) -> list:
    """(K, N) of one layer's quantized projections: q, k, v, o, gate, up,
    down (fusing q / k / v or gate / up changes no byte and no operation)."""
    g = geometry(cfg)
    d, di, q, kv = g["d"], g["di"], g["hq"] * g["dh"], g["hkv"] * g["dh"]
    return [(d, q), (d, kv), (d, kv), (q, d), (d, di), (d, di), (di, d)]


def head_shape(cfg: dict) -> tuple:
    g = geometry(cfg)
    return (g["d"], g["vocab"])


def quant_bytes(k: int, n: int, group: int = 64, bits: int = 4) -> float:
    """Stored bytes of a [K, N] group-quantized weight: codes, bf16 scale and
    bf16 minimum per (group, column)."""
    return k * n * bits / 8 + 2 * 2 * (k // group) * n


def layer_params(cfg: dict) -> int:
    """Multiply-adds per token of all layers' projections."""
    return cfg["num_hidden_layers"] * sum(k * n for k, n in projections(cfg))


def gemm_work(shapes: list, rows: int) -> tuple:
    """(bytes, operations) of products of ``rows`` rows through quantized
    weights ``shapes``: each weight read once, x read and y written once."""
    byts = sum(quant_bytes(k, n) + rows * (k + n) * ACT_BYTES for k, n in shapes)
    ops = sum(2 * rows * k * n for k, n in shapes)
    return byts, ops


def layers_shapes(cfg: dict) -> list:
    return projections(cfg) * cfg["num_hidden_layers"]


def bound_s(byts: float, ops: float) -> float:
    """The least time one call could take on the data sheet's peaks."""
    return max(byts / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S)


def decode_pass(cfg: dict, rows: int) -> tuple:
    """(bytes, ops) of one decode step's projections and head at ``rows``
    rows (every lane of the batch is an input row)."""
    return gemm_work(layers_shapes(cfg) + [head_shape(cfg)], rows)


def prefill_pass(cfg: dict, tokens: int) -> tuple:
    """(bytes, ops) of one prefill chunk's projections over ``tokens`` real
    tokens (a prefill chunk unembeds nothing)."""
    return gemm_work(layers_shapes(cfg), tokens)


def attention_step(cfg: dict, ctxs: list) -> tuple:
    """(bytes, ops) of one decode step's attention over every layer, lanes
    with contexts ``ctxs`` (tokens in the pool including the new one): each
    context's INT8 K and V and their scales read once, q read and the output
    written once."""
    g = geometry(cfg)
    c = sum(ctxs)
    per_layer = (c * g["hkv"] * (2 * g["dh"] * KV_BYTES + 2 * KV_SCALE_BYTES)
                 + len(ctxs) * g["hq"] * g["dh"] * 2 * ACT_BYTES)
    return g["layers"] * per_layer, g["layers"] * 4 * c * g["hq"] * g["dh"]


def decode_token_flops(cfg: dict, ctx: int) -> float:
    """Model FLOPs of one decoded token at context ``ctx``: projections,
    head, and attention over ``ctx`` keys in every layer."""
    g = geometry(cfg)
    proj = 2 * (layer_params(cfg) + g["d"] * g["vocab"])
    return proj + g["layers"] * 4 * ctx * g["hq"] * g["dh"]


def prefill_flops(cfg: dict, positions: list) -> float:
    """Model FLOPs of a prefill chunk of tokens at ``positions`` (causal: a
    token at p attends p + 1 keys); no head."""
    g = geometry(cfg)
    attn = g["layers"] * 4 * g["hq"] * g["dh"] * sum(p + 1 for p in positions)
    return 2 * layer_params(cfg) * len(positions) + attn

