"""K5 (the paged prefill attention) timed at the served cells' chunk shapes
on one CUDA card, beside its bound, the plain version and a library call.

    python -m pie_tpu_torch.tools.k5_bench [--cases NAME ...] [--out FILE]

Cases: a 256-token chunk at the Qwen2.5-VL-7B heads (28 / 4, 28 layers, a
66-page table) at positions 0-255, 1,792-2,047 and 3,840-4,095, and at the
Mistral-7B heads (32 / 8, 32 layers, a 20-page table) at positions 0-255.
Each line gives device ms per chunk (every layer's call, captured in a
CUDA graph and replayed) of:

- ``k5``: K5 as the model calls it (``prefill_attention_cuda``);
- ``plain``: the plain version (``gathered_attention`` over the whole
  table under the chunk's mask, made once a chunk as the models do);
- ``library``: ``scaled_dot_product_attention(..., enable_gqa=True)`` on
  the visible context's K/V gathered and dequantized to bf16 beforehand,
  under the chunk's boolean mask (a yardstick the port never calls);

and the bound: the chunk's bytes (each visible key's INT8 K and V and
their f32 scales once a layer, q read and the output written in bf16)
over the data sheet's 3.35 TB/s and over the read rate B7 measures at the
start of the run, and its operations (4 x Hq x 128 x sum(position + 1) a
layer: the causal work) over 989 TFLOP/s, with K5's share of the larger.
Every line carries the card's name and power limit, and K5's registers,
spills and shared memory.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from pie_tpu_torch.cache.paged import PAGE_SIZE, PagedKVPool
from pie_tpu_torch.models.llama import _paged_kv_positions, gathered_attention
from pie_tpu_torch.ops import prefill_attention as k5
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.ops.attention import attention_mask
from pie_tpu_torch.tools import hbm_peak
from pie_tpu_torch.tools.hbm_peak import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from pie_tpu_torch.tools.prefill_ab import device_ms

D = 128
# name: (Hq, Hkv, layers, table pages, first position, tokens)
CASES = {
    "qwen 256 at 0": (28, 4, 28, 66, 0, 256),
    "qwen 256 at 1792": (28, 4, 28, 66, 1792, 256),
    "qwen 256 at 3840": (28, 4, 28, 66, 3840, 256),
    "mistral 256 at 0": (32, 8, 32, 20, 0, 256),
}


def work(hq: int, hkv: int, layers: int, first: int, tokens: int) -> tuple:
    """(bytes, operations) of one chunk's attention over every layer, as
    the benchmark counts them (``portbench/counts.py``): INT8 K and V with
    an f32 scale per (token, head) for each visible key, bf16 q and output,
    2 operations a multiply-add of real rows."""
    ctx = first + tokens
    per_layer = ctx * hkv * (2 * D + 2 * 4) + 2 * tokens * hq * D * 2
    ops = 4 * hq * D * sum(p + 1 for p in range(first, ctx))
    return layers * per_layer, layers * ops


def inputs(dev, hq, hkv, layers, maxp, first, tokens, seed=0):
    """A pool of random INT8 codes and scales with the lane's visible pages
    at shuffled places, q, the table, positions and context length."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ctx = first + tokens
    pool = PagedKVPool.create(layers, maxp + 2, hkv, D, quantized=True, device=dev)
    for codes in (pool.k, pool.v):
        codes.copy_(torch.randint(-127, 128, codes.shape, generator=g, device=dev,
                                  dtype=torch.int8))
    for s in (pool.k_scale, pool.v_scale):
        s.copy_(0.01 + 0.02 * torch.rand(s.shape, generator=g, device=dev))
    live = -(-ctx // PAGE_SIZE)
    table = torch.full((1, maxp), -1, dtype=torch.int32, device=dev)
    table[0, :live] = torch.randperm(maxp + 2, generator=g, device=dev)[:live].int()
    pos = torch.arange(first, ctx, dtype=torch.int32, device=dev)[None]
    q = (3 * torch.randn((1, tokens, hq, D), generator=g, device=dev)).bfloat16()
    return q, pool, table, pos, torch.tensor([ctx], dtype=torch.int32, device=dev)


def dequantized(pool, layer, table, ctx):
    """The visible context's K and V of one layer, dequantized to bf16
    [1, Hkv, ctx, D]."""
    pages = table[0].clamp(min=0).long()
    out = []
    for codes, s in ((pool.k, pool.k_scale), (pool.v, pool.v_scale)):
        x = codes[layer][pages].float() * s[layer][pages][..., None]  # [P, Hkv, 64, D]
        x = x.transpose(0, 1).reshape(1, x.shape[1], -1, D)[:, :, :ctx]
        out.append(x.bfloat16().contiguous())
    return out


def run_case(name: str, card: str, probe: float) -> dict:
    hq, hkv, layers, maxp, first, tokens = CASES[name]
    dev = torch.device("cuda", torch.cuda.current_device())
    q, pool, table, pos, ctx = inputs(dev, hq, hkv, layers, maxp, first, tokens)
    scale = D ** -0.5
    nbytes, ops = work(hq, hkv, layers, first, tokens)
    row = dict(case=name, card=card, bytes=nbytes, ops=ops,
               bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               probe_bytes_bound_ms=nbytes / probe * 1e3,
               ops_bound_ms=ops / BF16_FLOP_PER_S * 1e3,
               plan=k5.launch_plan(1, tokens, hq, hkv, maxp), geometry=k5.k5_geometry(dev))
    bound = max(row["bytes_bound_ms"], row["ops_bound_ms"])
    row["bound"] = "ops" if row["ops_bound_ms"] >= row["bytes_bound_ms"] else "bytes"

    qmc.reset_counts()
    row["k5_ms"] = layers * device_ms(
        lambda i: k5.prefill_attention_cuda(q, pool, i % layers, table, pos, ctx, scale),
        iters=layers)
    row["k5_share_of_bound_pct"] = 100 * bound / row["k5_ms"]
    mask = attention_mask(pos, _paged_kv_positions(table, ctx))
    row["plain_ms"] = layers * device_ms(
        lambda i: gathered_attention(pool, i % layers, table, q, mask, scale), iters=layers,
        reps=1)
    c = first + tokens
    kv = [dequantized(pool, i, table, c) for i in range(layers)]
    qt = q.transpose(1, 2)
    smask = mask[:, None, :, :c]
    row["library_ms"] = layers * device_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            qt, *kv[i % layers], attn_mask=smask, scale=scale, enable_gqa=True),
        iters=layers)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="*", default=list(CASES), choices=list(CASES))
    ap.add_argument("--out", default=None, help="also append each line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_bench: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    qmc.build()
    probe = hbm_peak.measure(hbm_peak.make_buffer(2))["probe_bytes_per_s"]
    torch.cuda.empty_cache()
    lines = [dict(card=card, probe_bytes_per_s=probe)]
    print(json.dumps(lines[0]), flush=True)
    for name in args.cases:
        lines.append(run_case(name, card, probe))
        print(json.dumps(lines[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
