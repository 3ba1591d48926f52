"""Perplexity harness: token-level perplexity of a local checkpoint over a
text file (WikiText-2's ``wiki.test.raw``), per weight variant.

    python -m pie_tpu_torch.tools.ppl --model-path /path/to/snapshot \\
        --data /path/to/wiki.test.raw --variants bf16,int8,int4 \\
        --seq-len 2048 [--gate 0.05] [--check-mlx-layout] [--device cuda]

Port of the JAX package's ``scripts/ppl.py``. Perplexity runs over
non-overlapping ``seq_len`` windows (the protocol of MLX-LM's
``mlx_lm.evaluate``), each window one teacher-forced forward. The MLX
interchange check quantizes INT4 through MLX's packing
(``quantize_mlx_layout`` -> ``from_mlx_layout``): the codes are the same
numbers as ``quantize_params``', so the perplexity must match. It runs on
the card by default; ``--device cpu`` when asked. Everything reads local
files (the checkpoint, the text); nothing is downloaded.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys

import numpy as np
import torch

from pie_tpu_torch.cache.kv_cache import make_kv_cache
from pie_tpu_torch.ops.quant import from_mlx_layout, quantize_mlx_layout


@torch.no_grad()
def window_nll(model, params, ids: torch.Tensor, lens: torch.Tensor):
    """Summed next-token negative log-likelihood over a padded window.

    ids [B, T] int; lens [B] valid lengths. Returns (nll_sum, count)
    tensors: the teacher-forced cross-entropy (f32 logits) of positions
    1 .. len - 1."""
    cfg = model.config
    b, t = ids.shape
    dev = ids.device
    cache = make_kv_cache(cfg.num_hidden_layers, b, t, cfg.num_key_value_heads,
                          cfg.resolved_head_dim, dtype=torch.bfloat16, device=dev)
    cache = cache.advance(torch.zeros((b,), dtype=torch.int32, device=dev), t)
    positions = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
    logits, _ = model(params, ids, cache, positions)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 2, ids[:, 1:, None].long())[..., 0]
    mask = torch.arange(1, t, device=dev)[None, :] < lens[:, None]
    return (nll * mask).sum(), mask.sum()


def compute_ppl(model, params, token_ids: np.ndarray, seq_len: int = 2048,
                progress=None) -> float:
    """Perplexity over non-overlapping ``seq_len`` windows of a token
    stream, on the params' device."""
    dev = params["embed"].device
    n = len(token_ids)
    total_nll, total_cnt = 0.0, 0
    for start in range(0, n, seq_len):
        chunk = np.asarray(token_ids[start:start + seq_len], np.int32)
        ln = len(chunk)
        if ln < 2:
            break
        padded = np.zeros((1, seq_len), np.int32)
        padded[0, :ln] = chunk
        nll, cnt = window_nll(model, params, torch.from_numpy(padded).to(dev),
                              torch.tensor([ln], dtype=torch.int32, device=dev))
        total_nll += float(nll)
        total_cnt += int(cnt)
        if progress:
            progress(start + ln, n)
    return float(np.exp(total_nll / max(total_cnt, 1)))


def quantize_variant(model, params, variant: str):
    """Params of a named weight variant: bf16 (as loaded), int8 or int4
    (group 64)."""
    if variant == "bf16":
        return params
    if variant == "int8":
        return model.quantize_params(params, group_size=64, bits=8)
    if variant == "int4":
        return model.quantize_params(params, group_size=64, bits=4)
    raise ValueError(f"unknown variant {variant!r}")


def mlx_roundtrip_params(model, params, group_size: int = 64, bits: int = 4):
    """Quantize every linear weight through MLX's packing and back: each
    [L, K, N] weight quantized as MLX does ([N, K] along K), then read into
    the port's KN layout. The codes, scales and biases are the same numbers
    as ``quantize_params``' (projections unfused: fusing concatenates along
    N, which leaves each column's groups alone)."""

    def q_via_mlx(w_kn):
        packed, scales, biases = quantize_mlx_layout(w_kn.transpose(-1, -2),
                                                     group_size, bits)
        return from_mlx_layout(packed, scales, biases, group_size, bits)

    kw = {}
    if "fuse_projections" in inspect.signature(model.quantize_params).parameters:
        kw["fuse_projections"] = False
    out = dict(model.quantize_params(params, group_size, bits, **kw))
    layers = dict(out["layers"])
    for name in model.LINEAR_KEYS:
        layers[name] = q_via_mlx(params["layers"][name].to(torch.float32))
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = q_via_mlx(params["lm_head"].to(torch.float32))
    return out


def load_wikitext(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--data", required=True, help="wiki.test.raw text file")
    ap.add_argument("--variants", default="bf16,int4")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--max-tokens", type=int, default=0,
                    help="truncate the eval stream (0 = full)")
    ap.add_argument("--gate", type=float, default=0.0,
                    help="fail if PPL(int4) - PPL(bf16) exceeds this")
    ap.add_argument("--check-mlx-layout", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pie_tpu_torch.models.loader import load_model
    from pie_tpu_torch.tokenizer import load_tokenizer

    model, params = load_model(args.model_path, dtype=torch.bfloat16, device=args.device)
    tok = load_tokenizer(args.model_path)
    ids = np.asarray(tok.encode(load_wikitext(args.data), add_bos=True), np.int64)
    if args.max_tokens:
        ids = ids[:args.max_tokens]
    print(f"eval stream: {len(ids)} tokens", file=sys.stderr)

    results = {}
    for variant in args.variants.split(","):
        vp = quantize_variant(model, params, variant)

        def prog(done, total):
            print(f"  {variant}: {done}/{total}", end="\r", file=sys.stderr)

        ppl = compute_ppl(model, vp, ids, args.seq_len, progress=prog)
        results[variant] = round(ppl, 4)
        print(f"\n{variant}: ppl={ppl:.4f}", file=sys.stderr)
        del vp

    if args.check_mlx_layout:
        ppl = compute_ppl(model, mlx_roundtrip_params(model, params), ids, args.seq_len)
        results["int4_mlx_layout"] = round(ppl, 4)
        print(f"int4 via MLX layout: ppl={ppl:.4f}", file=sys.stderr)

    print(json.dumps(results))
    if args.gate and "int4" in results and "bf16" in results:
        delta = results["int4"] - results["bf16"]
        print(f"gate: delta={delta:.4f} (<= {args.gate})", file=sys.stderr)
        if delta > args.gate:
            sys.exit(1)


if __name__ == "__main__":
    main()
