"""A/B of K2 (the prefill dequant-GEMM), time to first token and the
constrained choice point between checkouts of this repository, on one CUDA
card.

    python3 pie_tpu_torch/tools/prefill_ab.py --root A --root B --root B --root A \
        [--parts k2 ttft choice gemma]

Each ``--root`` is a checkout whose ``pie_tpu_torch`` is imported, in a
fresh process per root and in the order given (parent, change, change,
parent takes the card's drift out of the comparison). For each root:

- K2's device time (a captured CUDA graph over 8 rotating weight copies)
  at every projection of a 512-token prefill of Llama-3-8B (32 layers and
  the head: 129 launches) and of Llama-3.2-1B (16 layers and the tied head
  with f32 scales: 65 launches), summed per prefill, and at the other K2
  cases ``chip_smoke.py`` times: the 8B wqkv and wo at M = 33, 64, 128,
  129 and 2048, wo INT8 g64 and INT4 g32 / g128 at M = 512, the wqkv with
  the rope epilogue at M = 40 and 256 (8B, dh 128) and M = 40 (1B, dh 64);
- ``ttft``: TTFT p50 of five distinct 512-token prompts through
  ``InferenceEngine`` on the full 8B and 1B geometries with random INT4
  g64 weights from a seed (the 1B tied head quantized from the f32
  embedding, as the loader does), and K2's launches in one such prefill;
- ``choice``: on the same 8B engine, host wall ms (median of 5, each
  ending in the sampled token's read back) of one masked prefill at the
  constrained extends' buckets 8, 64 and 256, as ``generate_constrained``
  runs one per choice point;
- ``gemma``: TTFT p50 of five distinct 512-token prompts and of three
  2,048-token prompts (two prefill chunks) through ``InferenceEngine`` on
  the 34-layer Gemma-3 4B geometry with random INT4 g64 weights, and its
  decode tok/s (128 greedy tokens after a 64-token prompt, best of 3).

Every part runs by default. Prints one JSON line per root with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROTATE = 8
PARTS = ("k2", "ttft", "choice", "gemma")
# name, K, N, launches per 512-token prefill, f32 scales
PREFILL_8B = [("wqkv", 4096, 6144, 32, False), ("wo", 4096, 4096, 32, False),
              ("wgu", 4096, 28672, 32, False), ("wd", 14336, 4096, 32, False),
              ("lm_head", 4096, 128256, 1, False)]
PREFILL_1B = [("wqkv", 2048, 3072, 16, False), ("wo", 2048, 2048, 16, False),
              ("wgu", 2048, 16384, 16, False), ("wd", 8192, 2048, 16, False),
              ("lm_head", 2048, 128256, 1, True)]
# name, K, N, M, bits, g, rope heads (Hq, Hkv, dh) or None
OTHER_CASES = [(f"8B {name} M={m}", 4096, n, m, 4, 64, None)
               for m in (33, 64, 128, 129, 2048)
               for name, n in (("wqkv", 6144), ("wo", 4096))] + [
    ("8B wo M=512 int8 g64", 4096, 4096, 512, 8, 64, None),
    ("8B wo M=512 int4 g32", 4096, 4096, 512, 4, 32, None),
    ("8B wo M=512 int4 g128", 4096, 4096, 512, 4, 128, None),
    ("8B wqkv M=40 rope", 4096, 6144, 40, 4, 64, (32, 8, 128)),
    ("8B wqkv M=256 rope", 4096, 6144, 256, 4, 64, (32, 8, 128)),
    ("1B wqkv M=40 rope", 2048, 3072, 40, 4, 64, (32, 8, 64)),
]


def random_weights(k: int, n: int, gen, f32: bool = False, bits: int = 4,
                   g: int = 64):
    """ROTATE stacked copies of random group-affine weights [K, N] on the
    card (bf16 scales, or f32 ones as a tied head quantized from f32)."""
    import torch

    from pie_tpu_torch.ops.quant import QuantizedTensor

    packed = torch.randint(-(2**31), 2**31, (ROTATE, k * bits // 32, n), generator=gen,
                           dtype=torch.int32, device="cuda")
    s = (torch.rand((ROTATE, k // g, n), generator=gen, device="cuda") + 0.5) * 0.02 / k**0.5
    dt = torch.float32 if f32 else torch.bfloat16
    return QuantizedTensor(packed=packed, scales=s.to(dt),
                           biases=(-(2**bits - 1) / 2 * s).to(dt), bits=bits,
                           group_size=g, shape=(k, n))


def device_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Mean device ms per call of fn(i), from ``iters`` calls captured in a
    CUDA graph and replayed ``reps`` times (no host cost per call)."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def measure(root: str, parts=PARTS) -> dict:
    """The parts asked for, for one checkout, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    if not qmc.__file__.startswith(root):
        raise RuntimeError(f"imported {qmc.__file__}, not the checkout at {root}")
    qmc.build()
    gen = torch.Generator(device="cuda").manual_seed(0)

    out = {"root": root}
    if "k2" in parts:
        measure_k2(out, gen)
    if {"ttft", "choice"} & set(parts):
        measure_llama(out, parts)
    if "gemma" in parts:
        measure_gemma(out)
    return out


def measure_k2(out: dict, gen) -> None:
    import torch

    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.ops.rope import make_inv_freq, rope_qkv_cs

    for label, shapes in (("8B", PREFILL_8B), ("1B", PREFILL_1B)):
        total = 0.0
        for name, k, n, per, f32 in shapes:
            qt = random_weights(k, n, gen, f32)
            x = torch.randn((512, k), generator=gen, device="cuda").bfloat16()
            ms = device_ms(lambda i: qmc.quant_matmul_cuda(x, qt, layer=i % ROTATE))
            out[f"k2 {label} {name} M=512 us"] = ms * 1e3
            total += per * ms
            del qt, x
        out[f"k2 per {label} prefill ms"] = total
        torch.cuda.empty_cache()
    for name, k, n, m, bits, g, heads in OTHER_CASES:
        qt = random_weights(k, n, gen, bits=bits, g=g)
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        kw = {}
        if heads:
            hq, hkv, dh = heads
            inv = torch.from_numpy(make_inv_freq(dh, 500000.0)).cuda()
            pos = torch.arange(m, dtype=torch.int32, device="cuda") + 100
            kw = dict(rope_cs=rope_qkv_cs(pos, inv, hq, hkv, dh), rope_dim=dh)
        out[f"k2 {name} us"] = 1e3 * device_ms(
            lambda i: qmc.quant_matmul_cuda(x, qt, layer=i % ROTATE, **kw))
        del qt, x
    torch.cuda.empty_cache()


def prompt(salt, n=512):
    return [1 + (i * 37 + salt * 101) % 100000 for i in range(n)]


def ttft_ms(engine, prompts) -> list:
    """Host ms from each request to its first streamed token."""
    out = []
    for p in prompts:
        stream = engine.generate_stream(p, max_completion_tokens=2, temperature=0.0)
        t0 = time.perf_counter()
        next(stream)
        out.append((time.perf_counter() - t0) * 1e3)
        for _ in stream:
            pass
    return out


def choice_point_ms(engine, bucket: int) -> float:
    """Median host ms of one masked prefill of ``bucket`` tokens from
    position 64, the sampled token read back (device tensors in, which
    every checkout's ``EngineCore._prefill`` takes)."""
    import torch

    dev = engine.device
    v = engine.model.config.vocab_size
    ids = torch.randint(1, 100, (1, bucket), dtype=torch.int32, device=dev)
    one = lambda n: torch.full((1,), n, dtype=torch.int32, device=dev)  # noqa: E731
    mask = torch.zeros((1, v), dtype=torch.bool, device=dev)
    mask[0, :v // 2] = True
    args = (engine._sampling({"temperature": 0.0}), engine._penalties({}),
            *engine._empty_bias)

    def call():
        return engine.core._prefill(engine.params, engine.state, ids, one(bucket),
                                    one(64), *args, allowed_mask=mask,
                                    sampler_kind="greedy")[1].cpu()

    call()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[2]


def measure_llama(out: dict, parts) -> None:
    import torch

    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    for label, cfg, make in (
        ("8B", LlamaConfig(model_type="llama", hidden_size=4096, intermediate_size=14336,
                           num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                           head_dim=128, vocab_size=128256, rope_theta=500000.0,
                           tie_word_embeddings=False),
         lambda m: m.init_quantized_params(seed=0, group_size=64, bits=4)),
        ("1B", LlamaConfig(model_type="llama", hidden_size=2048, intermediate_size=8192,
                           num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
                           head_dim=64, vocab_size=128256, rope_theta=500000.0,
                           tie_word_embeddings=True),
         lambda m: m.quantize_params(m.init_params(seed=3, device="cuda"), 64, 4)),
    ):
        if label == "1B" and "ttft" not in parts:
            continue
        model = LlamaModel(cfg)
        engine = InferenceEngine(model=model, params=make(model), max_seq_len=1024,
                                 decode_chunk=128, prompt_cache=False)
        if "ttft" in parts:
            engine.generate(prompt(99), max_completion_tokens=1, temperature=0.0)
            qmc.reset_counts()
            engine.generate(prompt(98), max_completion_tokens=1, temperature=0.0)
            torch.cuda.synchronize()
            out[f"k2 launches per {label} prefill"] = qmc.launch_counts["K2"]
            ttfts = ttft_ms(engine, [prompt(salt) for salt in range(5)])
            out[f"ttft {label} p50 ms"] = sorted(ttfts)[2]
            out[f"ttft {label} ms"] = ttfts
        if label == "8B" and "choice" in parts:
            for bucket in (8, 64, 256):
                out[f"choice point 8B bucket {bucket} ms"] = choice_point_ms(engine, bucket)
        del engine, model
        torch.cuda.empty_cache()


def measure_gemma(out: dict) -> None:
    import torch

    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model

    # google/gemma-3-4b-it text_config, as chip_smoke.py's G4
    model = Gemma3Model(Gemma3Config(
        model_type="gemma3_text", hidden_size=2560, intermediate_size=10240, num_hidden_layers=34,
        num_attention_heads=8, num_key_value_heads=4, head_dim=256,
        sliding_window=1024, sliding_window_pattern=6, rope_theta=1000000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        rope_local_base_freq=10000.0, query_pre_attn_scalar=256, vocab_size=262208,
        rms_norm_eps=1e-6))
    engine = InferenceEngine(model=model, params=model.init_quantized_params(seed=0),
                             max_seq_len=4096, decode_chunk=128, prompt_cache=False)
    for n, salts in ((512, range(5)), (2048, range(3))):
        ttft_ms(engine, [prompt(90, n)])  # the buckets' first use
        ttfts = ttft_ms(engine, [prompt(s, n) for s in salts])
        out[f"ttft gemma3-4b {n} p50 ms"] = sorted(ttfts)[len(ttfts) // 2]
        out[f"ttft gemma3-4b {n} ms"] = ttfts
    best = 0.0
    for _ in range(3):
        stream = engine.generate_stream(list(range(1, 65)), max_completion_tokens=129,
                                        temperature=0.0)
        next(stream)
        n, t0 = 0, time.perf_counter()
        for _ in stream:
            n += 1
        best = max(best, n / (time.perf_counter() - t0))
    out["decode gemma3-4b tok/s"] = best
    del engine, model
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--one", action="store_true", help="measure the one --root here")
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.root[0], args.parts)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("prefill_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    for root in args.root:
        res = subprocess.run([sys.executable, __file__, "--one", "--root", root,
                              "--parts", *args.parts], capture_output=True, text=True)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return res.returncode
        row = json.loads(res.stdout.strip().splitlines()[-1])
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
