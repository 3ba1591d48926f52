"""A/B of K1 (the decode dequant-GEMV), K3 (the paged decode attention),
K4 (the fused decode MLP block) and decode speed between checkouts of this
repository, on one CUDA card.

    python3 pie_tpu_torch/tools/decode_ab.py --root A --root B --root B --root A \
        [--parts k1 k4 k3 8b 1b first]

Each ``--root`` is a checkout whose ``pie_tpu_torch`` is imported, in a
fresh process per root and in the order given (parent, change, change,
parent takes the card's drift out of the comparison). For each root:

- K1's device time (a captured CUDA graph over 8 rotating weight copies)
  at the five Llama-3-8B projections (ln and rope where the model fuses
  them) at M = 1, 8, 16 and 32, summed per decoded token (M = 1: 129
  launches) and per decode step of M lanes, and the Llama-3.2-1B wqkv
  (ln, rope dh 64) and f32-scale head at M = 1 and 8, summed per step;
- K4 (the fused decode MLP block; ``k4``) at the Llama-3.2-1B widths,
  INT4 g64 at M = 1 and 8 and INT8 g64 at M = 8, and at the Llama-3-8B
  widths at M = 1 and 8 (recorded only: the model keeps K4 off there),
  and per 1B decoded token and paged step (16 launches);
- K3's device time (a captured CUDA graph over the 4 layers of a pool)
  at 8 lanes x 2,048 INT8 tokens, summed per device step at the
  Llama-3-8B heads (32 launches; also on bf16 pages), the Llama-3.2-1B
  heads (16 launches) and the Gemma-3 4B heads at head dim 256 on INT8
  and bf16 pages (34 launches: 29 sliding layers windowed to 1,024
  tokens and 5 global ones);
- 8B single-stream decode tok/s (``InferenceEngine``, best of 3 x 128
  greedy tokens), 8B paged tok/s (``PagedEngine`` + ``Scheduler``, 8
  lanes of 64-token prompts x 128 new tokens, INT8 KV, best of 2) and 8B
  paged tok/s at 2,048-token contexts (8 lanes of 1,920-token prompts,
  the 128-token drain after every lane's first token, as ``chip_smoke.py``
  times it), with random INT4 g64 weights from a seed (``8b``);
- the same single-stream and 8-lane paged tok/s on the 16-layer
  Llama-3.2-1B geometry, where K4 runs every layer's MLP block (``1b``);
- on the same 1B geometry, the ms of the first and the second request
  (a 64-token prompt, 9 greedy tokens) of a fresh single-stream engine
  and of a fresh scheduler (``first``): what the first user of a process
  pays for one-time set-up (kernel attributes, workspaces, and where the
  checkout compiles its steps, the graph captures). It runs before the
  other engine parts; choose it without the kernel parts for a process
  whose first request it is.

``--parts`` picks sections (K1 is ``k1``, K3 ``k3``; all by default).

Prints one JSON line per root with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

if __package__:
    from .prefill_ab import ROTATE, device_ms, random_weights
else:  # run as a script, from any checkout
    from prefill_ab import ROTATE, device_ms, random_weights

# name, K, N, launches per decoded token, ln, rope heads (Hq, Hkv, dh) or None
DECODE_8B = [("wqkv", 4096, 6144, 32, True, (32, 8, 128)),
             ("wo", 4096, 4096, 32, False, None),
             ("wgu", 4096, 28672, 32, True, None),
             ("wd", 14336, 4096, 32, False, None),
             ("lm_head", 4096, 128256, 1, True, None)]
# 1B decode: K1 runs wqkv and the tied head (f32 scales); K4 the rest
DECODE_1B = [("wqkv", 2048, 3072, 16, True, (32, 8, 64), False),
             ("lm_head", 2048, 128256, 1, True, None, True)]


def k3_inputs(hq, hkv, d, quantized, layers=4, lanes=8, context=2048, seed=1, window=0):
    """A random paged pool [layers, P + 1, Hkv, 64, D] on the card (bf16, or
    int8 with f32 scales), every lane at ``context`` tokens over shuffled
    pages, bf16 queries; and the bytes K3 must move per call with this
    ``window`` (the walked pages, q, the output, the tables, the lengths)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    maxp = -(-context // 64)
    p = lanes * maxp
    shape = (layers, p + 1, hkv, 64, d)
    if quantized:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:4], generator=gen, device="cuda") * 0.02 + 0.005
                  for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        ks = vs = None
    tables = torch.randperm(p, generator=gen, device="cuda").to(torch.int32)
    tables = tables.reshape(lanes, maxp)
    q = torch.randn((lanes, hq, d), generator=gen, device="cuda").bfloat16()
    ctx = torch.full((lanes,), context, dtype=torch.int32, device="cuda")
    per_page_head = 2 * 64 * d * k.element_size() + (2 * 64 * 4 if quantized else 0)
    walked = lanes * (maxp - (max(context - window, 0) // 64 if window > 0 else 0))
    nbytes = walked * hkv * per_page_head + 2 * q.numel() * 2 + tables.numel() * 4 + lanes * 4
    return q, k, v, ks, vs, tables, ctx, nbytes


def k3_ms(pa, hq, hkv, d, quantized, layers=4, window=0) -> float:
    """K3's device ms per call at 8 lanes x 2,048 tokens, over rotating layers."""
    q, k, v, ks, vs, tables, ctx, _ = k3_inputs(hq, hkv, d, quantized, layers)
    scale = d ** -0.5
    return device_ms(lambda i: pa.paged_attention_decode(q, k, v, ks, vs, i % layers,
                                                         tables, ctx, scale, window))


def k1_case(qmc, gen, k, n, m, ln, heads, f32=False) -> float:
    """K1's device ms at one shape."""
    import torch

    from pie_tpu_torch.ops.rope import make_inv_freq, rope_qkv_cs

    qt = random_weights(k, n, gen, f32)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    kw = {}
    if ln:
        kw.update(ln_w=(1 + 0.1 * torch.randn((ROTATE, k), generator=gen,
                                              device="cuda")).bfloat16(), ln_eps=1e-5)
    if heads:
        hq, hkv, dh = heads
        inv = torch.from_numpy(make_inv_freq(dh, 500000.0)).cuda()
        pos = torch.arange(m, dtype=torch.int32, device="cuda") + 100
        kw.update(rope_cs=rope_qkv_cs(pos, inv, hq, hkv, dh), rope_dim=dh)
    return device_ms(lambda i: qmc.quant_matmul_cuda(x, qt, layer=i % ROTATE, **kw))


PARTS = ("k1", "k4", "k3", "8b", "1b", "first")
# K3 cases: label, (Hq, Hkv, D), INT8 pages, launches per step
K3_CASES = [("8B int8", (32, 8, 128), True, 32), ("8B bf16", (32, 8, 128), False, 32),
            ("1B int8", (32, 8, 64), True, 16)]
# Gemma-3 4B at head dim 256: launches per step windowed to 1,024 tokens, and full
G4_K3 = ((8, 4, 256), {1024: 29, 0: 5})
# K4 cases: name, d, di, M, bits
K4_CASES = [("1B M=1", 2048, 8192, 1, 4), ("1B M=8", 2048, 8192, 8, 4),
            ("1B M=8 int8", 2048, 8192, 8, 8), ("8B M=1", 4096, 14336, 1, 4),
            ("8B M=8", 4096, 14336, 8, 4)]


def engine_tok_s(model, params, prompt) -> tuple[float, float]:
    """Single-stream decode tok/s (best of 3 x 128 greedy tokens) and
    8-lane paged tok/s (8 x 128 new tokens, INT8 KV, best of 2)."""
    import torch

    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler

    engine = InferenceEngine(model=model, params=params, max_seq_len=1024, decode_chunk=128)
    engine.generate(prompt, max_completion_tokens=9, temperature=0.0)
    single = 0.0
    for _ in range(3):
        stream = engine.generate_stream(prompt, max_completion_tokens=129, temperature=0.0)
        next(stream)
        n, t0 = 0, time.perf_counter()
        for _ in stream:
            n += 1
        single = max(single, n / (time.perf_counter() - t0))
    del engine
    torch.cuda.empty_cache()
    paged = PagedEngine(model, params, num_lanes=8, num_pages=112, max_pages_per_seq=12,
                        kv_quantized=True)
    sched = Scheduler(paged, decode_steps=8)
    sched.add_request(prompt, max_new_tokens=17, temperature=0.0)
    sched.run_to_completion()
    lanes = 0.0
    for _ in range(2):
        seqs = [sched.add_request(prompt, max_new_tokens=128, temperature=0.0)
                for _ in range(8)]
        t0 = time.perf_counter()
        sched.run_to_completion()
        torch.cuda.synchronize()
        lanes = max(lanes, sum(len(s.output_ids) for s in seqs) / (time.perf_counter() - t0))
    del sched, paged
    torch.cuda.empty_cache()
    return single, lanes


def first_request_ms(model, params, prompt) -> dict:
    """ms of the first and second request (9 greedy tokens) of a fresh
    InferenceEngine and of a fresh Scheduler over 8 lanes of INT8 pages,
    each ending in a synchronize."""
    import torch

    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler

    out = {}
    engine = InferenceEngine(model=model, params=params, max_seq_len=1024, decode_chunk=128)
    for i, p in enumerate((prompt, [t + 1 for t in prompt])):
        t0 = time.perf_counter()
        engine.generate(p, max_completion_tokens=9, temperature=0.0)
        torch.cuda.synchronize()
        out[f"1B single request {i + 1} ms"] = (time.perf_counter() - t0) * 1e3
    del engine
    sched = Scheduler(PagedEngine(model, params, num_lanes=8, num_pages=112,
                                  max_pages_per_seq=12, kv_quantized=True), decode_steps=8)
    for i, p in enumerate((prompt, [t + 1 for t in prompt])):
        t0 = time.perf_counter()
        sched.add_request(p, max_new_tokens=9, temperature=0.0)
        sched.run_to_completion()
        torch.cuda.synchronize()
        out[f"1B paged request {i + 1} ms"] = (time.perf_counter() - t0) * 1e3
    del sched
    torch.cuda.empty_cache()
    return out


def measure(root: str, parts=PARTS) -> dict:
    """The chosen parts for one checkout, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler
    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from pie_tpu_torch.ops import fused_mlp as fm
    from pie_tpu_torch.ops import paged_attention as pa
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    if not qmc.__file__.startswith(root):
        raise RuntimeError(f"imported {qmc.__file__}, not the checkout at {root}")
    qmc.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root}
    for m in (1, 8, 16, 32) if "k1" in parts else ():
        total = 0.0
        for name, k, n, per, ln, heads in DECODE_8B:
            ms = k1_case(qmc, gen, k, n, m, ln, heads)
            out[f"k1 8B {name} M={m} us"] = ms * 1e3
            total += per * ms
            torch.cuda.empty_cache()
        out[f"k1 per 8B step M={m} ms"] = total
    for m in (1, 8) if "k1" in parts else ():
        total = 0.0
        for name, k, n, per, ln, heads, f32 in DECODE_1B:
            ms = k1_case(qmc, gen, k, n, m, ln, heads, f32)
            out[f"k1 1B {name} M={m} us"] = ms * 1e3
            total += per * ms
            torch.cuda.empty_cache()
        out[f"k1 per 1B step M={m} ms"] = total

    for name, d, di, m, bits in K4_CASES if "k4" in parts else ():
        wo, wgu, wd = (random_weights(k, n, gen, bits=bits)
                       for k, n in ((d, d), (d, 2 * di), (di, d)))
        ln2 = (1 + 0.1 * torch.randn((ROTATE, d), generator=gen, device="cuda")).bfloat16()
        attn, h = (torch.randn((m, d), generator=gen, device="cuda").bfloat16()
                   for _ in range(2))
        out[f"k4 {name} us"] = 1e3 * device_ms(
            lambda i: fm.fused_mlp_stacked(attn, h, ln2, i % ROTATE, wo, wgu, wd, 1e-5))
        del wo, wgu, wd
        torch.cuda.empty_cache()
    if "k4" in parts:
        out["k4 per 1B token ms"] = 16 * out["k4 1B M=1 us"] / 1e3
        out["k4 per 1B paged step ms"] = 16 * out["k4 1B M=8 us"] / 1e3
    for label, heads, quantized, per in K3_CASES if "k3" in parts else ():
        ms = k3_ms(pa, *heads, quantized)
        out[f"k3 {label} 8x2048 us"] = ms * 1e3
        out[f"k3 per {label[:2]} step {label[3:]} ms"] = per * ms
        torch.cuda.empty_cache()
    for kind in ("int8", "bf16") if "k3" in parts else ():
        heads, per_window = G4_K3
        total = 0.0
        for window, per in per_window.items():
            ms = k3_ms(pa, *heads, kind == "int8", window=window)
            out[f"k3 4B {kind} window {window} 8x2048 us"] = ms * 1e3
            total += per * ms
            torch.cuda.empty_cache()
        out[f"k3 per 4B step {kind} ms"] = total

    prompt = list(range(1, 65))
    if "1b" in parts or "first" in parts:
        model = LlamaModel(LlamaConfig(
            model_type="llama", hidden_size=2048, intermediate_size=8192,
            num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
            head_dim=64, vocab_size=128256, rope_theta=500000.0,
            tie_word_embeddings=True))
        params = model.init_quantized_params(seed=0, group_size=64, bits=4)
        if "first" in parts:
            out.update(first_request_ms(model, params, prompt))
        if "1b" in parts:
            out["1B decode tok/s"], out["1B paged tok/s"] = engine_tok_s(
                model, params, prompt)
        del model, params
        torch.cuda.empty_cache()
    if "8b" not in parts:
        return out
    model = LlamaModel(LlamaConfig(
        model_type="llama", hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        vocab_size=128256, rope_theta=500000.0, tie_word_embeddings=False))
    params = model.init_quantized_params(seed=0, group_size=64, bits=4)
    out["8B decode tok/s"], out["8B paged tok/s"] = engine_tok_s(model, params, prompt)

    ctx, new, lanes = 2048, 128, 8
    pages = ctx // 64 + 2
    paged = PagedEngine(model, params, num_lanes=lanes, num_pages=lanes * pages + 8,
                        max_pages_per_seq=pages, kv_quantized=True)
    sched = Scheduler(paged, decode_steps=8, prefix_cache=False)
    long_prompt = lambda salt: [1 + (i * 37 + salt * 101) % 100000 for i in range(ctx - new)]
    sched.add_request(long_prompt(0), max_new_tokens=9, temperature=0.0)
    sched.run_to_completion()
    seqs = [sched.add_request(long_prompt(i + 1), max_new_tokens=new, temperature=0.0)
            for i in range(lanes)]
    while any(not s.output_ids for s in seqs):
        sched.step()
    done0 = sum(len(s.output_ids) for s in seqs)
    t0 = time.perf_counter()
    sched.run_to_completion()
    torch.cuda.synchronize()
    out["8B paged tok/s at 2048"] = ((sum(len(s.output_ids) for s in seqs) - done0)
                                     / (time.perf_counter() - t0))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--one", action="store_true", help="measure the one --root here")
    ap.add_argument("--parts", nargs="*", default=list(PARTS), choices=PARTS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.root[0], args.parts)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA card", file=sys.stderr)
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
