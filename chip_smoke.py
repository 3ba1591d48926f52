#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pie_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

0. device: the card's name and power limit (nvidia-smi); no CUDA -> error.
1. build: nvcc builds the kernels from pie_tpu_torch/csrc (sm_90a).
2. kernels: K1 (decode GEMV) and K2 (prefill GEMM) against their plain
   PyTorch version at the Llama-3-8B INT4 g=64 shapes (normalized max
   error < 0.025), each timed over 8 rotating weight copies with CUDA
   events (device time from a captured CUDA graph, and back-to-back calls
   from the host), beside the plain version, a torch.matmul yardstick on
   a pre-dequantized bf16 weight, and the least time the card could take.
3. model: a 2-layer model at the full 8B widths, same weights on the card
   (kernels) and on the CPU (plain versions): prefill 16 tokens, 4
   teacher-forced decode steps, then a 40-token chunk (so K2 runs too);
   logits agree to a normalized max error < 0.03.
4. engine: the 32-layer 8B geometry with random INT4 g=64 weights through
   InferenceEngine: one counted request (64-token prompt, 128 decoded
   tokens: K1 runs 129 times per decoded token, K2 129 times per prefill),
   TTFT p50 of a 512-token prompt, best-of-3 greedy decode tok/s.
5. requests: three requests over HTTP on localhost through the port's
   create_app (chat, chat SSE, completions with a logit_bias) on the 8B
   engine with an offline word-level tokenizer.

Prints one JSON line per phase, then the kernel summary line, the card's
name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores, data sheet
ROTATE = 8  # distinct weight copies per timing (the 50 MB L2 holds wqkv/wo)

# Llama-3-8B geometry (bench.py's llama3_8b_config)
D, DI, HQ, HKV, DH, VOCAB, LAYERS = 4096, 14336, 32, 8, 128, 128256, 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events; fn(i) does call i. Includes the
    host's time to issue each call where the host is the slower side."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 40) -> float:
    """Mean device ms per call: ``iters`` calls captured in one CUDA graph
    and replayed, so the host's per-call Python cost is not counted."""
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
    reps = 3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


# -- phase 2 -------------------------------------------------------------------


def random_qt(k, n, bits, g, copies, gen):
    """Stacked random quantized weights [copies, K, N] on the card."""
    from pie_tpu_torch.ops.quant import QuantizedTensor

    ep = 32 // bits
    packed = torch.randint(-(2**31), 2**31, (copies, k // ep, n), generator=gen,
                           dtype=torch.int32, device="cuda")
    sc = 0.02 / k**0.5
    scales = (torch.rand((copies, k // g, n), generator=gen, device="cuda") + 0.5) * sc
    biases = -scales * (2**bits - 1) / 2
    return QuantizedTensor(packed=packed, scales=scales.bfloat16(),
                           biases=biases.bfloat16(), bits=bits, group_size=g,
                           shape=(k, n))


def kernel_case(name, k, n, m, bits=4, g=64, ln=False, rope=False, seed=0):
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.ops.quant import dequantize
    from pie_tpu_torch.ops.rope import make_inv_freq, rope_qkv_cs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qt = random_qt(k, n, bits, g, ROTATE, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    kw = {}
    if ln:
        kw.update(ln_w=(1 + 0.1 * torch.randn((ROTATE, k), generator=gen,
                                              device="cuda")).bfloat16(),
                  ln_eps=1e-5)
    if rope:
        inv = torch.from_numpy(make_inv_freq(DH, 500000.0)).cuda()
        pos = torch.arange(m, dtype=torch.int32, device="cuda") + 100
        kw.update(rope_cs=rope_qkv_cs(pos, inv, HQ, HKV, DH), rope_dim=DH)
    kern = qmc.quant_matmul_cuda
    got = kern(x, qt, layer=0, **kw)
    want = qmc.quant_matmul_ref(x, qt, layer=0, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    norm = diff / want.float().abs().max().item()
    if not norm < 0.025:
        raise AssertionError(f"{name}: kernel vs plain normalized err {norm}")

    ms = device_ms(lambda i: kern(x, qt, layer=i % ROTATE, **kw))
    host_ms = cuda_ms(lambda i: kern(x, qt, layer=i % ROTATE, **kw), 50)
    plain_ms = cuda_ms(lambda i: qmc.quant_matmul_ref(x, qt, layer=i % ROTATE, **kw),
                       3, warmup=1)
    wlib = [dequantize(qt.layer(i), torch.bfloat16) for i in range(ROTATE)]
    library_ms = device_ms(lambda i: torch.matmul(x, wlib[i % ROTATE]))
    del wlib
    ep = 32 // bits
    nbytes = (k // ep * n * 4 + 2 * (k // g) * n * 2 + m * k * 2 + m * n * 2
              + (k * 2 if ln else 0) + (2 * m * n * 4 if rope else 0))
    flops = 2 * m * k * n
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    row = dict(
        phase="kernels", case=name, kernel="K1" if m <= qmc.DECODE_MAX_M else "K2",
        m=m, k=k, n=n, bits=bits, group_size=g, ln=ln, rope=rope,
        max_abs_err=diff, norm_err=norm, kernel_ms=ms, kernel_host_ms=host_ms,
        plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(bound_bytes, bound_ops),
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        bytes=nbytes, flops=flops,
    )
    emit(row)
    return row


# per decoded token: four projections per layer plus lm_head
MAIN_SHAPES = [  # name, K, N, per-token launches, ln, rope
    ("wqkv", D, (HQ + 2 * HKV) * DH, LAYERS, True, True),
    ("wo", HQ * DH, D, LAYERS, False, False),
    ("wgu", D, 2 * DI, LAYERS, True, False),
    ("wd", DI, D, LAYERS, False, False),
    ("lm_head", D, VOCAB, 1, True, False),
]


def phase_kernels():
    rows = {"K1": [], "K2": []}
    for name, k, n, per, ln, rope in MAIN_SHAPES:
        rows["K1"].append((per, kernel_case(f"{name} M=1", k, n, 1, ln=ln, rope=rope)))
    for m in (8, 32):
        kernel_case(f"wo M={m}", HQ * DH, D, m)
    for bits, g in ((8, 64), (4, 32), (4, 128)):
        kernel_case(f"wo M=1 int{bits} g{g}", HQ * DH, D, 1, bits=bits, g=g)
    for name, k, n, per, _, _ in MAIN_SHAPES:
        rows["K2"].append((per, kernel_case(f"{name} M=512", k, n, 512)))
    kernel_case("wo M=512 int8 g64", HQ * DH, D, 512, bits=8, g=64)
    torch.cuda.empty_cache()
    return rows


# -- phase 3 -------------------------------------------------------------------


def llama8b_config(layers):
    from pie_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        model_type="llama", hidden_size=D, intermediate_size=DI,
        num_hidden_layers=layers, num_attention_heads=HQ,
        num_key_value_heads=HKV, head_dim=DH, vocab_size=VOCAB,
        rope_theta=500000.0, tie_word_embeddings=False,
    )


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_model():
    from pie_tpu_torch.cache.kv_cache import make_kv_cache
    from pie_tpu_torch.models.llama import LlamaModel
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model = LlamaModel(llama8b_config(2))
    cpu_params = model.init_quantized_params(seed=1, device="cpu")
    gpu_params = to_device(cpu_params, "cuda")
    ids = torch.randint(0, VOCAB, (1, 60), generator=torch.Generator().manual_seed(2))
    worst = 0.0
    qmc.reset_counts()
    caches = {d: make_kv_cache(2, 1, 64, HKV, DH, dtype=torch.bfloat16, device=d)
              for d in ("cpu", "cuda")}
    # prefill 16 (K1: M <= 32), 4 decode steps (K1 with fused ln / rope),
    # then 40 more tokens in one chunk (K2)
    steps = [(0, 16)] + [(i, 1) for i in range(16, 20)] + [(20, 40)]
    for start, t in steps:
        out = {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            first = torch.tensor([start], dtype=torch.int32, device=dev)
            pos = first[:, None] + torch.arange(t, dtype=torch.int32, device=dev)[None]
            cache = caches[dev].advance(first, t)
            with torch.no_grad():
                logits, caches[dev] = model(params, ids[:, start:start + t].to(dev),
                                            cache, pos)
            out[dev] = logits.float().cpu()
        err = ((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()).item()
        if not (torch.isfinite(out["cuda"]).all() and err < 0.03):
            raise AssertionError(f"model check at position {start}: err {err}")
        worst = max(worst, err)
    counts = dict(qmc.launch_counts)
    if not (counts["K1"] > 0 and counts["K2"] > 0):
        raise AssertionError(f"model check did not run both kernels: {counts}")
    emit(dict(phase="model", layers=2, widths="llama3-8b", norm_err=worst,
              launches=counts))
    del cpu_params, gpu_params
    torch.cuda.empty_cache()
    return worst


# -- phase 4 -------------------------------------------------------------------


def phase_engine(card):
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.models.llama import LlamaModel
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model = LlamaModel(llama8b_config(LAYERS))
    params = model.init_quantized_params(seed=0, group_size=64, bits=4)
    engine = InferenceEngine(model=model, params=params, max_seq_len=1024,
                             decode_chunk=128)
    prompt = list(range(1, 65))
    engine.generate(prompt, max_completion_tokens=9, temperature=0.0)  # warm up

    # the counted main-path run: prefill 64 tokens, decode 128 more
    qmc.reset_counts()
    res = engine.generate([p + 7 for p in prompt], max_completion_tokens=129,
                          temperature=0.0)
    torch.cuda.synchronize()
    launches = dict(qmc.launch_counts)
    decoded = res.completion_tokens - 1
    if decoded != 128 or launches["K1"] != 129 * decoded or launches["K2"] != 129:
        raise AssertionError(f"main path launches {launches} for {decoded} tokens")

    def fresh_prompt(salt):
        return [1 + (i * 37 + salt * 101) % 100000 for i in range(512)]

    engine.generate(fresh_prompt(99), max_completion_tokens=1, temperature=0.0)
    ttfts = []
    for salt in range(5):
        gen = engine.generate_stream(fresh_prompt(salt), max_completion_tokens=2,
                                     temperature=0.0)
        t0 = time.perf_counter()
        next(gen)
        ttfts.append(time.perf_counter() - t0)
        for _ in gen:
            pass
    ttfts.sort()

    best = 0.0
    for _ in range(3):
        gen = engine.generate_stream(prompt, max_completion_tokens=129,
                                     temperature=0.0)
        next(gen)  # prefill + first token: TTFT's business
        n, t0 = 0, time.perf_counter()
        for _ in gen:
            n += 1
        best = max(best, n / (time.perf_counter() - t0))
    # device busy share over one request (64-token prefill + 32 decoded
    # tokens) from the profiler's kernel times; the profiler's own host
    # cost lengthens the wall time, so this idle share is an upper bound
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate([p + 3 for p in prompt], max_completion_tokens=33,
                        temperature=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_s = sum(getattr(e, "self_device_time_total", 0) for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    trace = dict(wall_ms=wall * 1e3, device_busy_ms=dev_s * 1e3,
                 device_idle_share=(1 - dev_s / wall) if dev_s else None,
                 top_kernels=[(e.key[:60], e.self_device_time_total / 1e3) for e in top])

    row = dict(phase="engine", geometry="llama3-8b int4 g64", layers=LAYERS,
               ttft_p50_ms=ttfts[2] * 1e3, ttft_ms=[t * 1e3 for t in ttfts],
               decode_tok_s=best, k1_per_decoded_token=launches["K1"] / decoded,
               k2_per_prefill=launches["K2"], launches=launches, trace=trace,
               card=card)
    emit(row)
    return engine, row


# -- phase 5 -------------------------------------------------------------------


def word_tokenizer():
    """Offline word-level tokenizer (the recipe of tests/test_server.py)."""
    import transformers
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    from pie_tpu_torch.tokenizer import Tokenizer
    from pie_tpu_torch.tokenizer.control_tokens import LLAMA3

    words = ["hello", "world", "how", "are", "you", "fine", "thanks", "user",
             "assistant", "system", "weather", "sunny", "<unk>"]
    specials = LLAMA3.all_control_tokens
    vocab = {w: i for i, w in enumerate(specials + words)}
    raw = RawTok(models.WordLevel(vocab, unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    hf = transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token="<|begin_of_text|>",
        eos_token="<|end_of_text|>", unk_token="<unk>",
    )
    return Tokenizer(hf, LLAMA3)


def phase_requests(engine):
    import asyncio

    import aiohttp
    from aiohttp import web

    from pie_tpu_torch.server.app import create_app
    from pie_tpu_torch.server.config import Settings

    engine.tokenizer = word_tokenizer()
    hello = engine.tokenizer.encode("hello", add_bos=False)[0]
    bias = {str(hello): 100.0}

    async def serve():
        runner = web.AppRunner(create_app(engine=engine, settings=Settings(),
                                          device=engine.device))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        url = f"http://127.0.0.1:{port}"
        out = {}
        try:
            async with aiohttp.ClientSession() as s:
                msg = [{"role": "user", "content": "hello world"}]
                t0 = time.perf_counter()
                async with s.post(f"{url}/v1/chat/completions", json=dict(
                        messages=msg, max_tokens=8, temperature=0.0,
                        logit_bias=bias)) as r:
                    body = await r.json()
                    assert r.status == 200, body
                    out["chat"] = dict(ms=(time.perf_counter() - t0) * 1e3,
                                       content=body["choices"][0]["message"]["content"],
                                       usage=body["usage"])
                    assert "hello" in out["chat"]["content"]
                t0 = time.perf_counter()
                async with s.post(f"{url}/v1/chat/completions", json=dict(
                        messages=msg, max_tokens=8, temperature=0.0, stream=True,
                        logit_bias=bias)) as r:
                    text = (await r.read()).decode()
                    assert r.status == 200 and text.rstrip().endswith("data: [DONE]")
                    chunks = [json.loads(line[6:]) for line in text.splitlines()
                              if line.startswith("data: ") and line != "data: [DONE]"]
                    content = "".join(c["choices"][0]["delta"].get("content") or ""
                                      for c in chunks if c["choices"])
                    assert "hello" in content, text
                    out["chat_sse"] = dict(ms=(time.perf_counter() - t0) * 1e3,
                                           chunks=len(chunks))
                t0 = time.perf_counter()
                async with s.post(f"{url}/v1/completions", json=dict(
                        prompt="hello world how", max_tokens=6, temperature=0.0,
                        logit_bias=bias)) as r:
                    body = await r.json()
                    assert r.status == 200, body
                    assert "hello" in body["choices"][0]["text"], body
                    out["completions"] = dict(ms=(time.perf_counter() - t0) * 1e3,
                                              text=body["choices"][0]["text"])
        finally:
            await runner.cleanup()
        return out

    out = asyncio.run(serve())
    emit(dict(phase="requests", transport="http", **out))


# -- main ----------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    card = card_line()
    emit(dict(phase="device", nvidia_smi=card, torch=torch.__version__,
              cuda=torch.version.cuda))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    t0 = time.perf_counter()
    paths = qmc.build()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libs=sorted(str(p) for p in paths.values())))

    rows = phase_kernels()
    phase_model()
    engine, eng = phase_engine(card)
    phase_requests(engine)

    summary = []
    for kname, src, what in (
        ("K1", "pie_tpu_torch/csrc/quant_gemv.cu", "per decoded token"),
        ("K2", "pie_tpu_torch/csrc/quant_gemm.cu", "per 512-token prefill"),
    ):
        per_rows = rows[kname]
        total = lambda key: sum(per * r[key] for per, r in per_rows)
        bb = sum(per * r["bytes"] for per, r in per_rows) / HBM_BYTES_PER_S * 1e3
        bo = sum(per * r["flops"] for per, r in per_rows) / BF16_FLOP_PER_S * 1e3
        summary.append(dict(
            name=f"{kname} {'quant_gemv' if kname == 'K1' else 'quant_gemm'} "
                 f"(8B int4 g64, {what})",
            route="cuda", source=src,
            replaces="pie_tpu/ops/quant_matmul_pallas.py:593",
            launches=eng["launches"][kname],
            max_abs_err=max(r["max_abs_err"] for _, r in per_rows),
            ms=total("kernel_ms"), plain_ms=total("plain_ms"),
            bound_ms=max(bb, bo), bound_by="bytes" if bb >= bo else "operations",
            library_ms=total("library_ms"),
        ))
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
