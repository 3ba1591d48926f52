#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pie_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

0. device: the card's name and power limit (nvidia-smi); no CUDA -> error.
1. build: nvcc builds every kernel source under pie_tpu_torch/csrc (sm_90a),
   one process per source, all started together.
2. kernels: K1 (decode GEMV) and K2 (prefill GEMM, also with the rope
   epilogue at M = 40 and 256) against their plain PyTorch version at the
   Llama-3-8B INT4 g=64 shapes (normalized max error < 0.025), each timed
   over 8 rotating weight copies with CUDA events (device time from a
   captured CUDA graph, and back-to-back calls from the host), beside the
   plain version, a torch.matmul yardstick on a pre-dequantized bf16
   weight, and the least time the card could take. Then K3 (paged decode
   attention) against its plain version at the 8B heads (D 128) and the 1B
   heads (D 64), bf16 and INT8 pools, 8 lanes of contexts 1..2048, windows
   0 and 256, layer 3 of a 4-layer pool (normalized max error < 2e-2), and
   timed at 8 lanes x 2,048 tokens (INT8 and bf16) over rotating layers
   beside the plain version and scaled_dot_product_attention on K/V
   gathered and dequantized beforehand.
3. model: a 2-layer model at the full 8B widths, same weights on the card
   (kernels) and on the CPU (plain versions): prefill 16 tokens, 4
   teacher-forced decode steps, then a 40-token chunk (so K2 runs too);
   then, over an INT8 paged pool, paged_forward (a 40-token prefill, 4
   decode steps) and mixed_forward (lanes plus a 40-token rider: K2 with
   rope; an empty rider; frozen lanes); logits agree to a normalized max
   error < 0.03, and K3 ran.
4. engine: the 32-layer 8B geometry with random INT4 g=64 weights through
   InferenceEngine: one counted request (64-token prompt, 128 decoded
   tokens: K1 runs 129 times per decoded token, K2 129 times per prefill),
   TTFT p50 of a 512-token prompt, best-of-3 greedy decode tok/s.
5. requests: three requests over HTTP on localhost through the port's
   create_app (chat, chat SSE, completions with a logit_bias) on the 8B
   engine with an offline word-level tokenizer.
6. paged engine: the same 8B weights through PagedEngine + Scheduler
   (8 lanes, 112 INT8 pages, 12 pages per sequence, 8-step chunks, as
   bench.py's paged configuration): one counted run of 8 identical
   64-token prompts x 128 new tokens (identical greedy streams; K3 runs
   32 times per device step), aggregate decode tok/s best of 2, the
   device idle share over one steady chunk, TTFT p50 of 3 distinct
   512-token prompts admitted under 7 busy lanes, TTFT of a prefix-cache
   hit, and 8 lanes at 2,048-token contexts (34 pages per sequence, no
   prefix cache) as tok/s.
7. batched requests: create_app over a BatchedInferenceEngine on the 8B
   weights answers 4 concurrent chats and one n=2 chat over HTTP.

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
    # the mixed step's QKV projection: K2 with the rope epilogue at
    # M = lanes + rider (8 + 248 in the paged engine)
    for m in (40, 256):
        kernel_case(f"wqkv M={m} (rope)", D, (HQ + 2 * HKV) * DH, m, rope=True)
    torch.cuda.empty_cache()
    return rows


# -- phase 2, K3 ---------------------------------------------------------------

PAGED_LENS = (1, 63, 64, 65, 700, 1500, 2048, 2048)
POOL_LAYERS = 4  # the checks read layer 3; the timings rotate over all four


def paged_inputs(lens, hq, hkv, dh, quantized, seed=0):
    """A random paged pool [4, P + 1, Hkv, 64, D] on the card (bf16, or int8
    with f32 scales), block tables of shuffled pages with -1 pads, bf16
    queries [B, Hq, D] and the context lengths."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, maxp = len(lens), -(-max(lens) // 64)
    p = b * maxp
    shape = (POOL_LAYERS, p + 1, hkv, 64, dh)
    if quantized:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:4], generator=gen, device="cuda") * 0.02 + 0.005
                  for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        ks = vs = None
    perm = torch.randperm(p, generator=gen, device="cuda").to(torch.int32)
    tables = torch.full((b, maxp), -1, dtype=torch.int32, device="cuda")
    for i, n in enumerate(lens):
        tables[i, :-(-n // 64)] = perm[i * maxp:i * maxp - (-n // 64)]
    q = torch.randn((b, hq, dh), generator=gen, device="cuda").bfloat16()
    ctx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, ks, vs, tables, ctx


def paged_check(inputs, layer, window):
    """K3 against its plain version on the same card inputs; returns the
    max abs error and the largest per-lane normalized one (limit 2e-2:
    each lane against its own largest value, so the long, windowed lanes
    count as much as the short ones)."""
    from pie_tpu_torch.ops import paged_attention as pa

    q, k, v, ks, vs, tables, ctx = inputs
    scale = q.shape[-1] ** -0.5
    got = pa.paged_attention_decode(q, k, v, ks, vs, layer, tables, ctx, scale, window)
    want = pa.paged_attention_ref(q.float(), k, v, ks, vs, layer, tables, ctx, scale,
                                  window)
    torch.cuda.synchronize()
    if not (got.dtype == torch.bfloat16 and got.shape == want.shape
            and torch.isfinite(got).all()):
        raise AssertionError(f"K3 output {got.dtype} {tuple(got.shape)}")
    lane_err = (got.float() - want).abs().amax(dim=(1, 2))
    diff = lane_err.max().item()
    norm = (lane_err / want.abs().amax(dim=(1, 2))).max().item()
    if not norm < 2e-2:
        raise AssertionError(f"K3 vs plain normalized err {norm} (window {window})")
    return diff, norm


def paged_bytes(inputs, window=0):
    """Bytes K3 must move for these inputs: the walked page-heads of K and V
    (and their INT8 scales), q, the tables and lengths, the output."""
    q, k, _, ks, _, tables, ctx = inputs
    hkv, dh = k.shape[2], k.shape[4]
    pages = 0
    for n in ctx.tolist():
        lo = max(n - window, 0) if window > 0 else 0
        pages += -(-n // 64) - lo // 64
    per_page_head = 2 * 64 * dh * k.element_size() + (2 * 64 * 4 if ks is not None else 0)
    return (pages * hkv * per_page_head + 2 * q.numel() * 2 + tables.numel() * 4
            + ctx.numel() * 4), pages


def paged_timing(quantized):
    """K3 at 8 lanes x 2,048 tokens, 8B heads: device time over rotating
    layers, host time, the plain version, SDPA on K/V gathered and
    dequantized beforehand (yardstick only), and the bound."""
    import torch.nn.functional as F

    from pie_tpu_torch.cache.paged import PagedKVPool, gather_kv
    from pie_tpu_torch.ops import paged_attention as pa

    inputs = paged_inputs((2048,) * 8, HQ, HKV, DH, quantized, seed=1)
    q, k, v, ks, vs, tables, ctx = inputs
    scale = DH ** -0.5
    kern = lambda i: pa.paged_attention_decode(q, k, v, ks, vs, i % POOL_LAYERS,
                                               tables, ctx, scale)
    ms = device_ms(kern)
    host_ms = cuda_ms(kern, 50)
    plain_ms = cuda_ms(lambda i: pa.paged_attention_ref(
        q, k, v, ks, vs, i % POOL_LAYERS, tables, ctx, scale), 3, warmup=1)
    pool = PagedKVPool(k, v, ks, vs)
    dense = []
    for layer in range(POOL_LAYERS):
        kd, vd = gather_kv(pool, layer, tables, torch.bfloat16)  # [B, S, Hkv, D]
        dense.append((kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()))
    s = dense[0][0].shape[2]
    mask = (torch.arange(s, device="cuda")[None] < ctx[:, None])[:, None, None]
    qs = q[:, :, None]  # [B, Hq, 1, D]
    lib = lambda i: F.scaled_dot_product_attention(
        qs, *dense[i % POOL_LAYERS], attn_mask=mask, scale=scale, enable_gqa=True)
    library_ms = device_ms(lib)
    nbytes, pages = paged_bytes(inputs)
    flops = 4 * int(ctx.sum().item()) * HQ * DH  # q.k and p.v per token and head
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / BF16_FLOP_PER_S * 1e3
    diff, norm = paged_check(inputs, 3, 0)
    row = dict(
        phase="kernels", case=f"paged attention 8x2048 {'int8' if quantized else 'bf16'}",
        kernel="K3", lanes=8, context=2048, hq=HQ, hkv=HKV, head_dim=DH,
        quantized=quantized, splits=pa.page_splits(8, HKV, tables.shape[1]),
        max_abs_err=diff, norm_err=norm, kernel_ms=ms, kernel_host_ms=host_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bound_bytes, bound_ops),
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        bytes=nbytes, walked_page_heads=pages * HKV, flops=flops,
    )
    emit(row)
    del dense, inputs, q, k, v, ks, vs
    torch.cuda.empty_cache()
    return row


def phase_paged_kernel():
    """K3 against its plain version at the 8B (D 128) and 1B (D 64) heads,
    bf16 and INT8, windows 0 and 256, layer 3 of 4; then the timed rows."""
    worst = 0.0
    for dh in (DH, 64):
        for quantized in (False, True):
            inputs = paged_inputs(PAGED_LENS, HQ, HKV, dh, quantized, seed=dh)
            for window in (0, 256):
                diff, norm = paged_check(inputs, 3, window)
                worst = max(worst, diff)
                emit(dict(phase="kernels", case="paged attention check", kernel="K3",
                          head_dim=dh, quantized=quantized, window=window,
                          lens=PAGED_LENS, layer=3, max_abs_err=diff, norm_err=norm))
            del inputs
    rows = {q: paged_timing(q) for q in (True, False)}
    return rows, max([worst] + [r["max_abs_err"] for r in rows.values()])


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
    paged_model_check(model, cpu_params, gpu_params)
    del cpu_params, gpu_params
    torch.cuda.empty_cache()
    return worst


def paged_model_check(model, cpu_params, gpu_params):
    """The continuous-batching forwards over an INT8 paged pool, card
    against CPU: paged_forward prefills lanes 0 and 1 (40 and 20 tokens)
    and decodes 4 steps (lane 2 frozen throughout, lane 1 at step 2), then
    mixed_forward runs lanes plus lane 2's 33-token prompt as a rider
    (M = 3 + 40: K2 with the rope epilogue), an empty rider as lane 2
    wakes, and a rider for lane 1 while it is frozen."""
    import numpy as np

    from pie_tpu_torch.cache.paged import PagedKVPool
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    tables = np.array([[3, 7, 10], [11, 0, 5], [9, 2, 6]], np.int32)
    pools = {d: PagedKVPool.create(2, 12, HKV, DH, torch.bfloat16, True, device=d)
             for d in ("cpu", "cuda")}
    params = {"cpu": cpu_params, "cuda": gpu_params}
    prompts = np.random.default_rng(5).integers(0, VOCAB, (3, 40)).astype(np.int32)
    t = lambda a, d: torch.from_numpy(np.asarray(a, np.int32)).to(d)

    def compare(what, run, rows):
        out = {}
        for dev in ("cpu", "cuda"):
            with torch.no_grad():
                out[dev] = run(dev).float().cpu()[rows]
        err = ((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()).item()
        if not (torch.isfinite(out["cuda"]).all() and err < 0.03):
            raise AssertionError(f"paged model check, {what}: err {err}")
        return err

    qmc.reset_counts()
    errs = []
    lens = np.array([40, 20])
    pos = np.where(np.arange(40)[None] < lens[:, None], np.arange(40)[None], -1)
    ids = np.where(pos >= 0, prompts[:2], 0)
    errs.append(compare("prefill", lambda d: model.paged_forward(
        params[d], t(ids, d), pools[d], t(tables[:2], d), t(pos, d), t(lens, d))[0],
        torch.from_numpy(pos >= 0)))
    ctx = np.array([40, 20, 0])
    tok = np.array([prompts[0, 39], prompts[1, 19], 0])
    for step in range(4):
        frozen = np.array([False, step == 2, True])
        dpos = np.where(frozen, -1, ctx)
        dctx = np.where(frozen, 1, ctx + 1)
        errs.append(compare(f"decode {step}", lambda d: model.paged_forward(
            params[d], t(tok[:, None], d), pools[d], t(tables, d), t(dpos[:, None], d),
            t(dctx, d))[0][:, 0], torch.from_numpy(~frozen)))
        tok = prompts[:, 10 + step]  # teacher-forced
        ctx = np.where(frozen, ctx, ctx + 1)
    cs = 40
    rider = np.full(cs, -1)
    rider_pos = np.full(cs, -1)
    rider[:33], rider_pos[:33] = prompts[2, :33], np.arange(33)
    lane1 = np.full(cs, -1)
    lane1_pos = np.full(cs, -1)
    lane1[:5], lane1_pos[:5] = prompts[1, 30:35], np.arange(25, 30)
    steps = [  # dec tokens, dec positions, dec ctx, rider, rider pos, lane, ctx
        ([11, 12, 0], [44, 23, -1], [45, 24, 1], rider, rider_pos, 2, 33),
        ([13, 14, prompts[2, 33]], [45, 24, 33], [46, 25, 34],
         np.full(cs, -1), np.full(cs, -1), 0, 0),
        ([15, 0, 16], [46, -1, 34], [47, 1, 35], lane1, lane1_pos, 1, 30),
    ]
    for i, (dt, dp, dc, pi, pp, lane, pctx) in enumerate(steps):
        errs.append(compare(f"mixed {i}", lambda d: model.mixed_forward(
            params[d], pools[d], t(dt, d), t(dp, d), t(dc, d), t(tables, d), t(pi, d),
            t(pp, d), lane, pctx, pf_any=bool((pi >= 0).any()))[0],
            torch.from_numpy(np.asarray(dp) >= 0)))
    counts = dict(qmc.launch_counts)
    if not (counts["K1"] > 0 and counts["K2"] > 0 and counts["K3"] > 0):
        raise AssertionError(f"paged model check did not run every kernel: {counts}")
    emit(dict(phase="model", path="paged_forward + mixed_forward", layers=2,
              widths="llama3-8b", kv="int8 paged", norm_err=max(errs), launches=counts))


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


# -- phase 6 -------------------------------------------------------------------


def profiled(fn):
    """Run fn() under the profiler: wall time (ending in a synchronize),
    device busy time and idle share from the kernels' times, the top
    kernels, and the PyTorch operator calls the host issued. The
    profiler's own host cost lengthens the wall time, so the idle share is
    an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    ops = [e for e in events if e.key.startswith("aten::")]
    host_top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]
    return dict(wall_ms=wall * 1e3, device_busy_ms=dev_s * 1e3,
                device_idle_share=1 - dev_s / wall if dev_s else None,
                top_kernels=[(e.key[:60], e.self_device_time_total / 1e3) for e in top],
                aten_calls=sum(e.count for e in ops),
                top_host_ops=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                              for e in host_top])


def phase_paged_engine(model, params, card):
    """Continuous batching on the 8B weights (bench.py:156-303's paged
    configurations), with the launch counts of one counted run."""
    import gc

    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler, SeqStatus
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    lanes = 8
    engine = PagedEngine(model, params, num_lanes=lanes, num_pages=112,
                         max_pages_per_seq=12, kv_quantized=True)
    sched = Scheduler(engine, decode_steps=8)
    prompt = list(range(1, 65))
    sched.add_request(prompt, max_new_tokens=17, temperature=0.0)  # warm up
    sched.run_to_completion()

    # the counted main-path run, then a second for the best of 2
    best, streams = 0.0, set()
    for rep in range(2):
        qmc.reset_counts()
        steps0 = engine.device_steps
        seqs = [sched.add_request(prompt, max_new_tokens=128, temperature=0.0)
                for _ in range(lanes)]
        t0 = time.perf_counter()
        sched.run_to_completion()
        torch.cuda.synchronize()
        best = max(best, sum(len(s.output_ids) for s in seqs) / (time.perf_counter() - t0))
        if rep == 0:
            launches = dict(qmc.launch_counts)
            steps = engine.device_steps - steps0
        streams |= {tuple(s.output_ids) for s in seqs}
    if len(streams) != 1 or len(seqs[0].output_ids) != 128:
        raise AssertionError(f"16 identical prompts gave {len(streams)} streams")
    if not (steps > 0 and launches["K3"] == LAYERS * steps):
        raise AssertionError(f"paged path: {launches} launches over {steps} steps")

    # one steady chunk under the profiler
    seqs = [sched.add_request(prompt, max_new_tokens=64, temperature=0.0)
            for _ in range(lanes)]
    while sched.waiting or any(s.status != SeqStatus.DECODING for s in seqs):
        sched.step()
    sched.step()
    steps0 = engine.device_steps
    trace = profiled(sched.step)
    trace["device_steps"] = engine.device_steps - steps0
    sched.run_to_completion()

    # TTFT of 512-token prompts admitted while 7 lanes decode: distinct
    # prompts (no prefix-cache hit), then one prompt again (a hit)
    busy = [sched.add_request(prompt, max_new_tokens=400, temperature=0.0)
            for _ in range(lanes - 1)]
    while any(not s.output_ids for s in busy):
        sched.step()

    def fresh_prompt(salt):
        return [1 + (i * 37 + salt * 101) % 100000 for i in range(512)]

    def first_token(req_prompt):
        late = sched.add_request(req_prompt, max_new_tokens=8, temperature=0.0)
        while not late.output_ids:
            sched.step()
        return late

    def ttft_of(req_prompt):
        t0 = time.perf_counter()
        late = first_token(req_prompt)
        dt = time.perf_counter() - t0
        while late.finish_reason is None:
            sched.step()
        return dt

    ttft_of(fresh_prompt(50))  # warm up the admission path
    ttfts = sorted(ttft_of(fresh_prompt(s)) for s in range(3))
    profiled_late = []
    ttft_trace = profiled(lambda: profiled_late.append(first_token(fresh_prompt(60))))
    while profiled_late[0].finish_reason is None:
        sched.step()
    ttft_of(fresh_prompt(99))  # populate the prefix store
    hits0 = sched.prefix_store.hits
    ttft_cached = ttft_of(fresh_prompt(99))
    if sched.prefix_store.hits != hits0 + 1:
        raise AssertionError("the repeated prompt missed the prefix cache")
    for s in busy:
        s.cancelled = True
    sched.run_to_completion()
    del sched, engine
    gc.collect()
    torch.cuda.empty_cache()

    # 8 lanes at 2,048-token contexts (bench.py:253-303): time the
    # decode-dominated drain after every lane has its first token
    ctx, new = 2048, 128
    pages_per_seq = ctx // 64 + 2
    engine = PagedEngine(model, params, num_lanes=lanes,
                         num_pages=lanes * pages_per_seq + 8,
                         max_pages_per_seq=pages_per_seq, kv_quantized=True)
    sched = Scheduler(engine, decode_steps=8, prefix_cache=False)

    def long_prompt(salt):
        return [1 + (i * 37 + salt * 101) % 100000 for i in range(ctx - new)]

    sched.add_request(long_prompt(0), max_new_tokens=9, temperature=0.0)
    sched.run_to_completion()
    seqs = [sched.add_request(long_prompt(i + 1), max_new_tokens=new, temperature=0.0)
            for i in range(lanes)]
    while any(not s.output_ids for s in seqs):
        sched.step()
    done0 = sum(len(s.output_ids) for s in seqs)
    t0 = time.perf_counter()
    sched.run_to_completion()
    long_tok_s = (sum(len(s.output_ids) for s in seqs) - done0) / (time.perf_counter() - t0)
    del sched, engine
    gc.collect()
    torch.cuda.empty_cache()

    row = dict(phase="paged_engine", geometry="llama3-8b int4 g64", layers=LAYERS,
               lanes=lanes, kv="int8 paged", decode_tok_s=best,
               ttft_under_load_p50_ms=ttfts[1] * 1e3,
               ttft_under_load_ms=[t * 1e3 for t in ttfts],
               ttft_prefix_hit_ms=ttft_cached * 1e3, ctx2048_tok_s=long_tok_s,
               device_steps=steps, k3_per_step=launches["K3"] / steps,
               launches=launches, steady_chunk=trace, ttft_trial=ttft_trace,
               card=card)
    emit(row)
    return row


# -- phase 7 -------------------------------------------------------------------


def phase_batched_requests(model, params):
    """create_app over the continuous-batching engine: 4 concurrent chats
    and one n=2 chat over HTTP on localhost."""
    import asyncio

    import aiohttp
    from aiohttp import web

    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
    from pie_tpu_torch.server.app import create_app
    from pie_tpu_torch.server.config import Settings

    engine = BatchedInferenceEngine(model=model, params=params,
                                    tokenizer=word_tokenizer(), num_lanes=8,
                                    num_pages=112, max_pages_per_seq=12,
                                    kv_quantized=True)
    hello = engine.tokenizer.encode("hello", add_bos=False)[0]
    body = dict(messages=[{"role": "user", "content": "hello world"}], max_tokens=8,
                temperature=0.0, logit_bias={str(hello): 100.0})

    async def serve():
        runner = web.AppRunner(create_app(engine=engine, settings=Settings(batching=True),
                                          device=engine.device))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
        try:
            async with aiohttp.ClientSession() as s:
                async def chat(**extra):
                    t0 = time.perf_counter()
                    async with s.post(f"{url}/v1/chat/completions",
                                      json=dict(body, **extra)) as r:
                        data = await r.json()
                        if r.status != 200:
                            raise AssertionError(f"chat: {r.status} {data}")
                    return (time.perf_counter() - t0) * 1e3, data

                await chat()  # warm up
                t0 = time.perf_counter()
                many = await asyncio.gather(*(chat() for _ in range(4)))
                wall = (time.perf_counter() - t0) * 1e3
                two = await chat(n=2)
        finally:
            await runner.cleanup()
        return many, wall, two

    try:
        many, wall, (two_ms, two) = asyncio.run(serve())
    finally:
        engine.shutdown()
    texts = [d["choices"][0]["message"]["content"] for _, d in many]
    if len(set(texts)) != 1 or "hello" not in texts[0]:
        raise AssertionError(f"concurrent greedy chats differ: {texts}")
    choices = [c["message"]["content"] for c in two["choices"]]
    if [c["index"] for c in two["choices"]] != [0, 1] or choices != texts[:1] * 2:
        raise AssertionError(f"n=2 chat: {two['choices']}")
    emit(dict(phase="batched_requests", transport="http",
              concurrent_ms=[ms for ms, _ in many], concurrent_wall_ms=wall,
              n2_ms=two_ms, content=texts[0], n2_usage=two["usage"]))


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
    k3_rows, k3_err = phase_paged_kernel()
    phase_model()
    engine, eng = phase_engine(card)
    phase_requests(engine)
    paged = phase_paged_engine(engine.model, engine.params, card)
    phase_batched_requests(engine.model, engine.params)

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
    k3 = k3_rows[True]  # per device step: one launch per layer
    summary.append(dict(
        name="K3 paged_attention (8B heads, 8 lanes x 2,048-token INT8 pages, "
             "per device step)",
        route="cuda", source="pie_tpu_torch/csrc/paged_attention.cu",
        replaces="pie_tpu/ops/paged_attention.py:510",
        launches=paged["launches"]["K3"], max_abs_err=k3_err,
        ms=LAYERS * k3["kernel_ms"], plain_ms=LAYERS * k3["plain_ms"],
        bound_ms=LAYERS * k3["bound_ms"], bound_by=k3["bound_by"],
        library_ms=LAYERS * k3["library_ms"],
    ))
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
