#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pie_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

0. device: the card's name and power limit (nvidia-smi); no CUDA -> error.
1. build: nvcc builds every kernel source under pie_tpu_torch/csrc (sm_90a),
   one process per source, all started together.
1b. kernels B7: the read probe (pie_tpu_torch/tools/hbm_peak.py, csrc/hbm_read.cu)
   on a 4 GiB buffer of integer-valued f32: its register-load and TMA-bulk
   paths equal to the plain version bit for bit, then the probe as its CLI
   runs it (launches counted): each path's best and median ms over 5 runs
   of 10 launches and its read rate beside the data sheet's 3.35 TB/s,
   torch.sum over the folded view (the library call) and a same-size
   copy_; a rate over the data sheet fails the run. The best path's rate
   re-reads every bytes bound below as bound_probe_ms.
2. kernels: K1 (decode GEMV) and K2 (prefill GEMM) against their plain
   PyTorch version at the Llama-3-8B INT4 g=64 shapes (normalized max
   error < 0.025), each timed over 8 rotating weight copies with CUDA
   events (device time from a captured CUDA graph, and back-to-back calls
   from the host), beside the plain version, a torch.matmul yardstick on a
   pre-dequantized bf16 weight, the least time the card could take and the
   achieved TFLOP/s: K1 for all five projections at M = 1, 2, 8 (the paged
   decode step), 9, 16 and 32, wo INT8 g64 and INT4 g32/g128 at M = 1
   and 8; K2 for all five at M = 512 (summed per 512-token prefill), wqkv
   and wo at M = 33, 64, 128, 129 and 2048, wo INT8 g64 and INT4 g32/g128
   at M = 512, and wqkv with the rope epilogue at M = 40 and 256; the host
   cost of K2's tensor maps. K1 and K2 again at the Llama-3.2-1B shapes:
   wqkv with ln + rope and the tied lm_head (f32 scales) at M = 1 and 8,
   every projection and the head at M = 512 (summed per prefill), wqkv
   with rope (dh 64) at M = 40. K1's ln pre-pass alone at M = 1, 8, 32
   (8B width) and 8 (1B) against its plain version (< 0.01). Then K4 (the
   fused decode MLP block) against its plain version (normalized max error
   < 0.02) at the 1B shapes (INT4 g64 at M = 1 and 8, INT8 g64 at M = 8)
   and, recorded only, the 8B shapes,
   timed beside the plain version, the port's unfused block and a
   torch.matmul chain on bf16 weights dequantized beforehand; each row
   carries K4's plan (resident blocks, ring stages, grid barriers, and
   tiles x K splits x stages per split of wo, wgu and wd). Then K3 (paged
   decode attention) against its plain version at the 8B heads (D 128) and
   the 1B heads (D 64), bf16 and INT8 pools, 8 lanes of contexts 1..2048,
   windows 0 and 256, layer 3 of a 4-layer pool (normalized max error
   < 2e-2), and timed at 8 lanes x 2,048 tokens (INT8 and bf16) over
   rotating layers beside the plain version and
   scaled_dot_product_attention on K/V gathered and dequantized beforehand;
   each timed row carries K3's launch (warps per block, cp.async stages
   per warp, resident blocks per SM, page splits, grid blocks, and the
   bf16 hi + lo rounding of the probabilities for PV). Then K5 (paged
   prefill attention over INT8 pages, D 128) at the served cells' chunks
   (pie_tpu_torch/tools/k5_bench.py's cases: 256 tokens at the Qwen2.5-VL-7B
   heads 28 / 4 over a 66-page table from positions 0, 1,792 and 3,840,
   at the Mistral-7B heads 32 / 8 over a 20-page table from 0) against its
   plain version (gathered_attention) on the same inputs, first and last
   layer (normalized max error < 1e-2), each timed per chunk (every
   layer, a captured graph) beside the plain version, SDPA on K/V
   gathered and dequantized beforehand and its bound.
3. model: a 1-layer model at the full 8B widths, same weights on the card
   (kernels) and on the CPU (plain versions): prefill 16 tokens, 4
   teacher-forced decode steps, then a 40-token chunk (so K2 runs too);
   then, over an INT8 paged pool, paged_forward (a 40-token prefill, 4
   decode steps) and mixed_forward (lanes plus a 40-token rider: K2 with
   rope; an empty rider; frozen lanes); logits agree to a normalized max
   error < 0.03, and K3 and K5 (the prefill and the riders' attention)
   ran.
4. engine: the 32-layer 8B geometry with random INT4 g=64 weights through
   InferenceEngine, whose decode steps replay CUDA graphs
   (pie_tpu_torch/engine/graphs.py): one counted request (64-token
   prompt, 128 decoded tokens: K1 runs 129 times per decoded token, its ln
   pre-pass 65 times, K2 129 times per prefill, counted under graph
   replay), TTFT p50 of a 512-token prompt beside one 512-token prefill's
   device time (CUDA events) and the host's time to queue it (the
   prefills replay CUDA graphs too), best-of-3 greedy decode tok/s;
   steady 16-step chunks: un-
   profiled wall ms per step, ms per step from CUDA events, aten calls per
   step and the idle share over a profiled chunk, one chunk queued under
   sync debug mode "error"; the graphs captured, their capture seconds
   and replays by kind (prefill, decode) and their pool's bytes.
5. requests: three requests over HTTP on localhost through the port's
   create_app (chat, chat SSE, completions with a logit_bias) on the 8B
   engine with an offline word-level tokenizer.
6. paged engine: the same 8B weights through PagedEngine + Scheduler
   (8 lanes, 112 INT8 pages, 12 pages per sequence, 8-step chunks, as
   bench.py's paged configuration): one counted run of 8 identical
   64-token prompts x 128 new tokens (identical greedy streams; K3 runs
   32 times per device step), aggregate decode tok/s best of 2, the
   device idle share over one steady chunk, TTFT p50 of 3 distinct
   512-token prompts admitted under 7 busy lanes (aten calls of one
   profiled admission; its direct prefill replays a graph), TTFT of a
   prefix-cache hit, and 8 lanes at 2,048-token contexts (34 pages per
   sequence, no
   prefix cache) as tok/s; steady 8-step chunks measured as in phase 4
   (one dispatched under sync debug mode "error") and the graphs' counts.
6b. graphs vs eager 8B (and 10b, 1B; 12, Gemma-3 4B): each captured
   prefill (single-stream prompts, replayed by a second prompt of the same
   buckets; masked extends at buckets 8 and 64; paged direct prefills)
   and step (single-stream decode, paged rider-free and mixed) against the
   same prefill or step run eagerly on the card by a twin engine: equal
   greedy tokens, every prefill's and step's logits within 1e-3
   normalized, the direct prefills' pools byte-equal.
7. batched requests: create_app over a BatchedInferenceEngine on the 8B
   weights answers 4 concurrent chats and one n=2 chat over HTTP.
3b. (run after 3) model 1B: a 2-layer model at the full Llama-3.2-1B widths
   (tied INT4 head, llama3 rope), card against CPU: __call__ (16-token
   prefill, 4 decode steps), paged_forward over an INT8 pool (8 lanes) and
   one mixed_forward step; normalized max error < 0.03, K4 exactly twice
   per decode step and never in a prefill or mixed step.
8. snapshot: the full 16-layer 1B model with random bf16 weights written as
   an HF snapshot (config.json with an INT4 g64 quantization block,
   model.safetensors, the word-level tokenizer's files) into a temporary
   directory.
9. serve: `MODEL_PATH=<snapshot> python -m pie_tpu_torch.server` as a
   subprocess: a chat, a streamed chat and a completion; then again with
   BATCHING=1 KV_QUANTIZED=1 NUM_LANES=8: 4 concurrent chats and one n=2
   chat; on each server a json_schema chat (phase 11d). Every request
   returns 200; startup and request times printed,
   the first request (which captures the prefill and step graphs) beside a
   second, on both servers.
11. constrained (run after 7, on the 8B engines; random weights, so logit
   biases toward '"', '}', ',' and ':' and against whitespace make the
   greedy JSON close soon, inside masks that keep every token valid):
   (a) engine.chat with a json_schema, a json_object, a named tool call and
   a reasoning request, each parsed and checked; ms per choice point of
   each chat; host ms per mask build; one masked extend per bucket (8-256
   tokens: ms of a replayed prefill graph, 129 K1 or K2 launches); a
   greedy request after them equal to a fresh engine's.
   (b) a json_schema chat and a named tool_choice chat over HTTP through
   create_app (200, parsed content / tool_calls). (c) the paged 8-lane
   INT8 engine with a json_schema lane and a tool-call lane beside 6 free
   greedy lanes, on graphs and on an eager twin (equal tokens, logits
   within 1e-3 normalized, the masked decode and mixed steps among them),
   the free lanes (each pinned to a word by a logit bias) equal to the
   same prompts alone, the outputs checked;
   speculation acceptance (accepted over speculated tokens), launches per
   masked chunk and step, a masked 8-step chunk against an unmasked one
   (CUDA events), the masked graphs and the pool's bytes. (d) runs in
   phase 9: a json_schema chat on each 1B server, parsed and checked.
10. 1B engines from the snapshot, in process: InferenceEngine(model_path=)
   (load time, quantized bytes, K4 16, K1 17 and its pre-pass 17 per
   decoded token, TTFT p50 at 512 tokens beside one prefill's device and
   enqueue time, best-of-3 decode tok/s, idle share) and
   BatchedInferenceEngine(model_path=, kv_quantized=True, num_lanes=8)
   through its scheduler in bench.py's paged configuration (aggregate
   tok/s best of 2, K4 16 per decode device step and none in mixed steps,
   TTFT under load); both with the steady-chunk measurements and graph
   counts of phases 4 and 6.

12. gemma3 (after 10; the 8B engines are freed first): (a) K3 at head_dim
   256 against its plain version (INT8 and bf16 pages; heads 8 / 4, 16 / 8
   and 4 / 1; windows 0 and 1,024; contexts 1..4,096; the walk split over
   blocks and not; per-lane normalized error < 2e-2), and timed per
   Gemma-3 4B device step at 8 lanes x 2,048 tokens (29 sliding layers
   clipped to 1,024 tokens, 5 global) beside the plain version, SDPA on
   gathered dequantized K/V and the bytes bound; (b) a 2-layer full-width
   4B model (1 sliding + 1 global) and a 2-layer 1B model (1 sliding + 1
   global, one KV head), card against CPU: the single-stream forward over
   the DualKVCache past the window, paged_forward and mixed_forward over
   an INT8 pool (normalized error < 0.03); (c) the 34-layer 4B
   single-stream engine (random INT4 g64): launches of one counted
   request (K1 238 per decoded token, K2 238 per prefill), TTFT p50 at 512
   tokens, best-of-3 decode tok/s, a 2,048-token prompt (two prefill
   chunks), one prefill's device and enqueue time at 512 and 2,048
   tokens, steady chunks, graphs; (e) one HTTP chat with a system message
   through create_app (a word-level tokenizer with Gemma's control tokens;
   the template folds the system text into the user turn); (d) the 4B
   paged engine (8 lanes, INT8 pages): one counted run (K3 34 per device
   step), tok/s at 64-token prompts and at 2,048-token contexts, steady
   chunks; then the 4B graphs against eager steps (phase_graphs, the
   single stream on a 1,100-token prompt past the window).

13. qwen2.5-vl (after 12): (a) K1 at M = 1 and 8 and K2 at M = 512 at every
   Qwen2.5-VL-7B projection shape (wq / wo 3584 x 3584, wk / wv 3584 x 512,
   wg / wu 3584 x 18944, wd 18944 x 3584, the untied head 3584 x 152064)
   against their plain version, timed with bound and library chain as in
   phase 2; K3 at its heads (28 / 4: a group of 7, D 128) against its plain
   version on INT8 and bf16 pages, timed at 8 lanes x 2,048 tokens; (b)
   card against CPU (normalized error < 0.03): a 4-layer full-width
   Qwen2.5-VL-7B with an 8-block tower (full attention at block 7) on one
   224 x 224 image prompt (its tower features, __call__ with the t/h/w
   streams, a decode step at the prompt's offset, a mixed step whose rider
   is the prompt's embeddings, a paged decode step), the mixed step's image
   lane against __call__ on the card, and the plain Qwen2-VL tower at 4
   blocks; (c) the 28-layer single-stream engine (random INT4 g64, a
   32-block bf16 tower): launches of a counted request (K1 197 per decoded
   token, K2 197 per prefill), TTFT p50 at 512 tokens, an image prompt's
   TTFT split (tower, prefill device and enqueue ms), decode tok/s after
   an image prompt, a captured image prefill and 16 decode steps against
   an eager twin (equal tokens, logits within 1e-3, caches byte-equal),
   steady chunks; (d) the paged engine (8 lanes, 2 of them image prompts,
   bf16 pages): tok/s, K3 28 per device step, each image lane's first token
   equal to the single stream's; (e) one image chat over HTTP through
   create_app on both backends (needs Pillow: else a line says "pillow":
   false). Images are seeded numpy pixels through the port's patchify
   step; the HTTP chat sends a PNG.

14. gemma3 vision (after 13): Gemma-3 4B image inputs at full width, the
   34-layer text model (random INT4 g64) under the 27-block SigLIP-So400m
   tower (random bf16; 896 x 896 images, 4,096 patches pooled to 256
   tokens): (a) card against CPU at 2 text layers (1 sliding + 1 global)
   and 2 tower blocks (normalized error < 0.03): one image's tower
   features and projected rows, the 276-token image prompt through
   __call__ over the DualKVCache and 2 decode steps, a mixed step whose
   rider is the prompt's embeddings (its lane against __call__ on the
   card) and a paged decode step over an INT8 pool; (b) the single-stream
   engine: the tower's ms per image (CUDA events) beside its bound (the
   shapes' operations at the bf16 peak, and at the f32 one it computes
   in), one counted image request (K1 238 per decoded token, K2 238 per
   prefill chunk), the image prompt's TTFT split (tower, prefill device
   and enqueue ms) for 276 tokens and for 1,300 (a 1,024-token head chunk
   and a tail, both with embeddings), decode tok/s after an image, and the
   captured image prefills (both prompts) and 16 decode steps against an
   eager twin (equal tokens, logits within 1e-3, caches byte-equal); (c)
   the paged engine (8 lanes, 2 of them image prompts, INT8 pages): tok/s,
   K3 34 per device step, each image lane's first token equal to the
   single stream's; (d) one image chat over HTTP through create_app
   (needs Pillow).

15. native scheduler: (a) g++ builds native/ (the C++ host runtime)
   into build/pie_tpu_torch/native-<hash>/ beside the nvcc builds: the
   compiler's version and the seconds; (b) (after 11, on the 8B weights)
   8 distinct 64-token prompts x 128 greedy tokens through
   BatchedInferenceEngine(scheduler_impl="native") (8 lanes, 112 INT8
   pages): aggregate tok/s best of 2, the counted run's launches (per
   decode step K1 129, its pre-pass 33, K3 32; per prefill K2 128 and the
   head's one K1 row), each lane's first token equal to the single
   stream's, the same prompts through the Python scheduler (tok/s, and
   how many tokens each stream shares with the native one); steady native
   steps (host ms, one decode step's device ms from CUDA events, 32
   profiled steps: aten calls per step and the idle share); the captured
   native prefill, first-token sample and decode step against an eager
   twin (equal tokens, logits within 1e-3, byte-equal pools); a 16-layer
   8B model check of the native decode step's logits against the CPU's
   plain path over the pool the card's native prefills wrote (normalized
   error < 0.03); (c) (after 10)
   `python -m pie_tpu_torch.runtime.engine_main --kv-quantized` on the 1B
   snapshot as a subprocess: start-to-ready seconds, an IpcFrontend's
   warm-up request, 4 concurrent greedy requests (ms per request) equal
   to an in-process native scheduler's, a fifth cancelled after two
   tokens, SIGTERM -> exit 0 with the shm segment unlinked, the process's
   K4 launches; (d) NATIVE_SCHEDULER=1 BATCHING=1 KV_QUANTIZED=1 serving
   the snapshot: 4 concurrent chats (200), a json_schema chat sampled at
   temperature 1 that parses to the schema, a logit_bias chat refused
   (400, the native scheduler's reason).

16. tensor and data parallelism (pie_tpu_torch/parallel/): (a) (after 15b,
   on the 8B weights) the paged engine (8 lanes, 112 INT8 pages, phase 6's
   prompt x 128 tokens) as rank 0 of a one-process NCCL mesh (tp = 1, dp
   = 1, through parallel.distributed.initialize and make_mesh): its steps
   replay CUDA graphs with the collectives captured inside; greedy tokens
   equal to the group-less engine's bit for bit; tok/s of both in turns
   (plain, mesh, mesh, plain); per steady step 65 all-reduces, one
   all-gather, K1 129, K3 32, no K4; aten calls a step and the idle share
   of both; graphs by kind. (b) (after 14) two processes on the one card
   as the tp = 2 ranks of the 8B at full width (32 layers, random INT4
   g64, wqkv split per q / k / v block, wo / wd row shards), joined by
   gloo, eager steps: rank 0's gathered logits for a 64-token prefill
   and 4 teacher-forced steps against tp = 1 on the card (normalized
   error < 0.03); the sharded paged engine (8 lanes, INT8 pages, 32
   tokens): per-rank launches (K1 on N 3,072 / 14,336 shards, K2, K3 at
   16 / 4 heads, no K4), tok/s, tokens shared with tp = 1 before the
   first difference; a capture over gloo refused. (c) K1 (M = 8) and K2
   (M = 512) at every distinct shard shape a rank runs of Llama-3-8B,
   Llama-3.2-1B and Gemma-3 4B at tp 2 and 8 (Gemma's KV heads replicated
   at 8) and Qwen2.5-VL-7B at tp 2 and 4 (INT4 g64; row shards re-padded
   to 512) against their plain version (< 0.025), kernel ms beside the
   bound of the logical (unpadded) product. (d) (after 15d, on the 1B snapshot) two `python -m
   pie_tpu_torch.server` processes (BATCHING=1) behind `python -m
   pie_tpu_torch.server.frontier`: the frontier's added ms per request
   against a direct call, 7 concurrent chats with one server SIGKILLed
   while they are in flight (all answer, on the survivor), then a streamed
   chat through the frontier.

Prints one JSON line per phase and one with each phase's seconds, the
summed rows (K2 per 8B and per 1B prefill, K1 per 8B and 1B paged decode
step and per 8B step at the other row counts, K4 per 1B paged decode
step), the 1B model check beside its reading before K2's single rounding
(after phase 3b), a Gemma-3 summary, a Gemma-3 vision summary, a prefill summary (TTFT beside one
prefill's device and enqueue time, the prefill graphs' captures, capture
seconds and the pool per geometry), a native-scheduler summary, then the kernel summary
line (K1, its ln pre-pass, K2-K4, K3 at D 256, K1 / K2 / K3 at Qwen2.5-VL-7B's
shapes, K5 per Qwen chunk at positions 0 and 3,840 and per Mistral chunk
at 0, B7's two paths; every bytes-bound row with bound_probe_ms beside
bound_ms, as on the summary lines) after a parallel summary (phase 16),
the card's name and power limit, and
as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from pie_tpu_torch.tools.hbm_peak import BF16_FLOP_PER_S, HBM_BYTES_PER_S

ROTATE = 8  # distinct weight copies per timing (the 50 MB L2 holds wqkv/wo)

# Llama-3-8B geometry (bench.py's llama3_8b_config)
D, DI, HQ, HKV, DH, VOCAB, LAYERS = 4096, 14336, 32, 8, 128, 128256, 32
# Llama-3.2-1B geometry (bench.py's llama32_1b_config): tied embeddings
D1, DI1, HQ1, HKV1, DH1, LAYERS1 = 2048, 8192, 32, 8, 64, 16
ROPE1 = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
         "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
EPS = 1e-5


def emit(obj) -> None:
    """Print one JSON line; with CHIP_SMOKE_LOG set, append it to that file
    too, so a long run's lines survive a console that keeps only the end."""
    import os

    line = json.dumps(obj)
    print(line, flush=True)
    if os.environ.get("CHIP_SMOKE_LOG"):
        with open(os.environ["CHIP_SMOKE_LOG"], "a") as f:
            f.write(line + "\n")


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


# -- compiled steps: graph stats, steady-step measurements, the eager twin -------


def eager_steps(graphs):
    """A step runner that calls every step eagerly on the card: the same
    engine's steps without capture, the reference the graphs are held
    against."""
    from pie_tpu_torch.engine.graphs import StepGraphs

    return StepGraphs(graphs.device, graphs.generator, graphs.collectives, eager=True)


class Tap:
    """A step runner that keeps a copy of every step's logits (a paged
    direct prefill returns none)."""

    def __init__(self, inner):
        self.inner, self.logits = inner, []

    def __call__(self, key, fn, samples=False):
        out = self.inner(key, fn, samples)
        if len(out) > 1:
            self.logits.append(out[1].float().clone())
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def sync_free(fn):
    """fn() with CUDA's sync debug mode set to raise: it must read nothing
    back from the card."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def event_ms(fn) -> float:
    """ms between CUDA events recorded around fn() on an idle card: the
    device's time for the work fn queues, plus any wait on the host."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def prefill_times(engine, prompt, reps=5):
    """One prefill of ``prompt`` from position 0 as the engine runs it (head
    chunks, then the tail's bucket), its graphs captured already: the
    median over ``reps`` of the host ms to queue it (uploads and replays,
    no read back) and of the ms between CUDA events recorded around it on
    an idle card (the device's time for the prefill, the host's where it
    is the slower side), and one profiled prefill (its top kernels, aten
    calls). TTFT's host clock adds the token's read back and the request's
    own host work. The prompt cache forgets the overwritten KV."""
    import numpy as np

    sampling, pen = engine._sampling({"temperature": 0.0}), engine._penalties({})

    def run():
        tail, first, _ = engine._prefill_head_chunks(list(prompt), 0, sampling, pen,
                                                     *engine._empty_bias, "greedy")
        ids = np.zeros((1, engine._prefill_bucket(len(tail))), np.int32)
        ids[0, :len(tail)] = tail
        engine.state, _, _ = engine.core._prefill(
            engine.params, engine.state, ids, engine._one(len(tail)), engine._one(first),
            sampling, pen, *engine._empty_bias, sampler_kind="greedy")

    run()
    host, dev = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        run()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    trace = profiled(run)
    if engine.prompt_cache is not None:
        engine.prompt_cache.update([])
    return dict(prefill_enqueue_ms=sorted(host)[reps // 2],
                prefill_event_ms=sorted(dev)[reps // 2], tokens=len(prompt),
                profiled=trace)


def steady_single(engine, steps=16, chunks=4):
    """Steady decode of the single-stream engine, chunk by chunk through
    ``EngineCore._decode`` on the engine's own state: un-profiled wall ms
    per step (dispatch and drain), device ms per step from CUDA events
    around one queued chunk, a profiled chunk (aten calls per step, idle
    share), and one chunk queued under sync debug mode "error"."""
    from pie_tpu_torch.engine.core import PenaltyParams
    from pie_tpu_torch.ops.sampling import SamplingParams

    core, dev = engine.core, engine.device
    engine.generate(list(range(1, 65)), max_completion_tokens=2, temperature=0.0)
    args = (SamplingParams.make(1, temperature=0.0, device=dev),
            PenaltyParams.make(1, device=dev), *engine._empty_bias,
            torch.full((8,), -1, dtype=torch.int32, device=dev))

    def chunk():
        return core._decode(engine.params, engine.state, *args, num_steps=steps,
                            sampler_kind="greedy", kv_bucket=core.max_seq_len,
                            use_penalties=False, use_bias=False)[1][0]

    chunk().cpu()  # the key's capture
    t0 = time.perf_counter()
    for _ in range(chunks):
        chunk().cpu()
    wall = (time.perf_counter() - t0) / (chunks * steps) * 1e3
    ev = event_ms(chunk) / steps
    trace = profiled(lambda: chunk().cpu())
    trace["aten_calls_per_step"] = trace["aten_calls"] / steps
    sync_free(chunk).cpu()
    return dict(wall_ms_per_step=wall, event_ms_per_step=ev, sync_debug="no sync",
                profiled_chunk=trace)


def steady_paged(sched, prompt, lanes, chunks=4):
    """Steady decode of the scheduler (every lane decoding): un-profiled
    wall ms per device step over ``chunks`` chunks (dispatch and drain),
    device ms per step from CUDA events around one queued chunk, one chunk
    dispatched under sync debug mode "error", and a profiled chunk (aten
    calls per step, idle share)."""
    from pie_tpu_torch.engine.scheduler import SeqStatus

    engine = sched.engine
    seqs = [sched.add_request(prompt, max_new_tokens=128, temperature=0.0)
            for _ in range(lanes)]
    while sched.waiting or any(s.status != SeqStatus.DECODING for s in seqs):
        sched.step()
    sched.step()
    torch.cuda.synchronize()
    steps0, t0 = engine.device_steps, time.perf_counter()
    for _ in range(chunks):
        sched.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / (engine.device_steps - steps0) * 1e3
    ev = event_ms(sched._fill_pipeline) / sched.decode_steps
    sched.step()  # drains it
    sync_free(sched._fill_pipeline)
    sched.step()
    steps0 = engine.device_steps
    trace = profiled(sched.step)
    trace["device_steps"] = engine.device_steps - steps0
    trace["aten_calls_per_step"] = trace["aten_calls"] / trace["device_steps"]
    sched.run_to_completion()
    return dict(wall_ms_per_step=wall, event_ms_per_step=ev, sync_debug="no sync",
                profiled_chunk=trace)


def masked_prefills(engine, first, seed=0):
    """Masked prefills on the engine's own state, as a constrained request's
    extends: 5 and 3 tokens (bucket 8), then 40 and 20 (bucket 64), from
    ``first`` on, each under a random mask; the tokens they sample."""
    import numpy as np

    v = engine.model.config.vocab_size
    rng = np.random.default_rng(seed)
    args = (engine._sampling({"temperature": 0.0}), engine._penalties({}),
            *engine._empty_bias)
    tokens = []
    for n, bucket in ((5, 8), (3, 8), (40, 64), (20, 64)):
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = rng.integers(1, min(v, 100000), n)
        engine.state, tok, _ = engine.core._prefill(
            engine.params, engine.state, ids, engine._one(n), engine._one(first),
            *args, allowed_mask=rng.uniform(size=(1, v)) < 0.5, sampler_kind="greedy")
        tokens.append(int(tok[0]))
        first += n
    return tokens


def paged_prefill_pools(model, params):
    """Two direct prefill chunks of one bucket (128: 100 tokens from
    position 0, then 70 from position 40 on another block table) on a
    paged engine whose prefill replays its graph and on a twin that runs it
    eagerly (8 lanes, 112 INT8 pages); whether the two pools are byte-equal
    after each chunk."""
    import numpy as np

    from pie_tpu_torch.engine.scheduler import PagedEngine

    engines = [PagedEngine(model, params, num_lanes=8, num_pages=112,
                           max_pages_per_seq=12, kv_quantized=True) for _ in range(2)]
    engines[1].graphs = eager_steps(engines[1].graphs)
    equal = []
    for table, first, n in (([3, 7], 0, 100), ([12, 0, 5], 40, 70)):
        ids = np.zeros((1, 128), np.int32)
        pos = np.full((1, 128), -1, np.int32)
        ids[0, :n] = [1 + (i * 31 + first) % (model.config.vocab_size - 1)
                      for i in range(n)]
        pos[0, :n] = first + np.arange(n)
        bt = np.full((1, 12), -1, np.int32)
        bt[0, :len(table)] = table
        for e in engines:
            e._prefill(e.params, ids, pos, bt, np.array([first + n], np.int32))
        pools = [[t for t in (e.pool.k, e.pool.v, e.pool.k_scale, e.pool.v_scale)
                  if t is not None] for e in engines]
        equal.append(all(torch.equal(a, b) for a, b in zip(*pools)))
    replays = engines[0].graphs.replays
    del engines
    return equal, replays


def phase_graphs(model, params, label, prompt=tuple(range(1, 65)), max_seq_len=512):
    """Each captured step held against the same step run eagerly on the
    card, on one model: two single-stream engines (one whose prefills and
    steps replay graphs, one whose prefills and steps run eagerly) decode
    the same two greedy requests (``prompt``, Gemma-3's past its sliding
    window, then another prompt three tokens shorter, whose prefills replay
    the first's graphs) and run the same masked prefills (constrained
    extends at buckets 8 and 64, each bucket twice); two schedulers (8
    lanes, INT8 pages) the same mix of a direct prefill, rider prompts, a
    wake-only prompt and steady decode; and two direct prefills of one
    bucket on a paged engine and its eager twin. Tokens must be equal,
    every prefill's and step's logits within 1e-3 normalized, the direct
    prefills' pools byte-equal; the graphs must have replayed the prefills,
    the single-stream step and both paged steps."""
    import gc

    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler

    def norm_err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    row = dict(phase="graphs vs eager", geometry=label)
    engines = [InferenceEngine(model=model, params=params, max_seq_len=max_seq_len,
                               decode_chunk=16, prompt_cache=False) for _ in range(2)]
    engines[1].core.graphs = eager_steps(engines[1].core.graphs)
    for e in engines:
        e.core.graphs = Tap(e.core.graphs)
    second = [1 + (t * 7) % (model.config.vocab_size - 1) for t in prompt[3:]]
    outs = [[e.generate(p, max_completion_tokens=40, temperature=0.0).token_ids
             for p in (list(prompt), second)] for e in engines]
    masked = [masked_prefills(e, len(prompt) + 50) for e in engines]
    taps = [e.core.graphs for e in engines]
    errs = [norm_err(a, b) for a, b in zip(taps[0].logits, taps[1].logits)]
    stats = taps[0].inner.stats()
    pre = stats["by_kind"].get("prefill", {})
    row["single"] = dict(tokens_equal=outs[0] == outs[1], masked_equal=masked[0] == masked[1],
                         steps=len(errs), max_norm_err=max(errs), graphs=stats)
    if not (outs[0] == outs[1] and masked[0] == masked[1] and max(errs) < 1e-3
            and len(taps[0].logits) == len(taps[1].logits)
            and pre.get("replays", 0) >= 3 and stats["by_kind"]["decode"]["replays"] > 0):
        raise AssertionError(f"single-stream graphs against eager prefills and steps: {row}")
    del engines, taps
    scheds = [Scheduler(PagedEngine(model, params, num_lanes=8, num_pages=112,
                                    max_pages_per_seq=12, kv_quantized=True),
                        decode_steps=8) for _ in range(2)]
    scheds[1].engine.graphs = eager_steps(scheds[1].engine.graphs)
    prompts = [list(range(1, 101)), [5, 6, 7], list(range(40, 60)), [9],
               list(range(200, 264)), [11, 12]]
    streams = []
    for sc in scheds:
        sc.engine.graphs = Tap(sc.engine.graphs)
        seqs = [sc.add_request(p, max_new_tokens=24, temperature=0.0) for p in prompts]
        sc.run_to_completion()
        streams.append([q.output_ids for q in seqs])
    taps = [sc.engine.graphs for sc in scheds]
    errs = [norm_err(a, b) for a, b in zip(taps[0].logits, taps[1].logits)]
    kinds = sorted({k[0] for k in taps[0].inner.keys})
    pools_equal, pool_replays = paged_prefill_pools(model, params)
    row["paged"] = dict(tokens_equal=streams[0] == streams[1], steps=len(errs),
                        max_norm_err=max(errs), steps_run=kinds,
                        prefill_pools_equal=pools_equal, graphs=taps[0].inner.stats())
    if not (row["paged"]["tokens_equal"] and max(errs) < 1e-3
            and kinds == ["decode", "mixed", "prefill"] and taps[0].inner.replays > 0
            and all(pools_equal) and pool_replays == 1):
        raise AssertionError(f"paged graphs against eager steps: {row}")
    emit(row)
    del scheds, taps
    gc.collect()
    torch.cuda.empty_cache()
    return row


# -- phase 2 -------------------------------------------------------------------


def random_qt(k, n, bits, g, copies, gen, scale_dtype=torch.bfloat16):
    """Stacked random quantized weights [copies, K, N] on the card."""
    from pie_tpu_torch.ops.quant import QuantizedTensor

    ep = 32 // bits
    packed = torch.randint(-(2**31), 2**31, (copies, k // ep, n), generator=gen,
                           dtype=torch.int32, device="cuda")
    sc = 0.02 / k**0.5
    scales = (torch.rand((copies, k // g, n), generator=gen, device="cuda") + 0.5) * sc
    biases = -scales * (2**bits - 1) / 2
    return QuantizedTensor(packed=packed, scales=scales.to(scale_dtype),
                           biases=biases.to(scale_dtype), bits=bits, group_size=g,
                           shape=(k, n))


def kernel_case(name, k, n, m, bits=4, g=64, ln=False, rope=False, seed=0,
                heads=(HQ, HKV, DH), scale_dtype=torch.bfloat16):
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.ops.quant import dequantize
    from pie_tpu_torch.ops.rope import make_inv_freq, rope_qkv_cs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qt = random_qt(k, n, bits, g, ROTATE, gen, scale_dtype)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    kw = {}
    if ln:
        kw.update(ln_w=(1 + 0.1 * torch.randn((ROTATE, k), generator=gen,
                                              device="cuda")).bfloat16(),
                  ln_eps=1e-5)
    if rope:
        hq, hkv, dh = heads
        inv = torch.from_numpy(make_inv_freq(dh, 500000.0)).cuda()
        pos = torch.arange(m, dtype=torch.int32, device="cuda") + 100
        kw.update(rope_cs=rope_qkv_cs(pos, inv, hq, hkv, dh), rope_dim=dh)
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
    nbytes = (k // ep * n * 4 + 2 * (k // g) * n * qt.scales.element_size()
              + m * k * 2 + m * n * 2
              + (k * 2 if ln else 0) + (2 * m * n * 4 if rope else 0))
    flops = 2 * m * k * n
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    row = dict(
        phase="kernels", case=name, kernel="K1" if m <= qmc.DECODE_MAX_M else "K2",
        m=m, k=k, n=n, bits=bits, group_size=g, ln=ln, rope=rope,
        scales=str(qt.scales.dtype).replace("torch.", ""),
        max_abs_err=diff, norm_err=norm, kernel_ms=ms, kernel_host_ms=host_ms,
        plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(bound_bytes, bound_ops),
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        bytes=nbytes, flops=flops, tflop_s=flops / ms / 1e9,
    )
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if m > qmc.DECODE_MAX_M:
        plan = qmc.gemm_plan(m, n, qt.padded_k, g, kw.get("rope_dim", 0), sms=sms)
        row.update(k2_grid=[plan.m_tiles, plan.n_tiles, plan.splits],
                   k2_steps_per_split=plan.steps_per_split)
    else:
        plan = qmc.gemv_plan(m, n, qt.padded_k, g, kw.get("rope_dim", 0), sms=sms)
        row.update(k1_grid=[plan.n_tiles, plan.splits],
                   k1_stages_per_split=plan.stages_per_split)
    emit(row)
    return row


def ln_prepass_case(m, k, seed=0):
    """K1's rms-norm pre-pass alone (gemv_ln_rows) against the plain
    version's normalized rows (normalized max error < 0.01: one bf16
    rounding of the same f32 arithmetic), timed beside it,
    torch.nn.functional.rms_norm on the bf16 rows (yardstick only) and the
    least time (read x and the ln row, write the normalized rows)."""
    import torch.nn.functional as F

    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qt = random_qt(k, 128, 4, 64, 1, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    lnw = (1 + 0.1 * torch.randn((ROTATE, k), generator=gen, device="cuda")).bfloat16()

    def plain(i):
        xf = x.float()
        inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + EPS)
        return (xf * inv * lnw[i % ROTATE].float()).bfloat16()

    got = qmc.gemv_ln_rows(x, qt, ln_w=lnw[0], ln_eps=EPS)
    want = plain(0)
    torch.cuda.synchronize()
    diff = (got[:, :k].float() - want.float()).abs().max().item()
    norm = diff / want.float().abs().max().item()
    if not (norm < 0.01 and got.shape == (m, qt.padded_k)):
        raise AssertionError(f"K1 ln pre-pass vs plain normalized err {norm}")
    ms = device_ms(lambda i: qmc.gemv_ln_rows(x, qt, ln_w=lnw[i % ROTATE], ln_eps=EPS))
    plain_ms = cuda_ms(plain, 20)
    library_ms = device_ms(lambda i: F.rms_norm(x, (k,), lnw[i % ROTATE], EPS))
    nbytes = 2 * m * k + 2 * k + 2 * m * qt.padded_k
    row = dict(phase="kernels", case=f"K1 ln pre-pass M={m} K={k}", kernel="K1 ln", m=m,
               k=k, max_abs_err=diff, norm_err=norm, kernel_ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               bound_by="bytes", bytes=nbytes)
    emit(row)
    return row


def phase_hbm_probe(card):
    """B7, the read probe (pie_tpu_torch/tools/hbm_peak.py): both paths of
    csrc/hbm_read.cu against the plain version on a 4 GiB buffer of
    integer-valued f32 (every fold exact, so they must agree bit for bit),
    then the probe as its CLI runs it, its launches counted: each path's
    best and median ms over 5 runs and read rate beside the data sheet's
    3.35 TB/s, the plain version's, torch.sum's over the folded view and a
    same-size copy_'s. read_rate raises on a rate over the data sheet."""
    from pie_tpu_torch.tools import hbm_peak as hp

    x = hp.make_buffer(4)
    want = hp.stream_read_plain(x)
    check_err = {}
    for path in hp.PATHS:
        got = hp.stream_read(x, path)
        check_err[path] = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"B7 {path} differs from the plain version: "
                                 f"max abs err {check_err[path]}")
    del want, got
    hp.reset_counts()
    res = hp.measure(x)
    launches = dict(hp.launch_counts)
    for path in hp.PATHS:
        if launches[f"B7 {path}"] < 1 or res[path]["max_abs_err"] != 0:
            raise AssertionError(f"B7 {path}: launches {launches}, "
                                 f"max abs err {res[path]['max_abs_err']}")
    emit(dict(phase="kernels B7", card=card, launches=launches, check_err=check_err,
              **{k: res[k] for k in ("bytes", "shape", "bound_ms", "bound_by", *hp.PATHS,
                                     "plain", "library", "copy", "probe_bytes_per_s")}))
    del x
    torch.cuda.empty_cache()
    return dict(res, launches=launches, check_err=check_err)


def probe_ms(bound_ms: float, probe) -> float:
    """A bytes bound re-read at the probe's best measured read rate (phase
    B7) in place of the data sheet's."""
    return bound_ms * HBM_BYTES_PER_S / probe["probe_bytes_per_s"]


def with_probe(row: dict, probe) -> dict:
    """row (bound_ms, bound_by) with bound_probe_ms where bytes bound it."""
    if row["bound_by"] == "bytes":
        row["bound_probe_ms"] = probe_ms(row["bound_ms"], probe)
    return row


def summed_bound(per_rows, probe) -> dict:
    """bound_ms and bound_by of rows summed with their launch counts, and
    bound_probe_ms where bytes bound the sum."""
    bb = sum(per * r["bytes"] for per, r in per_rows) / HBM_BYTES_PER_S * 1e3
    bo = sum(per * r["flops"] for per, r in per_rows) / BF16_FLOP_PER_S * 1e3
    return with_probe(dict(bound_ms=max(bb, bo),
                           bound_by="bytes" if bb >= bo else "operations"), probe)


def phase_ln_prepass():
    """The pre-pass at the 8B width for 1, 8 and 32 rows, and the 1B width
    at 8."""
    return {(m, k): ln_prepass_case(m, k) for m, k in ((1, D), (8, D), (32, D), (8, D1))}


# K1's rows: one token, and decode steps of 2-32 lanes
K1_ROWS = (1, 2, 8, 9, 16, 32)
# per decoded token: four projections per layer plus lm_head
MAIN_SHAPES = [  # name, K, N, per-token launches, ln, rope
    ("wqkv", D, (HQ + 2 * HKV) * DH, LAYERS, True, True),
    ("wo", HQ * DH, D, LAYERS, False, False),
    ("wgu", D, 2 * DI, LAYERS, True, False),
    ("wd", DI, D, LAYERS, False, False),
    ("lm_head", D, VOCAB, 1, True, False),
]


def phase_kernels():
    """K1 and K2 at the 8B shapes. Rows "K1" (M = 1) and "K2" (M = 512) are
    the per-token and per-prefill sums; "K1 M=8" is the paged decode step's
    K1 cost (8 lanes), "K1 M=m" the same step at other lane counts (M = 2
    and 9 fill an n8 tile of K1's tensor-core product partly)."""
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    rows = {"K2": []}
    for m in K1_ROWS:
        rows[f"K1 M={m}"] = [(per, kernel_case(f"{name} M={m}", k, n, m, ln=ln, rope=rope))
                             for name, k, n, per, ln, rope in MAIN_SHAPES]
    rows["K1"] = rows["K1 M=1"]
    for bits, g in ((8, 64), (4, 32), (4, 128)):
        for m in (1, 8):
            kernel_case(f"wo M={m} int{bits} g{g}", HQ * DH, D, m, bits=bits, g=g)
    for name, k, n, per, _, _ in MAIN_SHAPES:
        rows["K2"].append((per, kernel_case(f"{name} M=512", k, n, 512)))
    # K2 across M: below one wave of output tiles (split K), at its edges
    # (M = 128, 129) and above one 512-token chunk
    for m in (33, 64, 128, 129, 2048):
        kernel_case(f"wqkv M={m}", D, (HQ + 2 * HKV) * DH, m)
        kernel_case(f"wo M={m}", HQ * DH, D, m)
    for bits, g in ((8, 64), (4, 32), (4, 128)):
        kernel_case(f"wo M=512 int{bits} g{g}", HQ * DH, D, 512, bits=bits, g=g)
    # the mixed step's QKV projection: K2 with the rope epilogue at
    # M = lanes + rider (8 + 248 in the paged engine)
    for m in (40, 256):
        kernel_case(f"wqkv M={m} (rope)", D, (HQ + 2 * HKV) * DH, m, rope=True)
    # host cost of K2's four TMA tensor maps per call
    x = torch.randn((512, D), device="cuda").bfloat16()
    gen = torch.Generator(device="cuda").manual_seed(0)
    qt = random_qt(D, (HQ + 2 * HKV) * DH, 4, 64, 1, gen)
    emit(dict(phase="kernels", case="K2 tensor-map encoding, host ns per call",
              encode_ns=qmc.gemm_encode_ns(x, qt, layer=0)))
    del x, qt
    torch.cuda.empty_cache()
    return rows


# per decoded token at 1B: K1 for wqkv per layer and the tied lm_head (its
# scales f32: quantized from the f32 transpose of the embedding, as the JAX
# package does); the rest of each layer is K4
MAIN_SHAPES_1B = [  # name, K, N, per-token launches, ln, rope, scale dtype
    ("wqkv", D1, (HQ1 + 2 * HKV1) * DH1, LAYERS1, True, True, torch.bfloat16),
    ("lm_head", D1, VOCAB, 1, True, False, torch.float32),
]
# per 512-token prefill at 1B: K2 for every projection of every layer and
# the tied head over all 512 rows (as the JAX package's __call__ does)
PREFILL_SHAPES_1B = [  # name, K, N, launches per prefill, scale dtype
    ("wqkv", D1, (HQ1 + 2 * HKV1) * DH1, LAYERS1, torch.bfloat16),
    ("wo", HQ1 * DH1, D1, LAYERS1, torch.bfloat16),
    ("wgu", D1, 2 * DI1, LAYERS1, torch.bfloat16),
    ("wd", DI1, D1, LAYERS1, torch.bfloat16),
    ("lm_head", D1, VOCAB, 1, torch.float32),
]


def phase_kernels_1b():
    """K1 and K2 at the Llama-3.2-1B shapes: the per-token K1 launches at
    M = 1 ("K1") and at M = 8 (the paged decode step, "K1 M=8"), every
    projection of a 512-token prefill ("K2"), and the
    mixed step's QKV projection with rope (dh 64) at M = 40."""
    heads = (HQ1, HKV1, DH1)
    rows = {f"K1 M={m}": [(per, kernel_case(f"1B {name} M={m}", k, n, m, ln=ln, rope=rope,
                                            heads=heads, scale_dtype=sd))
                          for name, k, n, per, ln, rope, sd in MAIN_SHAPES_1B]
            for m in (1, 8)}
    rows["K1"] = rows["K1 M=1"]
    rows["K2"] = [(per, kernel_case(f"1B {name} M=512" + (" (f32 scales)" if sd ==
                                                          torch.float32 else ""),
                                    k, n, 512, scale_dtype=sd))
                  for name, k, n, per, sd in PREFILL_SHAPES_1B]
    kernel_case("1B wqkv M=40 (rope)", D1, (HQ1 + 2 * HKV1) * DH1, 40, rope=True,
                heads=heads)
    torch.cuda.empty_cache()
    return rows


# -- phase 2, K4 ---------------------------------------------------------------


def fused_case(name, d, di, m, bits=4, g=64, seed=0):
    """K4 against its plain version on the same card inputs (normalized max
    error < 0.02), then its device time over 8 rotating weight copies beside
    the plain version, the port's unfused block (three K1 launches and the
    glue), a torch.matmul chain on bf16 weights dequantized beforehand with
    the same glue (yardstick only), and the least time the card could take."""
    import torch.nn.functional as F

    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, rms_norm
    from pie_tpu_torch.ops import fused_mlp as fm
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.ops.quant import dequantize

    gen = torch.Generator(device="cuda").manual_seed(seed)
    wo, wgu, wd = (random_qt(k, n, bits, g, ROTATE, gen)
                   for k, n in ((d, d), (d, 2 * di), (di, d)))
    ln2 = (1 + 0.1 * torch.randn((ROTATE, d), generator=gen, device="cuda")).bfloat16()
    attn = torch.randn((m, d), generator=gen, device="cuda").bfloat16()
    h = torch.randn((m, d), generator=gen, device="cuda").bfloat16()
    got = fm.fused_mlp_stacked(attn, h, ln2, 0, wo, wgu, wd, EPS)
    want = fm.fused_mlp_ref(attn, h, ln2, 0, wo, wgu, wd, EPS)
    torch.cuda.synchronize()
    if not (got.dtype == torch.bfloat16 and got.shape == (m, d)
            and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: K4 output {got.dtype} {tuple(got.shape)}")
    diff = (got.float() - want.float()).abs().max().item()
    norm = diff / want.float().abs().max().item()
    if not norm < 0.02:
        raise AssertionError(f"{name}: K4 vs plain normalized err {norm}")

    kern = lambda i: fm.fused_mlp_stacked(attn, h, ln2, i % ROTATE, wo, wgu, wd, EPS)
    ms = device_ms(kern)  # the cooperative launch captures into a graph
    host_ms = cuda_ms(kern, 50)
    plain_ms = cuda_ms(lambda i: fm.fused_mlp_ref(attn, h, ln2, i % ROTATE, wo, wgu,
                                                  wd, EPS), 3, warmup=1)
    model = LlamaModel(LlamaConfig(hidden_size=d, intermediate_size=di,
                                   num_hidden_layers=ROTATE))
    p = {"wo": wo, "wgu": wgu, "wd": wd, "ln2": ln2}
    unfused_ms = device_ms(lambda i: model._mlp_block(
        p, h[:, None], attn[:, None], i % ROTATE, EPS, False, fused_ln=True))
    dense = [tuple(dequantize(w.layer(i), torch.bfloat16) for w in (wo, wgu, wd))
             for i in range(ROTATE)]

    def library(i):
        dwo, dwgu, dwd = dense[i % ROTATE]
        h2 = h + attn @ dwo
        gu = rms_norm(h2, ln2[i % ROTATE], EPS) @ dwgu
        return h2 + (F.silu(gu[:, :di]) * gu[:, di:]) @ dwd

    library_ms = device_ms(library)
    del dense
    ep = 32 // bits
    wbytes = sum(k // ep * n * 4 + 2 * (k // g) * n * 2
                 for k, n in ((d, d), (d, 2 * di), (di, d)))
    nbytes = wbytes + 3 * m * d * 2 + d * 2  # attn, h in, out; the ln2 row
    flops = 2 * m * (d * d + d * 2 * di + di * d)
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    plan = fm.mlp_plan(m, d, d, di, bits, g, sms=qmc._device_sms(attn.device),
                       blocks_per_sm=fm._blocks_per_sm(attn.device, bits, g, 0, d))
    row = dict(
        phase="kernels", case=name, kernel="K4", m=m, d=d, di=di, bits=bits,
        group_size=g, plan=plan.summary(), max_abs_err=diff, norm_err=norm, kernel_ms=ms,
        kernel_host_ms=host_ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
        library_ms=library_ms, bound_ms=max(bound_bytes, bound_ops),
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        bytes=nbytes, weight_bytes=wbytes, flops=flops,
    )
    emit(row)
    torch.cuda.empty_cache()
    return row


def phase_fused_mlp():
    """K4 at the 1B shapes (INT4 g64 at M = 1 and 8, INT8 g64 at M = 8) and,
    recorded only, the 8B shapes at M = 1 and 8 (the model's gate keeps K4
    off above hidden 2048)."""
    rows = {(4, 1): fused_case("1B mlp block M=1", D1, DI1, 1),
            (4, 8): fused_case("1B mlp block M=8", D1, DI1, 8),
            (8, 8): fused_case("1B mlp block M=8 int8 g64", D1, DI1, 8, bits=8)}
    for m in (1, 8):
        fused_case(f"8B mlp block M={m} (recorded only)", D, DI, m)
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


def paged_timing(quantized, heads=(HQ, HKV, DH)):
    """K3 at 8 lanes x 2,048 tokens (8B heads, or the 1B's D 64): device time
    over rotating layers, host time, the plain version, SDPA on K/V gathered
    and dequantized beforehand (yardstick only), and the bound."""
    import torch.nn.functional as F

    from pie_tpu_torch.cache.paged import PagedKVPool, gather_kv
    from pie_tpu_torch.ops import paged_attention as pa

    hq, hkv, dh = heads
    inputs = paged_inputs((2048,) * 8, hq, hkv, dh, quantized, seed=1)
    q, k, v, ks, vs, tables, ctx = inputs
    scale = dh ** -0.5
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
    flops = 4 * int(ctx.sum().item()) * hq * dh  # q.k and p.v per token and head
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / BF16_FLOP_PER_S * 1e3
    diff, norm = paged_check(inputs, 3, 0)
    row = dict(
        phase="kernels", case=f"paged attention 8x2048 {'int8' if quantized else 'bf16'}"
                              f" D {dh}",
        kernel="K3", lanes=8, context=2048, hq=hq, hkv=hkv, head_dim=dh,
        quantized=quantized,
        **pa.launch_plan(q.device, 8, hq, hkv, dh, tables.shape[1], quantized),
        max_abs_err=diff, norm_err=norm, kernel_ms=ms, kernel_host_ms=host_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bound_bytes, bound_ops),
        bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        bytes=nbytes, walked_page_heads=pages * hkv, flops=flops,
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
    rows["1B"] = paged_timing(True, heads=(HQ1, HKV1, DH1))  # the 1B paged step's K3
    return rows, max([worst] + [r["max_abs_err"] for r in rows.values()])


# -- phase 2, K5 ---------------------------------------------------------------


def phase_prefill_kernel(card, probe):
    """K5 at the served cells' prefill chunks (tools/k5_bench.py's cases: a
    256-token chunk at the Qwen2.5-VL-7B heads 28 / 4 over a 66-page table
    from positions 0, 1,792 and 3,840, at the Mistral-7B heads 32 / 8 over
    a 20-page table from 0) against its plain version (gathered_attention
    under the chunk's mask) on the same card inputs, at the first and last
    layer: within 1e-2 of the largest output (both round P and their output
    to bf16 once, P before the division by the sum in K5 and after it in
    the plain version). Then per chunk, every layer's call: K5's device ms
    beside the plain version's, SDPA's on K/V gathered and dequantized
    beforehand (yardstick only) and the bound (k5_bench.work)."""
    from pie_tpu_torch.models.llama import _paged_kv_positions, gathered_attention
    from pie_tpu_torch.ops import prefill_attention as k5
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.ops.attention import attention_mask
    from pie_tpu_torch.tools import k5_bench

    dev = torch.device("cuda", torch.cuda.current_device())
    scale = k5_bench.D ** -0.5
    rows, worst = {}, 0.0
    for name, (hq, hkv, layers, maxp, first, tokens) in k5_bench.CASES.items():
        q, pool, table, pos, ctx = k5_bench.inputs(dev, hq, hkv, layers, maxp, first,
                                                   tokens)
        mask = attention_mask(pos, _paged_kv_positions(table, ctx))
        qmc.reset_counts()
        diff = norm = 0.0
        for layer in (0, layers - 1):
            got = k5.prefill_attention_cuda(q, pool, layer, table, pos, ctx, scale)
            want = gathered_attention(pool, layer, table, q, mask, scale).float()
            if not (got.dtype == torch.bfloat16 and got.shape == want.shape
                    and torch.isfinite(got).all()):
                raise AssertionError(f"K5 output {got.dtype} {tuple(got.shape)}")
            err = (got.float() - want).abs().max().item()
            diff, norm = max(diff, err), max(norm, err / want.abs().max().item())
        if not (norm < 1e-2 and qmc.launch_counts["K5"] == 2):
            raise AssertionError(f"K5 vs plain, {name}: normalized err {norm}, "
                                 f"launches {qmc.launch_counts['K5']}")
        del q, pool, table, pos, ctx, mask, got, want
        torch.cuda.empty_cache()
        t = k5_bench.run_case(name, card, probe["probe_bytes_per_s"])
        bytes_bound, ops_bound = t["bytes_bound_ms"], t["ops_bound_ms"]
        rows[name] = row = dict(
            phase="kernels", case=f"prefill attention {name}", kernel="K5", hq=hq,
            hkv=hkv, layers=layers, table_pages=maxp, first=first, tokens=tokens,
            plan=t["plan"], geometry=t["geometry"], max_abs_err=diff, norm_err=norm,
            kernel_ms=t["k5_ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
            bound_ms=max(bytes_bound, ops_bound),
            bound_by="bytes" if bytes_bound >= ops_bound else "operations",
            bytes=t["bytes"], flops=t["ops"], share_of_bound_pct=t["k5_share_of_bound_pct"])
        emit(with_probe(row, probe))
        worst = max(worst, diff)
        torch.cuda.empty_cache()
    return rows, worst


# -- phase 3 -------------------------------------------------------------------


# the 8B card-against-CPU check's depth: one layer keeps its CPU side short;
# stacked-layer offsets are checked at depth by phases 3b, 12b and 13b
CHECK_LAYERS_8B = 1


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

    model = LlamaModel(llama8b_config(CHECK_LAYERS_8B))
    cpu_params = model.init_quantized_params(seed=1, device="cpu")
    gpu_params = to_device(cpu_params, "cuda")
    ids = torch.randint(0, VOCAB, (1, 60), generator=torch.Generator().manual_seed(2))
    worst = 0.0
    qmc.reset_counts()
    caches = {d: make_kv_cache(CHECK_LAYERS_8B, 1, 64, HKV, DH, dtype=torch.bfloat16,
                               device=d)
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
    emit(dict(phase="model", layers=CHECK_LAYERS_8B, widths="llama3-8b", norm_err=worst,
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
    pools = {d: PagedKVPool.create(CHECK_LAYERS_8B, 12, HKV, DH, torch.bfloat16, True,
                                   device=d)
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
            t(pp, d), t([lane], d), t([pctx], d), pf_any=bool((pi >= 0).any()))[0],
            torch.from_numpy(np.asarray(dp) >= 0)))
    counts = dict(qmc.launch_counts)
    if not (counts["K1"] > 0 and counts["K2"] > 0 and counts["K3"] > 0
            and counts["K5"] > 0):
        raise AssertionError(f"paged model check did not run every kernel: {counts}")
    emit(dict(phase="model", path="paged_forward + mixed_forward", layers=CHECK_LAYERS_8B,
              widths="llama3-8b", kv="int8 paged", norm_err=max(errs),
              norm_err_per_step=errs, launches=counts))


def llama1b_config(layers):
    from pie_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        model_type="llama", hidden_size=D1, intermediate_size=DI1,
        num_hidden_layers=layers, num_attention_heads=HQ1,
        num_key_value_heads=HKV1, head_dim=DH1, vocab_size=VOCAB,
        rope_theta=500000.0, rope_scaling=ROPE1, tie_word_embeddings=True,
    )


def phase_model_1b():
    """A 2-layer model at the full 1B widths (tied INT4 g64 head quantized
    from the embedding, llama3 rope), card against the CPU plain path:
    __call__ (16-token prefill, 4 decode steps), paged_forward over an INT8
    pool (8 lanes: a padded prefill chunk, 4 decode steps) and one
    mixed_forward step (8 lanes + a 16-token rider). K4 runs twice per
    decode step and never in a prefill or mixed step."""
    import numpy as np

    from pie_tpu_torch.cache.kv_cache import make_kv_cache
    from pie_tpu_torch.cache.paged import PagedKVPool
    from pie_tpu_torch.models.llama import LlamaModel
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model = LlamaModel(llama1b_config(2))
    gpu_params = model.quantize_params(model.init_params(seed=3, device="cuda"), 64, 4)
    cpu_params = to_device(gpu_params, "cpu")
    params = {"cpu": cpu_params, "cuda": gpu_params}
    t = lambda a, d: torch.from_numpy(np.asarray(a, np.int32)).to(d)
    errs, k4 = [], []

    def compare(what, run, rows=slice(None)):
        out = {}
        for dev in ("cpu", "cuda"):
            qmc.reset_counts()
            with torch.no_grad():
                out[dev] = run(dev).float().cpu()[rows]
        torch.cuda.synchronize()
        k4.append((what, qmc.launch_counts["K4"]))
        err = ((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()).item()
        if not (torch.isfinite(out["cuda"]).all() and err < 0.03):
            raise AssertionError(f"1B model check, {what}: err {err}")
        errs.append(err)

    ids = np.random.default_rng(7).integers(0, VOCAB, (1, 20))
    caches = {d: make_kv_cache(2, 1, 32, HKV1, DH1, dtype=torch.bfloat16, device=d)
              for d in ("cpu", "cuda")}

    def call(dev, start, n):
        first = torch.tensor([start], dtype=torch.int32, device=dev)
        pos = first[:, None] + torch.arange(n, dtype=torch.int32, device=dev)[None]
        caches[dev] = caches[dev].advance(first, n)
        logits, caches[dev] = model(params[dev], t(ids[:, start:start + n], dev),
                                    caches[dev], pos)
        return logits

    for start, n in [(0, 16)] + [(i, 1) for i in range(16, 20)]:
        compare(f"call {start}+{n}", lambda d: call(d, start, n))

    lanes, maxp = 8, 2
    pools = {d: PagedKVPool.create(2, lanes * maxp, HKV1, DH1, torch.bfloat16, True,
                                   device=d) for d in ("cpu", "cuda")}
    tables = np.arange(lanes * maxp, dtype=np.int32).reshape(lanes, maxp)[:, ::-1].copy()
    rng = np.random.default_rng(8)
    lens = rng.integers(4, 17, lanes)
    pos = np.where(np.arange(16)[None] < lens[:, None], np.arange(16)[None], -1)
    pids = np.where(pos >= 0, rng.integers(0, VOCAB, (lanes, 16)), 0)
    compare("paged prefill", lambda d: model.paged_forward(
        params[d], t(pids, d), pools[d], t(tables, d), t(pos, d), t(lens, d))[0],
        torch.from_numpy(pos >= 0))
    ctx, tok = lens.copy(), pids[np.arange(lanes), lens - 1]
    for step in range(4):
        compare(f"paged decode {step}", lambda d: model.paged_forward(
            params[d], t(tok[:, None], d), pools[d], t(tables, d), t(ctx[:, None], d),
            t(ctx + 1, d))[0][:, 0])
        tok, ctx = rng.integers(0, VOCAB, lanes), ctx + 1
    # one mixed step: lanes 1..7 decode, lane 0 frozen, a 16-token rider
    # brings lane 0's next tokens
    cs = 16
    dpos = np.where(np.arange(lanes) == 0, -1, ctx)
    dctx = np.where(np.arange(lanes) == 0, 1, ctx + 1)
    rider = rng.integers(0, VOCAB, cs)
    rpos = ctx[0] + np.arange(cs)
    compare("mixed", lambda d: model.mixed_forward(
        params[d], pools[d], t(tok, d), t(dpos, d), t(dctx, d), t(tables, d),
        t(rider, d), t(rpos, d), t([0], d), t([ctx[0] + cs], d))[0],
        torch.from_numpy(dpos >= 0))
    want = [(w, 2 if ("decode" in w or w.endswith("+1")) else 0) for w, _ in k4]
    if k4 != want:
        raise AssertionError(f"K4 launches per 1B step {k4}, want {want}")
    emit(dict(phase="model", geometry="llama3.2-1b", layers=2, kv="bf16 / int8 paged",
              norm_err=max(errs), norm_err_per_step=dict(zip((w for w, _ in k4), errs)),
              k4_per_step=k4))
    del cpu_params, gpu_params, params
    torch.cuda.empty_cache()
    return max(errs)


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
    if (decoded != 128 or launches["K1"] != 129 * decoded or launches["K2"] != 129
            or launches["K1 ln"] != 65 * decoded):
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
    prefill = prefill_times(engine, fresh_prompt(7))

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

    steady = steady_single(engine)
    row = dict(phase="engine", geometry="llama3-8b int4 g64", layers=LAYERS,
               ttft_p50_ms=ttfts[2] * 1e3, ttft_ms=[t * 1e3 for t in ttfts],
               prefill_512=prefill,
               decode_tok_s=best, wall_ms_per_token=1e3 / best,
               k1_per_decoded_token=launches["K1"] / decoded,
               k2_per_prefill=launches["K2"], launches=launches, trace=trace,
               steady=steady, graphs=engine.core.graphs.stats(), card=card)
    emit(row)
    return engine, row


# -- phase 5 -------------------------------------------------------------------


# the JSON and tool pieces of tests/test_constrained_engine.py: what a
# constrained request's machine needs to find in the vocabulary
JSON_PIECES = (
    list('{}[]":,.-0123456789 ')
    + ['{"', '"}', '": ', '", "', "true", "false", "null"]
    + list("abcdefghijklmnopqrstuvwxyz</>")
    + ["name", "count", "city", "alpha", "beta", "get_weather", "arguments"]
    + ["<think>", "</think>"]
)


def word_tokenizer_hf():
    """Offline word-level HF tokenizer with the Llama-3 control tokens (the
    recipe of tests/test_server.py), extended with JSON_PIECES after the
    words."""
    import transformers
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    from pie_tpu_torch.tokenizer.control_tokens import LLAMA3

    words = ["hello", "world", "how", "are", "you", "fine", "thanks", "user",
             "assistant", "system", "weather", "sunny", "<unk>"]
    specials = LLAMA3.all_control_tokens
    vocab = {w: i for i, w in enumerate(specials + words)}
    for piece in JSON_PIECES:
        vocab.setdefault(piece, len(vocab))
    raw = RawTok(models.WordLevel(vocab, unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token="<|begin_of_text|>",
        eos_token="<|end_of_text|>", unk_token="<unk>",
    )


def word_tokenizer():
    from pie_tpu_torch.tokenizer import Tokenizer
    from pie_tpu_torch.tokenizer.control_tokens import LLAMA3

    return Tokenizer(word_tokenizer_hf(), LLAMA3)


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

    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler
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

    # steady chunks: un-profiled, CUDA events, sync debug, profiled
    steady = steady_paged(sched, prompt, lanes)

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
    graph_stats = engine.graphs.stats()
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
               aten_calls_per_admission=ttft_trace["aten_calls"],
               device_steps=steps, k3_per_step=launches["K3"] / steps,
               launches=launches, steady=steady, ttft_trial=ttft_trace,
               graphs=graph_stats, card=card)
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


# -- phase 11: constrained decoding ---------------------------------------------

SCHEMA = {
    "type": "object",
    "properties": {"name": {"enum": ["alpha", "beta"]}, "count": {"type": "integer"}},
    "required": ["name", "count"],
    "additionalProperties": False,
}
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}},
        "required": ["city"], "additionalProperties": False}}}]
NAMED_TOOL = {"type": "function", "function": {"name": "get_weather"}}
HELLO = [{"role": "user", "text": "hello world"}]


def steer_bias(tok, reasoning: bool = False) -> dict:
    """Logit biases that make a random model close its JSON soon, wherever
    the mask allows: '"' first (a string ends at once), then '}', then ','
    and ':', whitespace last. For a reasoning request '</think>' ends the
    think phase at once and '"' is left alone (so '}' closes the object
    before any string, inside which '</think>' would win). The masks keep
    every token valid; without the biases greedy decoding of random weights
    fills any budget with whitespace or one long string."""
    vocab = tok._tok.get_vocab()
    if reasoning:
        return {vocab["</think>"]: 50.0, vocab["}"]: 40.0, vocab[" "]: -30.0}
    return {vocab['"']: 45.0, vocab["}"]: 40.0, vocab[","]: 30.0, vocab[":"]: 30.0,
            vocab[" "]: -30.0}


def check_schema(text) -> dict:
    data = json.loads(text)
    if not (set(data) == {"name", "count"} and data["name"] in ("alpha", "beta")
            and isinstance(data["count"], int)):
        raise AssertionError(f"output outside the schema: {text!r}")
    return data


def check_tool_call(calls) -> None:
    if not (calls and calls[0]["name"] == "get_weather"
            and set(calls[0]["arguments"]) == {"city"}):
        raise AssertionError(f"not a get_weather call: {calls}")


def constrained_single(engine, tok):
    """(a) The single stream through engine.chat: a json_schema chat, a
    json_object chat, a forced (named) tool call and a reasoning chat, each
    parsed and checked; host ms per mask build; ms and launches per
    choice point (the eager masked extend) by bucket; an unconstrained
    greedy request right after against a fresh engine's."""
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    engine.tokenizer = tok
    engine._token_masker = None
    masker = engine.token_masker
    builds, dispatches = [], []
    real_build, real_prefill = masker.build_mask, engine.core._prefill

    def timed_build(machine, *a):
        t0 = time.perf_counter()
        out = real_build(machine, *a)
        builds.append((time.perf_counter() - t0) * 1e3)
        return out

    def counted_prefill(*a, **kw):
        dispatches.append(a[2].shape[1])
        return real_prefill(*a, **kw)

    masker.build_mask, engine.core._prefill = timed_build, counted_prefill
    chats = {}
    try:
        for name, kw in (
            ("json_schema", dict(response_format={"type": "json_schema", "json_schema": {
                "name": "t", "schema": SCHEMA}})),
            ("json_object", dict(response_format={"type": "json_object"})),
            ("tool_call", dict(tools=TOOLS, tool_choice=NAMED_TOOL)),
            ("reasoning", dict(response_format={"type": "json_object"}, reasoning=True)),
        ):
            n0, t0 = len(dispatches), time.perf_counter()
            inter = engine.chat(HELLO, max_completion_tokens=48, temperature=0.0,
                                logit_bias=steer_bias(tok, reasoning=name == "reasoning"),
                                **kw)
            ms = (time.perf_counter() - t0) * 1e3
            if name == "json_schema":
                check_schema(inter.text)
            elif name == "tool_call":
                if inter.finish_reason != "tool_calls":
                    raise AssertionError(f"tool call: {inter.finish_reason} {inter.text!r}")
                check_tool_call(inter.tool_calls)
            else:
                if not isinstance(json.loads(inter.text), dict):
                    raise AssertionError(f"{name}: {inter.text!r}")
                if name == "reasoning" and inter.metadata["reasoning_content"] is None:
                    raise AssertionError(f"reasoning: no reasoning content {inter}")
            chats[name] = dict(ms=ms, text=inter.text if name != "tool_call"
                               else inter.tool_calls, finish=inter.finish_reason,
                               tokens=inter.metadata["completion_tokens"],
                               choice_points=len(dispatches) - n0,
                               ms_per_choice_point=ms / max(1, len(dispatches) - n0))
    finally:
        masker.build_mask, engine.core._prefill = real_build, real_prefill

    # one masked extend per bucket: host wall ms (a replayed prefill graph)
    # and the kernels it launches
    core, dev = engine.core, engine.device
    mask = torch.zeros((1, VOCAB), dtype=torch.bool, device=dev)
    mask[0, :masker.vocab_size] = True
    args = (engine._sampling({"temperature": 0.0}), engine._penalties({}),
            *engine._empty_bias)
    extends = {}
    for bucket in engine.EXTEND_BUCKETS:
        ids = torch.randint(1, 100, (1, bucket), dtype=torch.int32, device=dev)
        call = lambda: core._prefill(  # noqa: E731
            engine.params, engine.state, ids, engine._one(bucket), engine._one(64),
            *args, allowed_mask=mask, sampler_kind="greedy")[1].cpu()
        call()
        qmc.reset_counts()
        call()
        launches = dict(qmc.launch_counts)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        extends[bucket] = dict(ms=sorted(times)[2], launches=launches)
        if not launches["K1" if bucket <= qmc.DECODE_MAX_M else "K2"] == 4 * LAYERS + 1:
            raise AssertionError(f"masked extend of {bucket} tokens: {launches}")
    engine.prompt_cache.update([])  # the timed extends wrote KV of their own

    prompt = [p + 11 for p in range(1, 65)]
    got = engine.generate(prompt, max_completion_tokens=24, temperature=0.0).token_ids
    fresh = InferenceEngine(model=engine.model, params=engine.params, max_seq_len=1024,
                            decode_chunk=128)
    want = fresh.generate(prompt, max_completion_tokens=24, temperature=0.0).token_ids
    del fresh
    if got != want:
        raise AssertionError(f"greedy request after constrained ones: {got} != {want}")
    return dict(chats=chats, choice_point_ms_by_bucket={b: e["ms"] for b, e in extends.items()},
                launches_per_choice_point={b: e["launches"] for b, e in extends.items()},
                mask_build_host_ms=dict(n=len(builds), median=sorted(builds)[len(builds) // 2],
                                        max=max(builds)),
                dispatch_buckets={b: dispatches.count(b) for b in sorted(set(dispatches))},
                after_constrained_equals_fresh=True)


def constrained_http(engine, bias):
    """(b) create_app over the 8B engine: a json_schema chat and a named
    tool_choice chat over HTTP, each 200 with parsed content / tool_calls."""
    import asyncio

    import aiohttp
    from aiohttp import web

    from pie_tpu_torch.server.app import create_app
    from pie_tpu_torch.server.config import Settings

    body = dict(messages=[{"role": "user", "content": "hello world"}], max_tokens=48,
                temperature=0.0, logit_bias={str(k): v for k, v in bias.items()})

    async def serve():
        runner = web.AppRunner(create_app(engine=engine, settings=Settings(),
                                          device=engine.device))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
        out = {}
        try:
            async with aiohttp.ClientSession() as s:
                for name, extra in (
                    ("json_schema", {"response_format": {"type": "json_schema",
                                                         "json_schema": {"name": "t",
                                                                         "schema": SCHEMA}}}),
                    ("tool_call", {"tools": TOOLS, "tool_choice": NAMED_TOOL,
                                   "parallel_tool_calls": False}),
                ):
                    t0 = time.perf_counter()
                    async with s.post(f"{url}/v1/chat/completions",
                                      json=dict(body, **extra)) as r:
                        data = await r.json()
                        if r.status != 200:
                            raise AssertionError(f"{name}: {r.status} {data}")
                    out[name] = dict(ms=(time.perf_counter() - t0) * 1e3,
                                     message=data["choices"][0]["message"])
        finally:
            await runner.cleanup()
        return out

    out = asyncio.run(serve())
    check_schema(out["json_schema"]["message"]["content"])
    calls = out["tool_call"]["message"].get("tool_calls") or []
    check_tool_call([dict(name=c["function"]["name"],
                          arguments=json.loads(c["function"]["arguments"])) for c in calls])
    return out


def constrained_batched(model, params, tok, bias):
    """(c) The paged 8-lane INT8 engine with a json_schema lane and a named
    tool-call lane beside 6 free greedy lanes, twice: on steps replayed from
    graphs, and on a twin whose same steps run eagerly on the card (tokens
    equal, every step's logits within 1e-3 normalized, the masked decode
    and mixed steps among them); the free lanes against the same prompts
    alone; the constrained outputs checked. Speculation acceptance,
    launches per masked chunk, ms of a masked chunk against an unmasked
    one, the masked graphs and the pool's bytes."""
    import gc

    import numpy as np

    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler, SeqStatus
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.structured import RootStateMachine
    from pie_tpu_torch.structured.token_masks import TokenMasker

    def norm_err(a, b):
        return float((a - b).abs().max() / b.abs().max())

    masker = TokenMasker(tok)
    root = RootStateMachine(tok.control_tokens)
    lanes = [root.configure(response_format={"type": "json_schema", "json_schema": {
                 "name": "t", "schema": SCHEMA}}),
             root.configure(tools=TOOLS, tool_choice=NAMED_TOOL)]
    prompts = [tok.apply_chat_template(HELLO, add_generation_prompt=True),
               tok.apply_chat_template(HELLO, add_generation_prompt=True, tools=TOOLS)]
    free = [[1 + (i * 53 + j * 7) % 100000 for j in range(5 + 4 * i)] for i in range(6)]
    # each free lane's greedy choice pinned to a word of its own: on random
    # weights a lane's near-ties would flip with the batch around it (a
    # mixed step's K2 rows against a decode step's K1), while a constrained
    # neighbour's mask leaking onto it would suppress its word
    vocab = tok._tok.get_vocab()
    words = ["hello", "world", "how", "are", "you", "fine"]
    free_kw = [dict(max_new_tokens=24, temperature=0.0, logit_bias={vocab[w]: 100.0})
               for w in words]
    scheds = [Scheduler(PagedEngine(model, params, num_lanes=8, num_pages=112,
                                    max_pages_per_seq=12, kv_quantized=True),
                        decode_steps=8) for _ in range(2)]
    scheds[1].engine.graphs = eager_steps(scheds[1].engine.graphs)
    spec = dict(speculated=0, accepted=0)
    chunks = []

    def instrument(sc):
        drain, emit_c, chunk = (sc._drain_constrained_lane, sc._emit_constrained,
                                sc.engine._chunk)

        def counted_drain(lane, seq, emitted, n, first_masked):
            spec["speculated"] += max(0, int((emitted[:, lane] != -1).sum()) - 1)
            return drain(lane, seq, emitted, n, first_masked)

        def counted_emit(seq, token, masked=True):
            ok = emit_c(seq, token, masked)
            spec["accepted"] += int(ok and not masked)
            return ok

        def counted_chunk(params, num_steps, *a, mask=None, rider=None, **kw):
            before = dict(qmc.launch_counts)
            out = chunk(params, num_steps, *a, mask=mask, rider=rider, **kw)
            if mask is not None:
                chunks.append(dict(steps=num_steps, mixed=rider is not None, launches={
                    k: qmc.launch_counts[k] - before[k] for k in before}))
            return out

        sc._drain_constrained_lane, sc._emit_constrained = counted_drain, counted_emit
        sc.engine._chunk = counted_chunk

    instrument(scheds[0])
    runs = []
    for sc in scheds:
        sc.engine.graphs = Tap(sc.engine.graphs)
        seqs = [sc.add_request(p, max_new_tokens=48, logit_bias=bias,
                               machine=st.machine.copy(),
                               masker=masker, state_kwargs=st.state_kwargs,
                               stop_token_ids=tuple(tok.stop_tokens),
                               temperature=st.generation_kwargs.get("temperature", 0.0))
                for p, st in zip(prompts, lanes)]
        seqs += [sc.add_request(p, **kw) for p, kw in zip(free, free_kw)]
        t0 = time.perf_counter()
        sc.run_to_completion()
        torch.cuda.synchronize()
        runs.append(dict(seqs=seqs, s=time.perf_counter() - t0))
    masked_chunks = [c for c in chunks if c["steps"]]  # the counted run's
    streams = [[(q.output_ids, q.finish_reason) for q in r["seqs"]] for r in runs]
    taps = [sc.engine.graphs for sc in scheds]
    errs = [norm_err(a, b) for a, b in zip(taps[0].logits, taps[1].logits)]
    masked_keys = sorted({k[0] for k in taps[0].inner.keys
                          if k[0] != "prefill" and k[4]})
    if not (streams[0] == streams[1] and max(errs) < 1e-3
            and masked_keys == ["decode", "mixed"] and taps[0].inner.replays > 0):
        raise AssertionError(f"masked graphs against eager steps: tokens equal "
                             f"{streams[0] == streams[1]}, max err {max(errs)}, "
                             f"masked keys {masked_keys}")
    texts = ["".join(masker.token_strs[t] for t in q.output_ids
                     if t < masker.vocab_size and t not in tok.stop_tokens)
             for q in runs[0]["seqs"][:2]]
    check_schema(texts[0])
    label, calls = RootStateMachine.labeled_output(lanes[1], texts[1])
    if label != "tool_calls":
        raise AssertionError(f"tool lane: {texts[1]!r}")
    check_tool_call(calls)
    sc = scheds[0]
    sc.engine.graphs = taps[0].inner
    alone = [sc.add_request(p, **kw) for p, kw in zip(free, free_kw)]
    sc.run_to_completion()
    if [q.output_ids for q in alone] != [q.output_ids for q in runs[0]["seqs"][2:]]:
        raise AssertionError("free lanes beside constrained ones differ from alone")
    if [set(q.output_ids) for q in alone] != [{vocab[w]} for w in words]:
        raise AssertionError(f"free lanes: {[q.output_ids for q in alone]}")

    # a masked chunk against an unmasked one: 8 decoding lanes, 8 steps
    e = sc.engine
    busy = [sc.add_request(p, max_new_tokens=200, temperature=0.0) for p in free + free[:2]]
    while any(q.status != SeqStatus.DECODING for q in busy):
        sc.step()
    for q in busy:
        q.cancelled = True  # the direct chunks below advance only the device state
    allowed = np.zeros((8, VOCAB), bool)
    allowed[:, :masker.vocab_size] = True
    valid = np.zeros((8,), bool)
    valid[:2] = True
    graphs0 = e.graphs.stats()
    chunk_ms = {}
    for name, kw in (("unmasked", {}), ("masked", dict(mask=(allowed, valid)))):
        run = lambda: e._chunk(e.params, 8, "greedy", False, False, **kw)  # noqa: E731
        run()
        chunk_ms[name] = sorted(event_ms(run) for _ in range(3))[1]
    sc.run_to_completion()
    stats = e.graphs.stats()
    masked_graphs = sum(1 for k in e.graphs.keys if k[0] != "prefill" and k[4])
    del scheds, sc, e, taps
    gc.collect()
    torch.cuda.empty_cache()
    per_chunk = {k: sum(c["launches"][k] for c in masked_chunks) / len(masked_chunks)
                 for k in ("K1", "K1 ln", "K2", "K3", "K4")}
    per_step = {k: sum(c["launches"][k] for c in masked_chunks)
                / sum(c["steps"] for c in masked_chunks) for k in per_chunk}
    if not (per_step["K1"] > 0 and per_step["K3"] == LAYERS):
        raise AssertionError(f"masked chunks launched {per_step} per step")
    return dict(streams_equal_eager=True, steps=len(errs), max_norm_err=max(errs),
                masked_keys=masked_keys, free_equal_alone=True,
                outputs=texts, run_s=[r["s"] for r in runs],
                acceptance=dict(spec, rate=spec["accepted"] / max(1, spec["speculated"])),
                masked_chunks=len(masked_chunks),
                launches_per_masked_chunk=per_chunk, launches_per_masked_step=per_step,
                chunk_ms=chunk_ms, masked_graphs=masked_graphs,
                graphs_before_timing=graphs0, graphs=stats)


def phase_constrained(engine, card):
    """Phase 11: constrained decoding on the 8B engines, (a) single stream,
    (b) HTTP, (c) batched; (d) runs inside phase 9's servers."""
    tok = word_tokenizer()
    bias = steer_bias(tok)
    row = dict(phase="constrained", geometry="llama3-8b int4 g64", layers=LAYERS,
               card=card)
    row["single"] = constrained_single(engine, tok)
    row["http"] = constrained_http(engine, bias)
    row["batched"] = constrained_batched(engine.model, engine.params, tok, bias)
    emit(row)
    return row


# -- phase 8: the 1B snapshot ---------------------------------------------------


def write_snapshot_1b(path):
    """A Llama-3.2-1B HF snapshot with random bf16 weights from a seed:
    config.json (bench.py's llama32_1b_config and an INT4 g64 quantization
    block), model.safetensors (HF names, [N, K] linear weights, tied
    embeddings: no lm_head) and the word-level tokenizer's files."""
    from safetensors.torch import save_file

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)

    def w(n, k):
        return (torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5).bfloat16().cpu()

    def norm():
        return (1 + 0.1 * torch.randn((D1,), generator=gen, device="cuda")).bfloat16().cpu()

    sd = {"model.embed_tokens.weight": (torch.randn((VOCAB, D1), generator=gen,
                                                    device="cuda") * 0.02).bfloat16().cpu(),
          "model.norm.weight": norm()}
    for i in range(LAYERS1):
        pre = f"model.layers.{i}."
        sd.update({
            pre + "self_attn.q_proj.weight": w(HQ1 * DH1, D1),
            pre + "self_attn.k_proj.weight": w(HKV1 * DH1, D1),
            pre + "self_attn.v_proj.weight": w(HKV1 * DH1, D1),
            pre + "self_attn.o_proj.weight": w(D1, HQ1 * DH1),
            pre + "mlp.gate_proj.weight": w(DI1, D1),
            pre + "mlp.up_proj.weight": w(DI1, D1),
            pre + "mlp.down_proj.weight": w(D1, DI1),
            pre + "input_layernorm.weight": norm(),
            pre + "post_attention_layernorm.weight": norm(),
        })
    save_file(sd, str(path / "model.safetensors"), metadata={"format": "pt"})
    config = dict(
        architectures=["LlamaForCausalLM"], model_type="llama", hidden_size=D1,
        intermediate_size=DI1, num_hidden_layers=LAYERS1, num_attention_heads=HQ1,
        num_key_value_heads=HKV1, head_dim=DH1, vocab_size=VOCAB, rms_norm_eps=EPS,
        rope_theta=500000.0, rope_scaling=ROPE1, tie_word_embeddings=True,
        max_position_embeddings=131072, torch_dtype="bfloat16",
        quantization={"group_size": 64, "bits": 4},
    )
    (path / "config.json").write_text(json.dumps(config, indent=1))
    word_tokenizer_hf().save_pretrained(str(path))
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    del sd
    row = dict(phase="snapshot", geometry="llama3.2-1b", layers=LAYERS1,
               dtype="bfloat16", bytes=nbytes, write_s=time.perf_counter() - t0,
               files=sorted(f.name for f in path.iterdir()))
    emit(row)
    return row


def quantized_bytes(params) -> int:
    """Bytes a decoded token streams from the quantized weights: packed
    words, scales and biases of every layer's projections and the head."""
    from pie_tpu_torch.ops.quant import QuantizedTensor

    leaves = list(params["layers"].values()) + [params["lm_head"]]
    return sum(t.numel() * t.element_size() for q in leaves
               if isinstance(q, QuantizedTensor) for t in (q.packed, q.scales, q.biases))


# -- phase 9: the server from MODEL_PATH -----------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(method, url, body=None, timeout=300):
    """(status, seconds, decoded body) of one request on localhost."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    return status, time.perf_counter() - t0, text


def start_server(snap, env_extra):
    """Start `python -m pie_tpu_torch.server` on MODEL_PATH=snap and wait
    for /health. Returns (process, url, startup s); ``stop_server`` ends
    it."""
    import os
    import urllib.error

    port = free_port()
    env = dict(os.environ, MODEL_PATH=str(snap), PORT=str(port), HOST="127.0.0.1",
               LOG_LEVEL="WARNING", **env_extra)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "pie_tpu_torch.server"], cwd=root,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"server exited {proc.returncode}:\n"
                                     f"{proc.stdout.read()[-4000:]}")
            if time.perf_counter() - t0 > 600:
                raise AssertionError("server did not answer /health in 600 s")
            try:
                if http("GET", f"{url}/health", timeout=5)[0] == 200:
                    break
            except (urllib.error.URLError, OSError):
                pass
            time.sleep(0.5)
    except BaseException:
        stop_server(proc)
        raise
    return proc, url, time.perf_counter() - t0


def stop_server(proc):
    if proc.poll() is None:
        proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def serve_and_ask(snap, env_extra, ask):
    """Start `python -m pie_tpu_torch.server` on MODEL_PATH=snap, wait for
    /health, run ask(url), stop the server. Returns (startup s, ask's
    result)."""
    proc, url, startup = start_server(snap, env_extra)
    try:
        return startup, ask(url)
    finally:
        stop_server(proc)


def phase_serve(snap):
    """The snapshot served through the normal entry point, single-stream and
    with BATCHING=1 KV_QUANTIZED=1 NUM_LANES=8; every request must be 200.
    A logit_bias on an in-vocabulary word makes the replies certain."""
    from concurrent.futures import ThreadPoolExecutor

    hello = word_tokenizer().encode("hello", add_bos=False)[0]
    chat = dict(messages=[{"role": "user", "content": "hello world"}], max_tokens=8,
                temperature=0.0, logit_bias={str(hello): 100.0})
    # phase 11d: a json_schema chat on each server
    json_chat = dict(chat, max_tokens=48, response_format={
        "type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}},
        logit_bias={str(k): v for k, v in steer_bias(word_tokenizer()).items()})

    def json_schema(url):
        ms, text = ok(*http("POST", f"{url}/v1/chat/completions", json_chat),
                      "json_schema chat")
        content = json.loads(text)["choices"][0]["message"]["content"]
        check_schema(content)
        return dict(json_schema_ms=ms, json_schema_content=content)

    def ok(status, secs, text, what):
        if status != 200:
            raise AssertionError(f"{what}: {status} {text[:2000]}")
        return secs * 1e3, text

    def single(url):
        # the first request captures the prefill and decode-step graphs;
        # the second replays them
        ms_chat, text = ok(*http("POST", f"{url}/v1/chat/completions", chat), "chat")
        content = json.loads(text)["choices"][0]["message"]["content"]
        ms_again, _ = ok(*http("POST", f"{url}/v1/chat/completions", chat), "chat again")
        ms_sse, text = ok(*http("POST", f"{url}/v1/chat/completions",
                                dict(chat, stream=True)), "chat stream")
        if not (text.rstrip().endswith("data: [DONE]") and "hello" in text):
            raise AssertionError(f"chat stream: {text[:2000]}")
        ms_cmp, text = ok(*http("POST", f"{url}/v1/completions", dict(
            prompt="hello world how", max_tokens=6, temperature=0.0,
            logit_bias={str(hello): 100.0})), "completion")
        if "hello" not in content or "hello" not in json.loads(text)["choices"][0]["text"]:
            raise AssertionError(f"replies without the forced word: {content!r}, {text}")
        return dict(chat_ms=ms_chat, chat_again_ms=ms_again, chat_sse_ms=ms_sse,
                    completion_ms=ms_cmp, content=content, **json_schema(url))

    def batched(url):
        # the first request captures the prefill and step graphs; the
        # second replays them
        ms_first, _ = ok(*http("POST", f"{url}/v1/chat/completions", chat), "first chat")
        ms_second, _ = ok(*http("POST", f"{url}/v1/chat/completions", chat), "second chat")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            many = list(pool.map(lambda _: ok(*http(
                "POST", f"{url}/v1/chat/completions", chat), "concurrent chat"), range(4)))
        wall = (time.perf_counter() - t0) * 1e3
        ms_n2, text = ok(*http("POST", f"{url}/v1/chat/completions", dict(chat, n=2)),
                         "n=2 chat")
        texts = [json.loads(t)["choices"][0]["message"]["content"] for _, t in many]
        two = [c["message"]["content"] for c in json.loads(text)["choices"]]
        if len(set(texts)) != 1 or "hello" not in texts[0] or two != texts[:1] * 2:
            raise AssertionError(f"batched replies differ: {texts}, n=2 {two}")
        return dict(first_chat_ms=ms_first, second_chat_ms=ms_second,
                    concurrent_ms=[ms for ms, _ in many],
                    concurrent_wall_ms=wall, n2_ms=ms_n2, content=texts[0],
                    **json_schema(url))

    rows = []
    for env, ask in (({}, single),
                     ({"BATCHING": "1", "KV_QUANTIZED": "1", "NUM_LANES": "8"}, batched)):
        startup, out = serve_and_ask(snap, env, ask)
        row = dict(phase="serve", entry="python -m pie_tpu_torch.server", env=env,
                   startup_s=startup, **out)
        emit(row)
        rows.append(row)
    emit(dict(phase="constrained 1B", entry="python -m pie_tpu_torch.server",
              json_schema={("batching" if r["env"] else "single"): dict(
                  ms=r["json_schema_ms"], content=r["json_schema_content"]) for r in rows}))
    return rows


# -- phase 10: the 1B engines from the snapshot -----------------------------------


def phase_engine_1b(snap, card):
    """InferenceEngine(model_path=snap): load time and quantized bytes, one
    counted request (64-token prompt, 128 decoded tokens: K4 16 and K1 17
    per decoded token, K2 65 per prefill), TTFT p50 of 512-token prompts,
    best-of-3 decode tok/s, the idle share over a profiled request."""
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    t0 = time.perf_counter()
    engine = InferenceEngine(model_path=str(snap), max_seq_len=1024, decode_chunk=128)
    load_s = time.perf_counter() - t0
    wbytes = quantized_bytes(engine.params)
    prompt = list(range(1, 65))
    engine.generate(prompt, max_completion_tokens=9, temperature=0.0)  # warm up
    qmc.reset_counts()
    res = engine.generate([p + 7 for p in prompt], max_completion_tokens=129,
                          temperature=0.0)
    torch.cuda.synchronize()
    launches = dict(qmc.launch_counts)
    decoded = res.completion_tokens - 1
    if not (decoded == 128 and launches["K4"] == LAYERS1 * decoded
            and launches["K1"] == (LAYERS1 + 1) * decoded
            and launches["K1 ln"] == (LAYERS1 + 1) * decoded
            and launches["K2"] == 4 * LAYERS1 + 1):
        raise AssertionError(f"1B main path launches {launches} for {decoded} tokens")

    def fresh_prompt(salt):
        return [1 + (i * 37 + salt * 101) % 100000 for i in range(512)]

    engine.generate(fresh_prompt(99), max_completion_tokens=1, temperature=0.0)
    ttfts = []
    for salt in range(5):
        gen = engine.generate_stream(fresh_prompt(salt), max_completion_tokens=2,
                                     temperature=0.0)
        t1 = time.perf_counter()
        next(gen)
        ttfts.append(time.perf_counter() - t1)
        for _ in gen:
            pass
    ttfts.sort()
    prefill = prefill_times(engine, fresh_prompt(7))
    best = 0.0
    for _ in range(3):
        gen = engine.generate_stream(prompt, max_completion_tokens=129, temperature=0.0)
        next(gen)
        n, t1 = 0, time.perf_counter()
        for _ in gen:
            n += 1
        best = max(best, n / (time.perf_counter() - t1))
    trace = profiled(lambda: engine.generate([p + 3 for p in prompt],
                                             max_completion_tokens=33, temperature=0.0))
    steady = steady_single(engine)
    row = dict(phase="engine", geometry="llama3.2-1b int4 g64 (snapshot)",
               layers=LAYERS1, load_s=load_s, quantized_weight_bytes=wbytes,
               ttft_p50_ms=ttfts[2] * 1e3, ttft_ms=[t * 1e3 for t in ttfts],
               prefill_512=prefill,
               decode_tok_s=best, wall_ms_per_token=1e3 / best,
               k4_per_decoded_token=launches["K4"] / decoded,
               k1_per_decoded_token=launches["K1"] / decoded,
               k2_per_prefill=launches["K2"], launches=launches, trace=trace,
               steady=steady, graphs=engine.core.graphs.stats(), card=card)
    emit(row)
    model, params = engine.model, engine.params
    del engine
    torch.cuda.empty_cache()
    return row, (model, params)


def phase_paged_engine_1b(snap, card):
    """BatchedInferenceEngine(model_path=snap, kv_quantized=True,
    num_lanes=8) driven through its scheduler in bench.py's paged
    configuration: 8 x (64-token prompt, 128 new), aggregate tok/s best of
    2 (K4 16 per decode device step, none in mixed steps or prefills), TTFT
    of a 512-token prompt under 7 busy lanes, the idle share over one
    steady chunk."""
    import gc

    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    lanes = 8
    service = BatchedInferenceEngine(model_path=str(snap), num_lanes=lanes,
                                     num_pages=112, max_pages_per_seq=12,
                                     kv_quantized=True)
    sched, engine = service.scheduler, service.core
    mixed = []
    real_mixed = engine.model.mixed_forward

    def counting_mixed(*a, **kw):
        mixed.append(1)
        return real_mixed(*a, **kw)

    engine.model.mixed_forward = counting_mixed
    prompt = list(range(1, 65))
    sched.add_request(prompt, max_new_tokens=17, temperature=0.0)  # warm up
    sched.run_to_completion()
    best = 0.0
    for rep in range(2):
        qmc.reset_counts()
        steps0, mixed0 = engine.device_steps, len(mixed)
        seqs = [sched.add_request(prompt, max_new_tokens=128, temperature=0.0)
                for _ in range(lanes)]
        t0 = time.perf_counter()
        sched.run_to_completion()
        torch.cuda.synchronize()
        best = max(best, sum(len(s.output_ids) for s in seqs) / (time.perf_counter() - t0))
        if rep == 0:
            launches = dict(qmc.launch_counts)
            steps = engine.device_steps - steps0
            mixed_steps = len(mixed) - mixed0
    decode_steps = steps - mixed_steps
    if not (decode_steps > 0 and launches["K4"] == LAYERS1 * decode_steps
            and launches["K3"] == LAYERS1 * steps):
        raise AssertionError(f"1B paged path: {launches} over {steps} steps "
                             f"({mixed_steps} mixed)")
    steady = steady_paged(sched, prompt, lanes)
    busy = [sched.add_request(prompt, max_new_tokens=400, temperature=0.0)
            for _ in range(lanes - 1)]
    while any(not s.output_ids for s in busy):
        sched.step()

    def ttft_of(salt):
        t0 = time.perf_counter()
        late = sched.add_request([1 + (i * 37 + salt * 101) % 100000 for i in range(512)],
                                 max_new_tokens=8, temperature=0.0)
        while not late.output_ids:
            sched.step()
        dt = time.perf_counter() - t0
        while late.finish_reason is None:
            sched.step()
        return dt

    ttft_of(50)
    ttfts = sorted(ttft_of(s) for s in range(3))
    for s in busy:
        s.cancelled = True
    sched.run_to_completion()
    graph_stats = engine.graphs.stats()
    del engine.model.mixed_forward
    service.shutdown()
    del sched, engine, service
    gc.collect()
    torch.cuda.empty_cache()
    row = dict(phase="paged_engine", geometry="llama3.2-1b int4 g64 (snapshot)",
               layers=LAYERS1, lanes=lanes, kv="int8 paged", decode_tok_s=best,
               ttft_under_load_p50_ms=ttfts[1] * 1e3,
               ttft_under_load_ms=[t * 1e3 for t in ttfts], device_steps=steps,
               mixed_steps=mixed_steps, k4_per_decode_step=launches["K4"] / decode_steps,
               launches=launches, steady=steady, graphs=graph_stats, card=card)
    emit(row)
    return row


# -- phase 12: Gemma-3 ----------------------------------------------------------

# Gemma-3 4B's text model (google/gemma-3-4b-it config.json, text_config):
# 34 layers, 5:1 sliding (window 1,024) / global, head_dim 256, tied vocab
G4 = dict(hidden_size=2560, intermediate_size=10240, num_attention_heads=8,
          num_key_value_heads=4, head_dim=256, sliding_window=1024,
          sliding_window_pattern=6, rope_theta=1000000.0,
          rope_scaling={"rope_type": "linear", "factor": 8.0},
          rope_local_base_freq=10000.0, query_pre_attn_scalar=256,
          vocab_size=262208, rms_norm_eps=1e-6)
G4_LAYERS = 34
# Gemma-3 1B (the JAX package's Gemma3Config defaults): one KV head (MQA)
G1 = dict(hidden_size=1152, intermediate_size=6912, num_attention_heads=4,
          num_key_value_heads=1, head_dim=256, sliding_window=512,
          sliding_window_pattern=6, rope_theta=1000000.0,
          rope_local_base_freq=10000.0, query_pre_attn_scalar=256,
          vocab_size=262144, rms_norm_eps=1e-6)
G_PROJ = 7  # wq, wk, wv, wo, wg, wu, wd: one K1 / K2 launch each per layer
G_LENS = (1, 63, 64, 65, 700, 1500, 2048, 4096)


def gemma_config(geo, layers, **extra):
    from pie_tpu_torch.models.gemma3 import Gemma3Config

    return Gemma3Config(model_type="gemma3_text", num_hidden_layers=layers,
                        **dict(geo, **extra))


def gemma_k3_timing(quantized):
    """K3 at head_dim 256 (B8, paged_attention_d256) per Gemma-3 4B device
    step at 8 lanes x 2,048 tokens: 29 sliding layers (window 1,024: the
    walk clipped to its last 16 pages) and 5 global ones; device time over
    rotating layers, the plain version, SDPA on K/V gathered and
    dequantized beforehand (the window's tokens only on sliding layers;
    yardstick only) and the bound; the launch plan with the kernel's
    registers and local bytes a thread, which must be 0 (no spill)."""
    import torch.nn.functional as F

    from pie_tpu_torch.cache.paged import PagedKVPool, gather_kv
    from pie_tpu_torch.ops import paged_attention as pa

    hq, hkv, dh = G4["num_attention_heads"], G4["num_key_value_heads"], G4["head_dim"]
    inputs = paged_inputs((2048,) * 8, hq, hkv, dh, quantized, seed=4)
    q, k, v, ks, vs, tables, ctx = inputs
    scale = dh ** -0.5
    pool = PagedKVPool(k, v, ks, vs)
    dense = []
    for layer in range(POOL_LAYERS):
        kd, vd = gather_kv(pool, layer, tables, torch.bfloat16)
        dense.append((kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()))
    per = {}
    for window in (G4["sliding_window"], 0):
        kern = lambda i: pa.paged_attention_decode(q, k, v, ks, vs, i % POOL_LAYERS,
                                                   tables, ctx, scale, window)
        lo = 2048 - window if window else 0
        lib = lambda i: F.scaled_dot_product_attention(
            q[:, :, None], dense[i % POOL_LAYERS][0][:, :, lo:],
            dense[i % POOL_LAYERS][1][:, :, lo:], scale=scale, enable_gqa=True)
        nbytes, pages = paged_bytes(inputs, window)
        per[window] = dict(
            kernel_ms=device_ms(kern), library_ms=device_ms(lib),
            plain_ms=cuda_ms(lambda i: pa.paged_attention_ref(
                q, k, v, ks, vs, i % POOL_LAYERS, tables, ctx, scale, window), 3, warmup=1),
            bytes=nbytes, flops=4 * 8 * (2048 - lo) * hq * dh)
    n_slide = sum((i + 1) % G4["sliding_window_pattern"] != 0 for i in range(G4_LAYERS))
    n_glob = G4_LAYERS - n_slide
    step = {key: n_slide * per[G4["sliding_window"]][key] + n_glob * per[0][key]
            for key in per[0]}
    bb, bo = step["bytes"] / HBM_BYTES_PER_S * 1e3, step["flops"] / BF16_FLOP_PER_S * 1e3
    row = dict(phase="gemma3", part="a: K3 D 256 timing",
               case=f"8 lanes x 2048 {'int8' if quantized else 'bf16'}, 4B heads 8/4",
               **pa.launch_plan(q.device, 8, hq, hkv, dh, tables.shape[1], quantized),
               per_call=per, sliding_layers=n_slide, global_layers=n_glob,
               launches_per_step=G4_LAYERS, **step,
               bound_ms=max(bb, bo), bound_by="bytes" if bb >= bo else "operations")
    emit(row)
    if row["local_bytes"]:
        raise AssertionError(f"K3 at D 256 spills: {row['local_bytes']} local bytes a thread")
    del dense, inputs, q, k, v, ks, vs, pool
    torch.cuda.empty_cache()
    return row


def gemma_k3_checks():
    """K3 at head_dim 256 against its plain version: INT8 and bf16 pages,
    heads (8, 4) (4B), (16, 8) (12B) and (4, 1) (1B, MQA), windows 0 and
    1,024, contexts 1..4,096, the walk split over blocks and not; the
    per-lane normalized limit of the D 64 / 128 checks (2e-2)."""
    from pie_tpu_torch.ops import paged_attention as pa

    worst, rows = 0.0, []
    for quantized in (True, False):
        for hq, hkv in ((8, 4), (16, 8), (4, 1)):
            inputs = paged_inputs(G_LENS, hq, hkv, 256, quantized, seed=hq + hkv)
            for window in (0, G4["sliding_window"]):
                for target in (pa.TARGET_BLOCKS, 1):
                    saved, pa.TARGET_BLOCKS = pa.TARGET_BLOCKS, target
                    try:
                        splits = pa.launch_plan(inputs[0].device, len(G_LENS), hq, hkv,
                                                256, inputs[5].shape[1], quantized)["splits"]
                        diff, norm = paged_check(inputs, 3, window)
                    finally:
                        pa.TARGET_BLOCKS = saved
                    worst = max(worst, diff)
                    rows.append(dict(quantized=quantized, hq=hq, hkv=hkv, window=window,
                                     splits=splits, max_abs_err=diff, norm_err=norm))
            del inputs
    if not any(r["splits"] > 1 for r in rows) or not any(r["splits"] == 1 for r in rows):
        raise AssertionError("K3 D 256 checks did not cover split and unsplit walks")
    emit(dict(phase="gemma3", part="a: K3 D 256 vs plain", lens=G_LENS, checks=rows,
              worst_norm_err=max(r["norm_err"] for r in rows)))
    return worst


def gemma_model_check(label, cfg):
    """One cut Gemma-3 model at full width, card against the CPU path on
    the same random INT4 g64 weights: the single-stream forward over the
    DualKVCache (a window-sized chunk, a second chunk past the window, 4
    decode steps), then over an INT8 paged pool paged_forward (lane 0
    prefilled past the window, lane 1 shorter, 3 decode steps with a lane
    frozen) and mixed_forward (lane 2's prompt as a 40-token rider, then
    an empty one); logits within 0.03 normalized; K1, K2 and K3 ran."""
    import numpy as np

    from pie_tpu_torch.cache.paged import PagedKVPool
    from pie_tpu_torch.models.gemma3 import Gemma3Model
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model = Gemma3Model(cfg)
    gpu_params = model.init_quantized_params(seed=11, device="cuda")
    params = {"cpu": to_device(gpu_params, "cpu"), "cuda": gpu_params}
    win, hkv, dh, vocab = (cfg.sliding_window, cfg.num_key_value_heads, cfg.head_dim,
                           cfg.vocab_size)
    t = lambda a, d: torch.from_numpy(np.asarray(a, np.int32)).to(d)
    errs = {}

    def compare(what, run, rows=slice(None)):
        out = {}
        for dev in ("cpu", "cuda"):
            with torch.no_grad():
                out[dev] = run(dev).float().cpu()[rows]
        err = ((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()).item()
        if not (torch.isfinite(out["cuda"]).all() and err < 0.03):
            raise AssertionError(f"{label} model check, {what}: err {err}")
        errs[what] = err

    qmc.reset_counts()
    rng = np.random.default_rng(12)
    ids = rng.integers(0, vocab, (1, win + 80))
    caches = {d: model.make_cache(1, win + 128, torch.bfloat16, device=d)
              for d in ("cpu", "cuda")}

    def call(dev, start, n):
        first = torch.tensor([start], dtype=torch.int32, device=dev)
        pos = first[:, None] + torch.arange(n, dtype=torch.int32, device=dev)[None]
        caches[dev] = caches[dev].advance(first, n)
        logits, caches[dev] = model(params[dev], t(ids[:, start:start + n], dev),
                                    caches[dev], pos)
        return logits

    for start, n in [(0, win), (win, 76)] + [(win + 76 + i, 1) for i in range(4)]:
        compare(f"dual {start}+{n}", lambda d: call(d, start, n))

    maxp = -(-(win + 200) // 64)
    tables = np.arange(3 * maxp, dtype=np.int32).reshape(3, maxp)[:, ::-1].copy()
    pools = {d: PagedKVPool.create(cfg.num_hidden_layers, 3 * maxp, hkv, dh,
                                   torch.bfloat16, True, device=d) for d in ("cpu", "cuda")}
    prompts = rng.integers(0, vocab, (3, win + 64)).astype(np.int32)
    for lane, n in ((0, win + 64), (1, 100)):
        compare(f"paged prefill lane {lane}", lambda d: model.paged_forward(
            params[d], t(prompts[lane:lane + 1, :n], d), pools[d], t(tables[lane:lane + 1], d),
            t(np.arange(n)[None], d), t([n], d))[0][0])
    ctx = np.array([win + 64, 100, 0])
    tok = np.array([prompts[0, -1], prompts[1, 99], 0])
    for step in range(3):
        frozen = np.array([False, step == 1, True])
        dpos, dctx = np.where(frozen, -1, ctx), np.where(frozen, 1, ctx + 1)
        compare(f"paged decode {step}", lambda d: model.paged_forward(
            params[d], t(tok[:, None], d), pools[d], t(tables, d), t(dpos[:, None], d),
            t(dctx, d))[0][:, 0], torch.from_numpy(~frozen))
        tok, ctx = rng.integers(0, vocab, 3), np.where(frozen, ctx, ctx + 1)
    cs = 40
    rider, rpos = prompts[2, :cs], np.arange(cs)
    steps = [([tok[0], tok[1], 0], [ctx[0], ctx[1], -1], [ctx[0] + 1, ctx[1] + 1, 1],
              rider, rpos, 2, cs),
             ([11, 12, prompts[2, cs]], [ctx[0] + 1, ctx[1] + 1, cs],
              [ctx[0] + 2, ctx[1] + 2, cs + 1], np.full(cs, -1), np.full(cs, -1), 0, 0)]
    for i, (dt, dp, dc, pi, pp, lane, pctx) in enumerate(steps):
        compare(f"mixed {i}", lambda d: model.mixed_forward(
            params[d], pools[d], t(dt, d), t(dp, d), t(dc, d), t(tables, d), t(pi, d),
            t(pp, d), t([lane], d), t([pctx], d), pf_any=bool((pi >= 0).any()))[0],
            torch.from_numpy(np.asarray(dp) >= 0))
    counts = dict(qmc.launch_counts)
    if not (counts["K1"] > 0 and counts["K2"] > 0 and counts["K3"] > 0):
        raise AssertionError(f"{label} model check did not run every kernel: {counts}")
    emit(dict(phase="gemma3", part="b: model vs CPU", geometry=label,
              layers=cfg.num_hidden_layers, sliding=int(model.is_sliding.sum()),
              window=win, kv="bf16 dual / int8 paged", norm_err=max(errs.values()),
              norm_err_per_step=errs, launches=counts))
    del params, gpu_params, pools, caches
    torch.cuda.empty_cache()
    return max(errs.values())


def gemma_word_tokenizer():
    """Offline word-level tokenizer with Gemma's control tokens."""
    import transformers
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    from pie_tpu_torch.tokenizer import Tokenizer
    from pie_tpu_torch.tokenizer.control_tokens import GEMMA

    words = ["hello", "world", "how", "are", "you", "be", "brief", "user", "model",
             "system", "<unk>"]
    specials = GEMMA.all_control_tokens
    raw = RawTok(models.WordLevel({w: i for i, w in enumerate(specials + words)},
                                  unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    return Tokenizer(transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token="<bos>", eos_token="<eos>", unk_token="<unk>"),
        GEMMA)


def gemma_chat_http(engine):
    """One chat with a system message over HTTP through create_app: the
    Gemma template folds the system text into the user turn; 200 and the
    biased word back."""
    import asyncio

    import aiohttp
    from aiohttp import web

    from pie_tpu_torch.server.app import create_app
    from pie_tpu_torch.server.config import Settings

    engine.tokenizer = tok = gemma_word_tokenizer()
    hello = tok.encode("hello", add_bos=False)[0]
    chat = [{"role": "system", "text": "be brief"}, {"role": "user", "text": "hello world"}]
    rendered = tok.decode(tok.apply_chat_template(chat, add_generation_prompt=True))
    if "system" in rendered or "be brief hello world" not in rendered:
        raise AssertionError(f"Gemma chat template: {rendered!r}")

    async def ask():
        runner = web.AppRunner(create_app(engine=engine, settings=Settings(),
                                          device=engine.device))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            async with aiohttp.ClientSession() as s:
                t0 = time.perf_counter()
                async with s.post(f"http://127.0.0.1:{port}/v1/chat/completions", json=dict(
                        messages=[{"role": "system", "content": "be brief"},
                                  {"role": "user", "content": "hello world"}],
                        max_tokens=8, temperature=0.0,
                        logit_bias={str(hello): 100.0})) as r:
                    return r.status, await r.json(), (time.perf_counter() - t0) * 1e3
        finally:
            await runner.cleanup()

    status, body, ms = asyncio.run(ask())
    content = body["choices"][0]["message"]["content"] if status == 200 else None
    if status != 200 or "hello" not in content:
        raise AssertionError(f"Gemma HTTP chat: {status} {body}")
    emit(dict(phase="gemma3", part="e: HTTP chat", status=status, ms=ms, content=content,
              usage=body["usage"], rendered=rendered))
    return status


def gemma_engine(card):
    """The 34-layer Gemma-3 4B single-stream engine (random INT4 g64 on the
    card): one counted request (64-token prompt, 128 decoded tokens: K1 7
    x 34 per decoded token, K2 7 x 34 per prefill, no K3), TTFT p50 of a
    512-token prompt, best-of-3 decode tok/s, TTFT of a 2,048-token prompt
    (two prefill chunks: the bound is the window) and its decode tok/s,
    steady chunks and the graphs."""
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.models.gemma3 import Gemma3Model
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model = Gemma3Model(gemma_config(G4, G4_LAYERS))
    params = model.init_quantized_params(seed=0)
    engine = InferenceEngine(model=model, params=params, max_seq_len=4096,
                             decode_chunk=128)
    prompt = list(range(1, 65))
    engine.generate(prompt, max_completion_tokens=9, temperature=0.0)  # warm up
    qmc.reset_counts()
    res = engine.generate([p + 7 for p in prompt], max_completion_tokens=129,
                          temperature=0.0)
    torch.cuda.synchronize()
    launches = dict(qmc.launch_counts)
    decoded = res.completion_tokens - 1
    per = G_PROJ * G4_LAYERS
    if (decoded != 128 or launches["K1"] != per * decoded or launches["K2"] != per
            or launches["K3"] or launches["K4"]):
        raise AssertionError(f"Gemma-3 main path launches {launches} for {decoded} tokens")

    def fresh(salt, n=512):
        return [1 + (i * 37 + salt * 101) % 100000 for i in range(n)]

    def ttft(p, new=2):
        gen = engine.generate_stream(p, max_completion_tokens=new, temperature=0.0)
        t0 = time.perf_counter()
        next(gen)
        dt = time.perf_counter() - t0
        n, t1 = 0, time.perf_counter()
        for _ in gen:
            n += 1
        return dt, (n / (time.perf_counter() - t1) if n else None)

    ttft(fresh(99))
    ttfts = sorted(ttft(fresh(s))[0] for s in range(5))
    best = max(ttft(prompt, 129)[1] for _ in range(3))
    ttft(fresh(98, 2048), 2)  # warm up the 1,024-token buckets
    qmc.reset_counts()
    long_ttft, long_tok_s = ttft(fresh(97, 2048), 129)
    long_k2 = qmc.launch_counts["K2"]
    prefills = {n: prefill_times(engine, fresh(6, n)) for n in (512, 2048)}
    chunks = -(-2048 // model.prefill_chunk_bound)  # 2: the bound is the window
    if long_k2 != chunks * per:
        raise AssertionError(f"2,048-token prompt: {long_k2} K2 launches, "
                             f"want {chunks} x {per}")
    steady = steady_single(engine)
    row = dict(phase="gemma3", part="c: engine", geometry="gemma3-4b int4 g64",
               layers=G4_LAYERS, ttft_p50_ms=ttfts[2] * 1e3, ttft_ms=[x * 1e3 for x in ttfts],
               decode_tok_s=best, ttft_2048_ms=long_ttft * 1e3,
               prefill_512=prefills[512], prefill_2048=prefills[2048],
               decode_tok_s_after_2048=long_tok_s, k2_per_2048_prompt=long_k2,
               k1_per_decoded_token=launches["K1"] / decoded, k2_per_prefill=launches["K2"],
               launches=launches, steady=steady, graphs=engine.core.graphs.stats(),
               card=card)
    emit(row)
    return engine, row


def gemma_paged(model, params, card):
    """The 34-layer 4B paged engine: 8 lanes, INT8 pages, 8-step chunks
    (bench.py's paged configuration): one counted run of 8 x (64-token
    prompt, 128 new) (K3 34 per device step), best of 2, steady chunks;
    then 8 lanes at 2,048-token contexts (sliding layers walk 16 of 32
    pages) as tok/s."""
    import gc

    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    lanes = 8
    engine = PagedEngine(model, params, num_lanes=lanes, num_pages=112,
                         max_pages_per_seq=12, kv_quantized=True)
    sched = Scheduler(engine, decode_steps=8)
    prompt = list(range(1, 65))
    sched.add_request(prompt, max_new_tokens=17, temperature=0.0)  # warm up
    sched.run_to_completion()
    best = 0.0
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
    if not (steps > 0 and launches["K3"] == G4_LAYERS * steps and launches["K1"] > 0
            and launches["K2"] > 0):
        raise AssertionError(f"Gemma-3 paged path: {launches} over {steps} steps")
    steady = steady_paged(sched, prompt, lanes)
    graph_stats = engine.graphs.stats()
    del sched, engine
    gc.collect()
    torch.cuda.empty_cache()

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
    row = dict(phase="gemma3", part="d: paged engine", geometry="gemma3-4b int4 g64",
               layers=G4_LAYERS, lanes=lanes, kv="int8 paged", decode_tok_s=best,
               ctx2048_tok_s=long_tok_s, device_steps=steps,
               k3_per_step=launches["K3"] / steps, launches=launches, steady=steady,
               graphs=graph_stats, card=card)
    emit(row)
    return row


def phase_gemma3(card):
    """Phase 12 (module docstring)."""
    import gc

    k3_err = gemma_k3_checks()
    k3_rows = {q: gemma_k3_timing(q) for q in (True, False)}
    checks = {label: gemma_model_check(label, cfg) for label, cfg in (
        ("gemma3-4b (2 layers: 1 sliding + 1 global)",
         gemma_config(G4, 2, sliding_window_pattern=2)),
        ("gemma3-1b (2 layers: 1 sliding + 1 global, Hkv 1)",
         gemma_config(G1, 2, sliding_window_pattern=2)))}
    engine, eng = gemma_engine(card)
    gemma_chat_http(engine)
    model, params = engine.model, engine.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    paged = gemma_paged(model, params, card)
    graphs = phase_graphs(model, params, "gemma3-4b int4 g64",
                          prompt=[1 + (i * 13) % 50000 for i in range(1100)],
                          max_seq_len=2048)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(k3=k3_rows, k3_err=k3_err, checks=checks, engine=eng, paged=paged,
                graphs=graphs)


# -- phase 13: Qwen2.5-VL-7B -----------------------------------------------------

# Qwen2.5-VL-7B-Instruct, from its public config.json: the text decoder ...
Q7 = dict(hidden_size=3584, intermediate_size=18944, num_attention_heads=28,
          num_key_value_heads=4, vocab_size=152064, rms_norm_eps=1e-6,
          rope_theta=1000000.0, mrope_section=(16, 24, 24), tie_word_embeddings=False,
          image_token_id=151655, video_token_id=151656)
Q7_LAYERS = 28
Q7_START, Q7_END = 151652, 151653  # vision start / end
# ... and its tower (windowed, RMSNorm, gated SiLU)
Q7_VISION = dict(depth=32, hidden_size=1280, intermediate_size=3420, num_heads=16,
                 out_hidden_size=3584, patch_size=14, temporal_patch_size=2,
                 spatial_merge_size=2, window_size=112,
                 fullatt_block_indexes=[7, 15, 23, 31], in_channels=3, hidden_act="silu")
# Qwen2-VL-7B-Instruct's tower (LayerNorm, quick-GELU MLP, full attention)
Q2_VISION = dict(depth=32, embed_dim=1280, hidden_size=3584, num_heads=16, mlp_ratio=4,
                 patch_size=14, temporal_patch_size=2, spatial_merge_size=2,
                 in_channels=3, hidden_act="quick_gelu")
Q_PROJ = 7  # wq, wk, wv, wo, wg, wu, wd: one K1 / K2 launch each per layer
Q_IMAGE = 224  # 16 x 16 patches: 64 merged tokens, four 8 x 8-patch windows
QWEN_SHAPES = [  # name, K, N, launches per decoded token / per prefill
    ("wq / wo", 3584, 3584, 2 * Q7_LAYERS),
    ("wk / wv", 3584, 512, 2 * Q7_LAYERS),
    ("wg / wu", 3584, 18944, 2 * Q7_LAYERS),
    ("wd", 18944, 3584, Q7_LAYERS),
    ("lm_head", 3584, 152064, 1),
]


def qwen_model(layers, vision=Q7_VISION, depth=None, seed=0):
    """A Qwen2.5-VL-7B-wide model with ``layers`` text layers (random INT4
    g64) and a random bf16 tower of ``depth`` blocks, on the card."""
    from pie_tpu_torch.models.qwen2_vl import Qwen2VLConfig, Qwen2VLModel

    vision = dict(vision, depth=depth or vision["depth"])
    model = Qwen2VLModel(Qwen2VLConfig(model_type="qwen2_5_vl",
                                       num_hidden_layers=layers, vision=vision, **Q7))
    params = model.init_quantized_params(seed=seed)
    params["vision"] = model.vision.init_params(seed=seed + 1)
    return model, params


def qwen_pixels(seed):
    """A seeded 224 x 224 RGB image as the model reads it: normalized and
    patchified with numpy (the port's patchify step; no Pillow), and its
    grid."""
    import numpy as np

    from pie_tpu_torch.vision.utils import (
        OPENAI_CLIP_MEAN,
        OPENAI_CLIP_STD,
        normalize,
        qwen2vl_patchify,
    )

    img = np.random.default_rng(seed).integers(0, 256, (Q_IMAGE, Q_IMAGE, 3))
    arr = normalize(img.astype(np.float32) / 255.0, OPENAI_CLIP_MEAN, OPENAI_CLIP_STD)
    g = Q_IMAGE // 14
    return qwen2vl_patchify(arr, 14, 2, 2), np.array([[1, g, g]])


def qwen_prompt(salt, before=9, after=9):
    """Text, one image's 64 placeholders between vision start and end,
    text (84 tokens)."""
    text = lambda n, o: [1 + (i * 37 + salt * 101 + o) % 100000 for i in range(n)]
    return (text(before, 0) + [Q7_START] + [Q7["image_token_id"]] * 64 + [Q7_END]
            + text(after, 7))


def qwen_kernels():
    """K1 (M = 1 and 8) and K2 (M = 512) at every Qwen2.5-VL-7B projection
    shape and the head, then K3 at its heads (28 / 4: a group of 7, D 128)
    against its plain version on INT8 and bf16 pages at contexts 1..2,048
    and timed at 8 lanes x 2,048 tokens."""
    rows = {}
    for m in (1, 8, 512):
        rows[m] = [(per, kernel_case(f"qwen2.5-vl-7b {name} M={m}", k, n, m))
                   for name, k, n, per in QWEN_SHAPES]
    worst = 0.0
    for quantized in (True, False):
        inputs = paged_inputs(PAGED_LENS, 28, 4, 128, quantized, seed=7)
        diff, norm = paged_check(inputs, 3, 0)
        worst = max(worst, diff)
        emit(dict(phase="qwen2.5-vl", part="a: K3 group 7 vs plain", quantized=quantized,
                  lens=PAGED_LENS, max_abs_err=diff, norm_err=norm))
        del inputs
    k3 = {q: paged_timing(q, heads=(28, 4, 128)) for q in (True, False)}
    torch.cuda.empty_cache()
    return rows, k3, max([worst] + [r["max_abs_err"] for r in k3.values()])


def qwen_model_check(label, layers, depth, tower_only=False, vision=Q7_VISION):
    """A cut Qwen model at full width, card against the CPU plain path on
    the same random weights (INT4 g64 text, bf16 tower): the tower's
    merged features of one 224 x 224 image; unless ``tower_only``, the
    image prompt through ``__call__`` (its t/h/w streams), one decode step
    at its offset, then over an INT8 paged pool one mixed step (the
    prompt's embeddings as a rider for lane 1, which wakes on its last
    token in the same step, lane 0 on its first token) and one paged decode
    step of both lanes at their offsets; logits within 0.03 normalized.
    On the card alone: the mixed step's image lane against ``__call__``'s
    last prompt position (0.03)."""
    import numpy as np

    from pie_tpu_torch.cache.kv_cache import make_kv_cache
    from pie_tpu_torch.cache.paged import PagedKVPool
    from pie_tpu_torch.models.qwen2_vl import image_positions, text_positions3
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model, gpu_params = qwen_model(layers or 1, vision=vision, depth=depth, seed=3)
    params = {"cpu": to_device(gpu_params, "cpu"), "cuda": gpu_params}
    px, grid = qwen_pixels(1)
    prompt = qwen_prompt(1)
    n = len(prompt)
    errs, outs = {}, {}

    def compare(what, run, rows=slice(None)):
        out = {}
        for dev in ("cpu", "cuda"):
            with torch.no_grad():
                out[dev] = run(dev).float().cpu()[rows]
        err = ((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()).item()
        if not (torch.isfinite(out["cuda"]).all() and err < 0.03):
            raise AssertionError(f"{label} model check, {what}: err {err}")
        errs[what] = err
        outs[what] = out["cuda"]

    qmc.reset_counts()
    ids = {d: torch.tensor([prompt], dtype=torch.int32, device=d) for d in ("cpu", "cuda")}
    feats = {d: model.vision.forward(params[d]["vision"], torch.from_numpy(px).to(d), grid)
             for d in ("cpu", "cuda")}
    compare("tower", lambda d: feats[d])
    if tower_only:
        emit(dict(phase="qwen2.5-vl", part="b: model vs CPU", geometry=label,
                  tower_blocks=depth, norm_err=errs["tower"]))
        return errs["tower"]
    emb = {d: model.embed_with_images(params[d], ids[d], torch.from_numpy(px).to(d), grid)
           for d in ("cpu", "cuda")}
    p3, delta = image_positions(model, np.array([prompt]), grid, n)
    t = lambda a, d: torch.from_numpy(np.asarray(a, np.int32)).to(d)
    caches = {d: make_kv_cache(layers, 1, 128, 4, 128, torch.bfloat16, device=d)
              for d in ("cpu", "cuda")}

    def call(dev, start, count, **kw):
        first = torch.tensor([start], dtype=torch.int32, device=dev)
        pos = first[:, None] + torch.arange(count, dtype=torch.int32, device=dev)[None]
        caches[dev] = caches[dev].advance(first, count)
        logits, caches[dev] = model(params[dev], kw.pop("ids", ids[dev]), caches[dev],
                                    pos, **kw)
        return logits

    compare("call image prefill", lambda d: call(d, 0, n, inputs_embeds=emb[d],
                                                 positions3=t(p3, d)))
    tok = [[int(outs["call image prefill"][0, -1].argmax())]]
    compare("call decode", lambda d: call(
        d, n, 1, ids=t(tok, d), positions3=text_positions3(t([[n - delta]], d))))
    maxp = 4
    tables = np.arange(2 * maxp, dtype=np.int32).reshape(2, maxp)[:, ::-1].copy()
    pools = {d: PagedKVPool.create(layers, 2 * maxp, 4, 128, torch.bfloat16, True,
                                   device=d) for d in ("cpu", "cuda")}
    cs = 96
    rider, rpos = np.full(cs, -1), np.full(cs, -1)
    rider[:n - 1], rpos[:n - 1] = prompt[:-1], np.arange(n - 1)
    rp3 = np.full((3, cs), -1)
    rp3[:, :n - 1] = p3[:, 0, :n - 1]
    deltas = [3, delta]

    def rider_embeds(d):
        e = torch.zeros((cs, emb[d].shape[-1]), dtype=emb[d].dtype, device=d)
        e[:n - 1] = emb[d][0, :n - 1]
        return e

    compare("mixed image rider", lambda d: model.mixed_forward(
        params[d], pools[d], t([11, prompt[-1]], d), t([0, n - 1], d), t([1, n], d),
        t(tables, d), t(rider, d), t(rpos, d), t([1], d), t([n - 1], d),
        pf_embeds=rider_embeds(d), pf_pos3=t(rp3, d), pos_delta=t(deltas, d))[0])
    lane = outs["mixed image rider"][1]
    want = outs["call image prefill"][0, -1]
    card_err = ((lane - want).abs().max() / want.abs().max()).item()
    if not card_err < 0.03:
        raise AssertionError(f"{label}: mixed image lane vs __call__ err {card_err}")
    nxt = [int(a.argmax()) for a in outs["mixed image rider"]]
    compare("paged decode", lambda d: model.paged_forward(
        params[d], t([[nxt[0]], [nxt[1]]], d), pools[d], t(tables, d), t([[1], [n]], d),
        t([2, n + 1], d), pos_delta=t(deltas, d))[0][:, 0])
    counts = dict(qmc.launch_counts)
    if not (counts["K1"] > 0 and counts["K2"] > 0 and counts["K3"] > 0
            and counts["K5"] > 0):
        raise AssertionError(f"{label} model check did not run every kernel: {counts}")
    emit(dict(phase="qwen2.5-vl", part="b: model vs CPU", geometry=label, layers=layers,
              tower_blocks=depth, kv="bf16 contiguous / int8 paged", pos_delta=delta,
              norm_err=max(errs.values()), norm_err_per_step=errs,
              mixed_image_lane_vs_call=card_err, launches=counts))
    del params, gpu_params, pools, caches
    torch.cuda.empty_cache()
    return max(errs.values())


def qwen_mixed_vs_call(model, params, image):
    """On the card: the image prompt through ``__call__`` (a bf16 cache, its
    t/h/w streams) and as a rider of one mixed step over an INT8 pool (its
    embeddings, lane 1 waking on its last token in the same step); the
    image lane's logits against ``__call__``'s last position, normalized
    max error (limit 0.03)."""
    import numpy as np

    from pie_tpu_torch.cache.kv_cache import make_kv_cache
    from pie_tpu_torch.cache.paged import PagedKVPool

    prompt, kw = image["prompt"], image["kw"]
    n, emb, layers = len(prompt), kw["prompt_embeds"], model.config.num_hidden_layers
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    cache = make_kv_cache(layers, 1, 128, 4, 128, torch.bfloat16, device="cuda")
    cache = cache.advance(t([0]), n)
    p3 = np.asarray(kw["positions3"])
    with torch.no_grad():
        want = model(params, t([prompt]), cache, t([np.arange(n)]), inputs_embeds=emb[None],
                     positions3=t(p3[:, None]))[0][0, -1]
        cs = 96
        rider, rpos, rp3 = np.full(cs, -1), np.full(cs, -1), np.full((3, cs), -1)
        rider[:n - 1], rpos[:n - 1], rp3[:, :n - 1] = prompt[:-1], np.arange(n - 1), p3[:, :-1]
        pemb = torch.zeros((cs, emb.shape[-1]), dtype=emb.dtype, device="cuda")
        pemb[:n - 1] = emb[:n - 1]
        tables = t([[3, 2, 1, 0], [7, 6, 5, 4]])
        pool = PagedKVPool.create(layers, 8, 4, 128, torch.bfloat16, True, device="cuda")
        got = model.mixed_forward(params, pool, t([11, prompt[-1]]), t([0, n - 1]),
                                  t([1, n]), tables, t(rider), t(rpos), t([1]), t([n - 1]),
                                  pf_embeds=pemb, pf_pos3=t(rp3),
                                  pos_delta=t([0, kw["pos_delta"]]))[0][1]
    err = ((got - want).abs().max() / want.abs().max()).item()
    if not (torch.isfinite(got).all() and err < 0.03):
        raise AssertionError(f"Qwen mixed image lane vs __call__: err {err}")
    return err


def qwen_word_tokenizer():
    """Offline word-level tokenizer with ChatML's control tokens."""
    import transformers
    from tokenizers import Tokenizer as RawTok
    from tokenizers import models, pre_tokenizers

    from pie_tpu_torch.tokenizer import Tokenizer
    from pie_tpu_torch.tokenizer.control_tokens import CHATML

    words = ["hello", "world", "what", "is", "in", "this", "image", "user", "assistant",
             "system", "<unk>"]
    specials = CHATML.all_control_tokens
    raw = RawTok(models.WordLevel({w: i for i, w in enumerate(specials + words)},
                                  unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    raw.add_special_tokens(specials)
    return Tokenizer(transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw, bos_token=None, eos_token="<|im_end|>", unk_token="<unk>"),
        CHATML)


def image_ttft(engine, prompt, image):
    """One image request's first token, split: the tower and scatter (CUDA
    events around ``_image_embeds``, which runs them eagerly over the whole
    prompt, and, for Qwen2-VL, the host's M-RoPE positions), the prefill's
    device ms (events around the replayed prefill graphs: a Gemma-3 prompt
    past its window's head chunks, then the tail) and the host ms to queue
    them (the head-chunk split, the tail's ids and padded embeddings, the
    replays), and the request's TTFT on the host clock."""
    import numpy as np

    from pie_tpu_torch.models.qwen2_vl import image_positions

    out = {"p3": None, "delta": 0}

    def tower():
        out["emb"] = engine._image_embeds(prompt, image["pixel_values"],
                                          image.get("image_kwargs"))
        if getattr(engine.model, "uses_mrope", False):  # Qwen2-VL: no head chunks
            ids = np.zeros((1, engine._prefill_bucket(len(prompt))), np.int32)
            ids[0, :len(prompt)] = prompt
            out["p3"], out["delta"] = image_positions(
                engine.model, ids, image["image_kwargs"]["grid_thw"], len(prompt))

    tower_ms = event_ms(tower)
    p3, delta = out["p3"], out["delta"]
    if p3 is not None:
        engine.core.set_pos_delta(engine._one(delta))
    sampling, pen = engine._sampling({"temperature": 0.0}), engine._penalties({})
    host = []

    def prefill():
        t0 = time.perf_counter()
        tail, first, emb = engine._prefill_head_chunks(
            list(prompt), 0, sampling, pen, *engine._empty_bias, "greedy", out["emb"])
        ids = np.zeros((1, engine._prefill_bucket(len(tail))), np.int32)
        ids[0, :len(tail)] = tail
        emb = torch.nn.functional.pad(emb, (0, 0, 0, ids.shape[1] - len(tail)))
        engine.state, _, _ = engine.core._prefill(
            engine.params, engine.state, ids, engine._one(len(tail)), engine._one(first),
            sampling, pen, *engine._empty_bias, sampler_kind="greedy", inputs_embeds=emb,
            positions3=p3)
        host.append((time.perf_counter() - t0) * 1e3)

    prefill_ms = event_ms(prefill)
    gen = engine.generate_stream(prompt, max_completion_tokens=2, temperature=0.0, **image)
    t0 = time.perf_counter()
    next(gen)
    ttft = (time.perf_counter() - t0) * 1e3
    for _ in gen:
        pass
    return dict(tower_ms=tower_ms, prefill_event_ms=prefill_ms, prefill_enqueue_ms=host[0],
                ttft_ms=ttft, pos_delta=delta, tokens=len(prompt),
                chunks=-(-len(prompt) // (getattr(engine.model, "prefill_chunk_bound", None)
                                           or len(prompt))))


def qwen_engine(card):
    """The 28-layer Qwen2.5-VL-7B single-stream engine (random INT4 g64 text,
    a 32-block bf16 tower): one counted text request (64-token prompt, 128
    decoded tokens: K1 7 x 28 + 1 per decoded token, K2 7 x 28 + 1 per
    prefill, no K3 or K4), TTFT p50 of 5 distinct 512-token prompts, an
    image prompt's TTFT split into tower, prefill device and enqueue ms,
    128 greedy tokens after an image prompt as tok/s; then one captured
    image prefill and 16 decode steps against an eager twin (equal tokens,
    logits within 1e-3 normalized, caches byte-equal)."""
    from pie_tpu_torch.cache.kv_cache import cache_tensors
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model, params = qwen_model(Q7_LAYERS)
    engine = InferenceEngine(model=model, params=params, max_seq_len=4096,
                             decode_chunk=128)
    prompt = list(range(1, 65))
    engine.generate(prompt, max_completion_tokens=9, temperature=0.0)  # warm up
    qmc.reset_counts()
    res = engine.generate([p + 7 for p in prompt], max_completion_tokens=129,
                          temperature=0.0)
    torch.cuda.synchronize()
    launches = dict(qmc.launch_counts)
    decoded = res.completion_tokens - 1
    per = Q_PROJ * Q7_LAYERS + 1
    if (decoded != 128 or launches["K1"] != per * decoded or launches["K2"] != per
            or launches["K3"] or launches["K4"]):
        raise AssertionError(f"Qwen main path launches {launches} for {decoded} tokens")

    def fresh(salt, n=512):
        return [1 + (i * 37 + salt * 101) % 100000 for i in range(n)]

    def ttft(p, new=2, **kw):
        gen = engine.generate_stream(p, max_completion_tokens=new, temperature=0.0, **kw)
        t0 = time.perf_counter()
        next(gen)
        dt = time.perf_counter() - t0
        n, t1 = 0, time.perf_counter()
        for _ in gen:
            n += 1
        return dt, (n / (time.perf_counter() - t1) if n else None)

    ttft(fresh(99))
    ttfts = sorted(ttft(fresh(s))[0] for s in range(5))
    px, grid = qwen_pixels(2)
    image = dict(pixel_values=px, image_kwargs={"grid_thw": grid})
    ttft(qwen_prompt(2), **image)  # the image prefill's capture
    split = image_ttft(engine, qwen_prompt(3), image)
    image_tok_s = max(ttft(qwen_prompt(4), 129, **image)[1] for _ in range(2))
    text_tok_s = ttft(prompt, 129)[1]

    twin = InferenceEngine(model=model, params=params, max_seq_len=4096,
                           decode_chunk=16, prompt_cache=False)
    twin.core.graphs = eager_steps(twin.core.graphs)
    graphed = InferenceEngine(model=model, params=params, max_seq_len=4096,
                              decode_chunk=16, prompt_cache=False)
    taps, streams = [], []
    for e in (graphed, twin):
        e.generate(qwen_prompt(5), max_completion_tokens=17, temperature=0.0, **image)
        e.core.graphs = Tap(e.core.graphs)
        taps.append(e.core.graphs)
        streams.append(e.generate(qwen_prompt(6), max_completion_tokens=17,
                                  temperature=0.0, **image).token_ids)
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(taps[0].logits, taps[1].logits)]
    caches = [cache_tensors(e.state.cache) for e in (graphed, twin)]
    cache_equal = all(torch.equal(t, caches[1][k]) for k, t in caches[0].items())
    if not (streams[0] == streams[1] and len(streams[0]) == 17 and max(errs) < 1e-3
            and cache_equal and taps[0].inner.replays >= 17):
        raise AssertionError(f"Qwen image graphs vs eager: {streams} {max(errs)} "
                             f"{cache_equal} {taps[0].inner.replays}")
    graph_check = dict(tokens_equal=True, steps=len(errs), max_norm_err=max(errs),
                       cache_byte_equal=cache_equal, replays=taps[0].inner.replays)
    del twin, graphed, taps, caches
    steady = steady_single(engine)
    row = dict(phase="qwen2.5-vl", part="c: engine", geometry="qwen2.5-vl-7b int4 g64",
               layers=Q7_LAYERS, tower_blocks=32, ttft_p50_ms=ttfts[2] * 1e3,
               ttft_ms=[x * 1e3 for x in ttfts], decode_tok_s=text_tok_s,
               image=split, image_decode_tok_s=image_tok_s, graphs_vs_eager=graph_check,
               k1_per_decoded_token=launches["K1"] / decoded, k2_per_prefill=launches["K2"],
               launches=launches, steady=steady, graphs=engine.core.graphs.stats(),
               card=card)
    emit(row)
    return engine, row


def qwen_paged(engine1, card):
    """The 28-layer paged engine (8 lanes, bf16 pages, 8-step chunks): one
    counted run of 6 text lanes (64-token prompts) and 2 image lanes (84
    tokens: their embeddings ride mixed steps), 128 new tokens each (K3 28
    per device step, counted under replay) as aggregate tok/s; each image
    lane's first token equals the single-stream engine's on the same
    request; at 28 layers, a mixed step with an image rider against
    ``__call__`` on the same prompt (``qwen_mixed_vs_call``); steady
    chunks."""
    import gc

    import numpy as np

    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler
    from pie_tpu_torch.models.qwen2_vl import image_positions
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model, params = engine1.model, engine1.params
    lanes = 8
    engine = PagedEngine(model, params, num_lanes=lanes, num_pages=128,
                         max_pages_per_seq=14)
    sched = Scheduler(engine, decode_steps=8)
    images = []
    for seed in (11, 12, 13):
        px, grid = qwen_pixels(seed)
        prompt = qwen_prompt(seed)
        with torch.no_grad():
            emb = model.embed_with_images(
                params, torch.tensor([prompt], dtype=torch.int32, device="cuda"),
                torch.from_numpy(px).cuda(), grid)[0]
        p3, delta = image_positions(model, np.array([prompt]), grid, len(prompt))
        images.append(dict(prompt=prompt, kw=dict(prompt_embeds=emb, positions3=p3[:, 0],
                                                  pos_delta=delta),
                           image=dict(pixel_values=px, image_kwargs={"grid_thw": grid})))
    text = list(range(1, 65))
    sched.add_request(images[2]["prompt"], max_new_tokens=9, temperature=0.0,
                      **images[2]["kw"])  # warm up: the embeds graphs
    sched.add_request(text, max_new_tokens=17, temperature=0.0)
    sched.run_to_completion()
    qmc.reset_counts()
    steps0 = engine.device_steps
    seqs = [sched.add_request([t + i for t in text], max_new_tokens=128, temperature=0.0)
            for i in range(lanes - 2)]
    seqs += [sched.add_request(im["prompt"], max_new_tokens=128, temperature=0.0,
                               **im["kw"]) for im in images[:2]]
    t0 = time.perf_counter()
    sched.run_to_completion()
    torch.cuda.synchronize()
    tok_s = sum(len(s.output_ids) for s in seqs) / (time.perf_counter() - t0)
    launches = dict(qmc.launch_counts)
    steps = engine.device_steps - steps0
    if not (steps > 0 and launches["K3"] == Q7_LAYERS * steps and launches["K1"] > 0
            and launches["K2"] > 0 and all(len(s.output_ids) == 128 for s in seqs)):
        raise AssertionError(f"Qwen paged path: {launches} over {steps} steps")
    first = [engine1.generate(im["prompt"], max_completion_tokens=1, temperature=0.0,
                              **im["image"]).token_ids[0] for im in images[:2]]
    lane_first = [s.output_ids[0] for s in seqs[-2:]]
    if lane_first != first:
        raise AssertionError(f"image lanes' first tokens {lane_first}, single stream {first}")
    keys = engine.graphs.keys
    if not any(k[0] == "mixed" and k[5] for k in keys):
        raise AssertionError(f"no image rider step among {keys}")
    mixed_err = qwen_mixed_vs_call(model, params, images[0])
    steady = steady_paged(sched, text, lanes)
    graph_stats = engine.graphs.stats()
    del sched, engine
    gc.collect()
    torch.cuda.empty_cache()
    row = dict(phase="qwen2.5-vl", part="d: paged engine", geometry="qwen2.5-vl-7b int4 g64",
               layers=Q7_LAYERS, lanes=lanes, image_lanes=2, kv="bf16 paged",
               decode_tok_s=tok_s, device_steps=steps, k3_per_step=launches["K3"] / steps,
               image_lane_first_tokens=lane_first, single_stream_first_tokens=first,
               mixed_image_lane_vs_call=mixed_err,
               launches=launches, steady=steady, graphs=graph_stats, card=card)
    emit(row)
    return row


def qwen_chat_http(engine1):
    """One chat with an image (the OpenAI image_url part, a PNG data URI)
    over HTTP through create_app, on the single-stream engine and on a
    batching engine over the same weights: 200 and usage on both. Needs
    Pillow to decode the PNG; without it the line says "pillow": false."""
    import asyncio
    import base64
    import io

    import aiohttp
    import numpy as np
    from aiohttp import web

    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
    from pie_tpu_torch.server.app import create_app
    from pie_tpu_torch.server.config import Settings

    try:
        from PIL import Image
    except ImportError:
        emit(dict(phase="qwen2.5-vl", part="e: HTTP image chat", pillow=False))
        return None
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(21).integers(
        0, 256, (Q_IMAGE, Q_IMAGE, 3), dtype=np.uint8)).save(buf, format="PNG")
    uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    engine1.tokenizer = tok = qwen_word_tokenizer()
    batched = BatchedInferenceEngine(model=engine1.model, params=engine1.params,
                                     tokenizer=tok, num_lanes=2, num_pages=16,
                                     max_pages_per_seq=8)

    async def ask(engine, batching):
        runner = web.AppRunner(create_app(engine=engine, settings=Settings(batching=batching),
                                          device=engine.device))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            async with aiohttp.ClientSession() as s:
                t0 = time.perf_counter()
                async with s.post(f"http://127.0.0.1:{port}/v1/chat/completions", json=dict(
                        messages=[{"role": "user", "content": [
                            {"type": "text", "text": "what is in this image"},
                            {"type": "image_url", "image_url": {"url": uri}}]}],
                        max_tokens=8, temperature=0.0)) as r:
                    return r.status, await r.json(), (time.perf_counter() - t0) * 1e3
        finally:
            await runner.cleanup()

    out = {}
    try:
        for name, engine, batching in (("single", engine1, False), ("batched", batched, True)):
            status, body, ms = asyncio.run(ask(engine, batching))
            if status != 200 or body["usage"]["completion_tokens"] < 1:
                raise AssertionError(f"Qwen HTTP image chat ({name}): {status} {body}")
            out[name] = dict(status=status, ms=ms, usage=body["usage"])
    finally:
        batched.shutdown()
    emit(dict(phase="qwen2.5-vl", part="e: HTTP image chat", pillow=True,
              image_tokens=engine1.image_processor.tokens_per_image, **out))
    return out


def phase_qwen2vl(card):
    """Phase 13 (module docstring)."""
    import gc

    rows, k3, k3_err = qwen_kernels()
    checks = {
        "qwen2.5-vl-7b (4 text layers, 8 tower blocks: full attention at 7)":
            qwen_model_check("qwen2.5-vl-7b", 4, 8),
        "qwen2-vl-7b tower (4 blocks)":
            qwen_model_check("qwen2-vl-7b tower", 0, 4, tower_only=True, vision=Q2_VISION),
    }
    engine, eng = qwen_engine(card)
    paged = qwen_paged(engine, card)
    http_out = qwen_chat_http(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, k3=k3, k3_err=k3_err, checks=checks, engine=eng, paged=paged,
                http=http_out)


# -- phase 14: Gemma-3 4B image inputs --------------------------------------------

# google/gemma-3-4b-it config.json: the SigLIP-So400m tower (vision_config) at
# 896 px (64 x 64 patches of 14 px: 4,096 tokens), 256 tokens an image after
# the 4 x 4 pool, and the image tokens
G4_VISION = dict(hidden_size=1152, intermediate_size=4304, num_hidden_layers=27,
                 num_attention_heads=16, image_size=896, patch_size=14, num_channels=3,
                 layer_norm_eps=1e-6)
G4_IMAGE = dict(mm_tokens_per_image=256, image_token_id=262144)
G4_BOI, G4_EOI = 255999, 256000  # <start_of_image>, <end_of_image>
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores, data sheet


def gemma_vlm(layers, blocks=None, seed=0, **extra):
    """A Gemma-3 4B-wide VLM on the card: ``layers`` text layers (random INT4
    g64) and a random bf16 SigLIP tower of ``blocks`` blocks (27: So400m)."""
    from pie_tpu_torch.models.gemma3 import Gemma3Model

    vision = dict(G4_VISION, num_hidden_layers=blocks or G4_VISION["num_hidden_layers"])
    model = Gemma3Model(gemma_config(G4, layers, vision=vision, **G4_IMAGE, **extra))
    params = model.init_quantized_params(seed=seed)
    params["vision"] = model.vision.init_params(seed=seed + 1)
    return model, params


def gemma_pixels(seed, n=1):
    """``n`` seeded 896 x 896 RGB images as the SigLIP processor leaves
    them (already square at its size: normalized with mean and std 0.5),
    [n, 3, 896, 896] f32, with numpy alone."""
    import numpy as np

    from pie_tpu_torch.vision.utils import SiglipImageProcessor, normalize

    proc, size = SiglipImageProcessor(), G4_VISION["image_size"]
    rng = np.random.default_rng(seed)
    return np.stack([normalize(rng.integers(0, 256, (size, size, 3)).astype(np.float32)
                               / 255.0, proc.image_mean, proc.image_std)
                     for _ in range(n)])


def gemma_image_prompt(salt, before=9, after=9):
    """Text, one image's 256 placeholders between <start_of_image> and
    <end_of_image>, text (276 tokens at the defaults)."""
    text = lambda n, o: [1 + (i * 37 + salt * 101 + o) % 100000 for i in range(n)]
    return (text(before, 0) + [G4_BOI] + [G4_IMAGE["image_token_id"]] * 256 + [G4_EOI]
            + text(after, 7))


def tower_work(model, n=1) -> dict:
    """Operations and bytes of the tower and projector on ``n`` images, from
    the shapes: the patch embedding, per block q/k/v/o (4 D x D) and the MLP
    (2 D x Di) over T tokens, attention's QK^T and PV (4 T^2 D), the
    projector's product; weights (bf16) read once, pixels read and the
    projected rows written once (f32). ``bound_ms`` at the bf16 tensor
    cores' 989 TFLOP/s (the tower's work at bf16), ``bound_f32_ms`` at the
    67 TFLOP/s of float32 outside them (how the port computes it)."""
    v = model.vision
    d, di, blocks, p = v.hidden_size, v.intermediate_size, v.num_layers, v.patch_size
    t = v.patches ** 2
    out = v.tokens_per_image * v.text_hidden
    flops = n * (2 * t * 3 * p * p * d
                 + blocks * (2 * t * (4 * d * d + 2 * d * di) + 4 * t * t * d)
                 + 2 * v.tokens_per_image * d * v.text_hidden)
    weights = (3 * p * p * d + d + t * d + 2 * d
               + blocks * (4 * d * d + 2 * d * di + 9 * d + di) + d + d * v.text_hidden)
    nbytes = 2 * weights + n * 4 * (3 * v.image_size ** 2 + out)
    bb, bo = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(bb, bo),
                bound_by="bytes" if bb >= bo else "operations",
                bound_f32_ms=max(bb, flops / FP32_FLOP_PER_S * 1e3))


def gemma_vision_check(label, layers=2, blocks=2):
    """A cut Gemma-3 4B VLM at full width (2 text layers, 1 sliding + 1
    global; ``blocks`` tower blocks), card against the CPU plain path on the
    same random weights (INT4 g64 text, bf16 tower): one full 896 x 896
    image through the tower (features) and the projector; the image prompt
    (276 tokens) through ``__call__`` over the DualKVCache, two decode
    steps; then over an INT8 paged pool one mixed step (the prompt's
    embeddings as a rider for lane 1, which wakes on its last token in the
    same step) and a paged decode step of both lanes; logits within 0.03
    normalized. On the card alone: the mixed step's image lane against
    ``__call__``'s last prompt position (0.03)."""
    import numpy as np

    from pie_tpu_torch.cache.paged import PagedKVPool
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model, gpu_params = gemma_vlm(layers, blocks, seed=3, sliding_window_pattern=2)
    params = {"cpu": to_device(gpu_params, "cpu"), "cuda": gpu_params}
    px = gemma_pixels(1)
    prompt = gemma_image_prompt(1)
    n = len(prompt)
    errs, outs = {}, {}

    def compare(what, run, rows=slice(None)):
        out = {}
        for dev in ("cpu", "cuda"):
            with torch.no_grad():
                out[dev] = run(dev).float().cpu()[rows]
        err = ((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()).item()
        if not (torch.isfinite(out["cuda"]).all() and err < 0.03):
            raise AssertionError(f"{label} model check, {what}: err {err}")
        errs[what] = err
        outs[what] = out["cuda"]

    qmc.reset_counts()
    vp = lambda d: params[d]["vision"]
    feats = {d: model.vision.forward(vp(d), torch.from_numpy(px).to(d)) for d in ("cpu", "cuda")}
    compare("tower", lambda d: feats[d])
    compare("projector", lambda d: model.vision.project(vp(d), feats[d]))
    del feats
    ids = {d: torch.tensor([prompt], dtype=torch.int32, device=d) for d in ("cpu", "cuda")}
    emb = {d: model.embed_with_images(params[d], ids[d], torch.from_numpy(px).to(d))
           for d in ("cpu", "cuda")}
    t = lambda a, d: torch.from_numpy(np.asarray(a, np.int32)).to(d)
    caches = {d: model.make_cache(1, 512, torch.bfloat16, device=d) for d in ("cpu", "cuda")}

    def call(dev, start, count, **kw):
        first = torch.tensor([start], dtype=torch.int32, device=dev)
        pos = first[:, None] + torch.arange(count, dtype=torch.int32, device=dev)[None]
        caches[dev] = caches[dev].advance(first, count)
        logits, caches[dev] = model(params[dev], kw.pop("ids", ids[dev]), caches[dev],
                                    pos, **kw)
        return logits

    compare("call image prefill", lambda d: call(d, 0, n, inputs_embeds=emb[d]))
    tok = int(outs["call image prefill"][0, -1].argmax())
    for i in range(2):
        compare(f"call decode {i}", lambda d: call(d, n + i, 1, ids=t([[tok]], d)))
        tok = int(outs[f"call decode {i}"][0, -1].argmax())
    maxp = 6
    tables = np.arange(2 * maxp, dtype=np.int32).reshape(2, maxp)[:, ::-1].copy()
    pools = {d: PagedKVPool.create(layers, 2 * maxp, G4["num_key_value_heads"],
                                   G4["head_dim"], torch.bfloat16, True, device=d)
             for d in ("cpu", "cuda")}
    cs = 288
    rider, rpos = np.full(cs, -1), np.full(cs, -1)
    rider[:n - 1], rpos[:n - 1] = prompt[:-1], np.arange(n - 1)

    def rider_embeds(d):
        e = torch.zeros((cs, emb[d].shape[-1]), dtype=emb[d].dtype, device=d)
        e[:n - 1] = emb[d][0, :n - 1]
        return e

    compare("mixed image rider", lambda d: model.mixed_forward(
        params[d], pools[d], t([11, prompt[-1]], d), t([0, n - 1], d), t([1, n], d),
        t(tables, d), t(rider, d), t(rpos, d), t([1], d), t([n - 1], d),
        pf_embeds=rider_embeds(d))[0])
    lane = outs["mixed image rider"][1]
    want = outs["call image prefill"][0, -1]
    card_err = ((lane - want).abs().max() / want.abs().max()).item()
    if not card_err < 0.03:
        raise AssertionError(f"{label}: mixed image lane vs __call__ err {card_err}")
    nxt = [int(a.argmax()) for a in outs["mixed image rider"]]
    compare("paged decode", lambda d: model.paged_forward(
        params[d], t([[nxt[0]], [nxt[1]]], d), pools[d], t(tables, d), t([[1], [n]], d),
        t([2, n + 1], d))[0][:, 0])
    counts = dict(qmc.launch_counts)
    if not (counts["K1"] > 0 and counts["K2"] > 0 and counts["K3"] > 0):
        raise AssertionError(f"{label} model check did not run every kernel: {counts}")
    row = dict(phase="gemma3 vision", part="a: model vs CPU", geometry=label, layers=layers,
               tower_blocks=blocks, image_px=G4_VISION["image_size"], prompt_tokens=n,
               kv="bf16 dual / int8 paged", norm_err=max(errs.values()),
               norm_err_per_step=errs, tower_norm_err=errs["tower"],
               projector_norm_err=errs["projector"], mixed_image_lane_vs_call=card_err,
               launches=counts)
    emit(row)
    del params, gpu_params, pools, caches, emb
    torch.cuda.empty_cache()
    return row


def gemma_long_image_prompt(salt):
    """1,300 tokens: 700 of text, the image (258), 342 of text: a head chunk
    of 1,024 (the window), the image across its end, and a 276-token
    tail."""
    return gemma_image_prompt(salt, before=700, after=342)


def gemma_vision_engine(card):
    """The 34-layer Gemma-3 4B single-stream engine with the 27-block So400m
    tower (random INT4 g64 text, bf16 tower): the tower's ms per image
    (CUDA events, median of 3) beside its bound; one counted image request
    (276-token prompt, 128 decoded tokens: K1 238 per decoded token, K2 238
    for its one prefill chunk, no K3 or K4); the image prompt's TTFT split
    (tower, prefill device and enqueue ms) and that of a 1,300-token image
    prompt (two prefill chunks, 476 K2 launches); decode tok/s after an
    image; then the captured image prefills (the short prompt's, and the
    long one's head chunk and tail) and 16 decode steps against an eager
    twin (equal tokens, logits within 1e-3 normalized, caches byte-equal)."""
    from pie_tpu_torch.cache.kv_cache import cache_tensors
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model, params = gemma_vlm(G4_LAYERS)
    engine = InferenceEngine(model=model, params=params, max_seq_len=4096,
                             decode_chunk=128)
    image = dict(pixel_values=gemma_pixels(2))
    vp = params["vision"]
    px = torch.from_numpy(image["pixel_values"]).cuda()

    def tower():
        with torch.no_grad():
            model.vision.project(vp, model.vision.forward(vp, px))

    tower()
    tower_ms = sorted(event_ms(tower) for _ in range(3))
    work = tower_work(model)

    def ttft(p, new=2, **kw):
        gen = engine.generate_stream(p, max_completion_tokens=new, temperature=0.0, **kw)
        t0 = time.perf_counter()
        next(gen)
        dt = time.perf_counter() - t0
        n, t1 = 0, time.perf_counter()
        for _ in gen:
            n += 1
        return dt, (n / (time.perf_counter() - t1) if n else None)

    ttft(gemma_image_prompt(2), 9, **image)  # warm up: the image prefill's capture
    qmc.reset_counts()
    res = engine.generate(gemma_image_prompt(3), max_completion_tokens=129,
                          temperature=0.0, **image)
    torch.cuda.synchronize()
    launches = dict(qmc.launch_counts)
    decoded = res.completion_tokens - 1
    per = G_PROJ * G4_LAYERS
    if (decoded != 128 or launches["K1"] != per * decoded or launches["K2"] != per
            or launches["K3"] or launches["K4"]):
        raise AssertionError(f"Gemma-3 image path launches {launches} for {decoded} tokens")
    split = image_ttft(engine, gemma_image_prompt(4), image)
    image_tok_s = max(ttft(gemma_image_prompt(5), 129, **image)[1] for _ in range(2))
    ttft(gemma_long_image_prompt(6), 2, **image)  # the 1,024 bucket's embeds capture
    qmc.reset_counts()
    long_split = image_ttft(engine, gemma_long_image_prompt(7), image)
    long_k2 = qmc.launch_counts["K2"]
    if long_split["chunks"] != 2 or long_k2 != 2 * 2 * per:  # split's prefill, TTFT's
        raise AssertionError(f"1,300-token image prompt: {long_split['chunks']} chunks, "
                             f"{long_k2} K2 launches (want 2 x 2 x {per})")

    twin = InferenceEngine(model=model, params=params, max_seq_len=4096,
                           decode_chunk=16, prompt_cache=False)
    twin.core.graphs = eager_steps(twin.core.graphs)
    graphed = InferenceEngine(model=model, params=params, max_seq_len=4096,
                              decode_chunk=16, prompt_cache=False)
    checks = {}
    taps = []
    for e in (graphed, twin):
        for salt in (8, 9):  # the captures of both prompts' buckets
            e.generate(gemma_image_prompt(salt) if salt == 8 else
                       gemma_long_image_prompt(salt), max_completion_tokens=17,
                       temperature=0.0, **image)
        e.core.graphs = Tap(e.core.graphs)
        taps.append(e.core.graphs)
    for name, prompt in (("276-token image prompt", gemma_image_prompt(10)),
                         ("1,300-token image prompt (2 chunks)",
                          gemma_long_image_prompt(11))):
        for tap in taps:
            tap.logits.clear()
        streams = [e.generate(prompt, max_completion_tokens=17, temperature=0.0,
                              **image).token_ids for e in (graphed, twin)]
        errs = [((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(taps[0].logits, taps[1].logits)]
        caches = [cache_tensors(e.state.cache) for e in (graphed, twin)]
        cache_equal = all(torch.equal(t, caches[1][k]) for k, t in caches[0].items())
        if not (streams[0] == streams[1] and len(streams[0]) == 17 and max(errs) < 1e-3
                and cache_equal):
            raise AssertionError(f"Gemma image graphs vs eager ({name}): {streams} "
                                 f"{max(errs)} {cache_equal}")
        checks[name] = dict(tokens_equal=True, steps=len(errs), max_norm_err=max(errs),
                            cache_byte_equal=cache_equal)
    replays = taps[0].inner.replays
    embeds_keys = sorted(k[1] for k in taps[0].inner.keys if k[0] == "prefill" and k[6])
    if not (replays >= 2 * 17 and 1024 in embeds_keys and 512 in embeds_keys):
        raise AssertionError(f"Gemma image graphs: {replays} replays, embeds-on prefill "
                             f"buckets {embeds_keys}")
    del twin, graphed, taps, caches
    row = dict(phase="gemma3 vision", part="b: engine", geometry="gemma3-4b int4 g64 "
               "+ so400m bf16", layers=G4_LAYERS, tower_blocks=G4_VISION["num_hidden_layers"],
               image_px=G4_VISION["image_size"], tower_ms=tower_ms[1], tower_ms_runs=tower_ms,
               tower_flops=work["flops"], tower_bytes=work["bytes"],
               tower_bound_ms=work["bound_ms"], tower_bound_by=work["bound_by"],
               tower_bound_f32_ms=work["bound_f32_ms"],
               tower_tflop_s=work["flops"] / tower_ms[1] / 1e9,
               image=split, image_2chunks=long_split, image_decode_tok_s=image_tok_s,
               k1_per_decoded_token=launches["K1"] / decoded, k2_per_prefill=launches["K2"],
               k2_long_prompt=long_k2 // 2, launches=launches,
               graphs_vs_eager=dict(checks, replays=replays,
                                    embeds_prefill_buckets=embeds_keys),
               graphs=engine.core.graphs.stats(), card=card)
    emit(row)
    return engine, row


def gemma_vision_paged(engine1, card):
    """The 34-layer paged engine (8 lanes, INT8 pages, 8-step chunks): one
    counted run of 6 text lanes (64-token prompts) and 2 image lanes (276
    tokens: their embeddings ride mixed steps), 128 new tokens each (K3 34
    per device step, counted under replay) as aggregate tok/s; each image
    lane's first token equals the single-stream engine's on the same
    request."""
    import gc

    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    model, params = engine1.model, engine1.params
    lanes = 8
    engine = PagedEngine(model, params, num_lanes=lanes, num_pages=112,
                         max_pages_per_seq=12, kv_quantized=True)
    sched = Scheduler(engine, decode_steps=8)
    images = []
    for seed in (11, 12, 13):
        px = gemma_pixels(seed)
        prompt = gemma_image_prompt(seed)
        with torch.no_grad():
            emb = model.embed_with_images(
                params, torch.tensor([prompt], dtype=torch.int32, device="cuda"),
                torch.from_numpy(px).cuda())[0]
        images.append(dict(prompt=prompt, emb=emb, image=dict(pixel_values=px)))
    text = list(range(1, 65))
    sched.add_request(images[2]["prompt"], max_new_tokens=9, temperature=0.0,
                      prompt_embeds=images[2]["emb"])  # warm up: the embeds graphs
    sched.add_request(text, max_new_tokens=17, temperature=0.0)
    sched.run_to_completion()
    qmc.reset_counts()
    steps0 = engine.device_steps
    seqs = [sched.add_request([t + i for t in text], max_new_tokens=128, temperature=0.0)
            for i in range(lanes - 2)]
    seqs += [sched.add_request(im["prompt"], max_new_tokens=128, temperature=0.0,
                               prompt_embeds=im["emb"]) for im in images[:2]]
    t0 = time.perf_counter()
    sched.run_to_completion()
    torch.cuda.synchronize()
    tok_s = sum(len(s.output_ids) for s in seqs) / (time.perf_counter() - t0)
    launches = dict(qmc.launch_counts)
    steps = engine.device_steps - steps0
    if not (steps > 0 and launches["K3"] == G4_LAYERS * steps and launches["K1"] > 0
            and launches["K2"] > 0 and all(len(s.output_ids) == 128 for s in seqs)):
        raise AssertionError(f"Gemma-3 image paged path: {launches} over {steps} steps")
    first = [engine1.generate(im["prompt"], max_completion_tokens=1, temperature=0.0,
                              **im["image"]).token_ids[0] for im in images[:2]]
    lane_first = [s.output_ids[0] for s in seqs[-2:]]
    if lane_first != first:
        raise AssertionError(f"image lanes' first tokens {lane_first}, single stream {first}")
    if not any(k[0] == "mixed" and k[5] for k in engine.graphs.keys):
        raise AssertionError(f"no image rider step among {engine.graphs.keys}")
    graph_stats = engine.graphs.stats()
    del sched, engine, images
    gc.collect()
    torch.cuda.empty_cache()
    row = dict(phase="gemma3 vision", part="c: paged engine",
               geometry="gemma3-4b int4 g64 + so400m bf16", layers=G4_LAYERS, lanes=lanes,
               image_lanes=2, kv="int8 paged", decode_tok_s=tok_s, device_steps=steps,
               k3_per_step=launches["K3"] / steps, image_lane_first_tokens=lane_first,
               single_stream_first_tokens=first, launches=launches, graphs=graph_stats,
               card=card)
    emit(row)
    return row


def gemma_vision_http(engine1):
    """One chat with an image (the OpenAI image_url part, a 384 x 384 PNG
    data URI, which the SigLIP processor resizes to 896 x 896; a noise PNG
    at 896 px would pass the server's 1 MiB request limit) over HTTP
    through create_app on the single-stream engine: 200, usage, the
    prompt's 256 placeholders counted. Needs Pillow to decode the PNG;
    without it the line says "pillow": false."""
    import asyncio
    import base64
    import io

    import aiohttp
    import numpy as np
    from aiohttp import web

    from pie_tpu_torch.server.app import create_app
    from pie_tpu_torch.server.config import Settings

    try:
        from PIL import Image
    except ImportError:
        emit(dict(phase="gemma3 vision", part="d: HTTP image chat", pillow=False))
        return None
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(22).integers(
        0, 256, (384, 384, 3), dtype=np.uint8)).save(buf, format="PNG")
    uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    engine1.tokenizer = tok = gemma_word_tokenizer()
    chat = [{"role": "user", "text": "hello world", "num_images": 1}]
    want_prompt = len(tok.apply_chat_template(
        chat, add_generation_prompt=True, image_token_id=G4_IMAGE["image_token_id"],
        tokens_per_image=G4_IMAGE["mm_tokens_per_image"]))

    async def ask():
        runner = web.AppRunner(create_app(engine=engine1, settings=Settings(),
                                          device=engine1.device))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            async with aiohttp.ClientSession() as s:
                t0 = time.perf_counter()
                async with s.post(f"http://127.0.0.1:{port}/v1/chat/completions", json=dict(
                        messages=[{"role": "user", "content": [
                            {"type": "text", "text": "hello world"},
                            {"type": "image_url", "image_url": {"url": uri}}]}],
                        max_tokens=8, temperature=0.0)) as r:
                    return r.status, await r.json(), (time.perf_counter() - t0) * 1e3
        finally:
            await runner.cleanup()

    status, body, ms = asyncio.run(ask())
    if (status != 200 or body["usage"]["completion_tokens"] < 1
            or body["usage"]["prompt_tokens"] != want_prompt):
        raise AssertionError(f"Gemma HTTP image chat: {status} {body} "
                             f"(prompt of {want_prompt} tokens)")
    out = dict(status=status, ms=ms, usage=body["usage"])
    emit(dict(phase="gemma3 vision", part="d: HTTP image chat", pillow=True,
              image_tokens=G4_IMAGE["mm_tokens_per_image"], **out))
    return out


def phase_gemma3_vision(card):
    """Phase 14 (module docstring)."""
    import gc

    check = gemma_vision_check("gemma3-4b (2 layers) + so400m (2 blocks)")
    engine, eng = gemma_vision_engine(card)
    paged = gemma_vision_paged(engine, card)
    http_out = gemma_vision_http(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(check=check, engine=eng, paged=paged, http=http_out)


# -- phase 15: the native scheduler --------------------------------------------------


def native_prompts(n=8, length=64, salt=0):
    """``n`` distinct prompts of ``length`` tokens."""
    return [[1 + (i * 37 + (j + salt) * 1013) % min(100000, VOCAB - 1)
             for i in range(length)] for j in range(n)]


class NativeTap:
    """A step runner that keeps a copy of each native program's result: the
    prefill's logits, the first sample's token, the decode step's logits."""

    def __init__(self, inner):
        self.inner, self.outs = inner, []

    def __call__(self, key, fn, samples=False):
        out = self.inner(key, fn, samples)
        self.outs.append((key[0], out[1 if key[0] == "native" else 0].float().clone()))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def build_native():
    """Phase 15a: g++ builds native/ into the port's build directory."""
    from pie_tpu_torch.runtime import native

    t0 = time.perf_counter()
    path = native.build()
    row = dict(phase="native build", compiler=native.compiler_version(),
               seconds=time.perf_counter() - t0, compile_seconds=native.build_seconds,
               lib=str(path))
    emit(row)
    return row


def native_service_run(model, params, impl, prompts, new, reps=2):
    """The prompts, all at once from one thread each, through
    BatchedInferenceEngine(scheduler_impl=impl) (8 lanes, 112 INT8 pages, 12
    pages a sequence): the first run counted (launches, decode steps),
    aggregate tok/s best of ``reps``. Returns (streams, tok/s, launches,
    steps, graph stats)."""
    import threading

    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    service = BatchedInferenceEngine(model=model, params=params, num_lanes=len(prompts),
                                     num_pages=112, max_pages_per_seq=12,
                                     kv_quantized=True, scheduler_impl=impl)
    try:
        service.generate(prompts[0], max_completion_tokens=9, temperature=0.0)  # warm up
        best = 0.0
        for rep in range(reps):
            out = [None] * len(prompts)

            def one(i):
                out[i] = service.generate(prompts[i], max_completion_tokens=new,
                                          temperature=0.0).token_ids

            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
            torch.cuda.synchronize()
            qmc.reset_counts()
            steps0 = service.core.device_steps
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            torch.cuda.synchronize()
            best = max(best, sum(len(o) for o in out) / (time.perf_counter() - t0))
            if rep == 0:
                launches = dict(qmc.launch_counts)
                steps = service.core.device_steps - steps0
                streams = out
        if any(len(o) != new for o in streams):
            raise AssertionError(f"{impl}: streams of {[len(o) for o in streams]} tokens")
        return streams, best, launches, steps, service.core.graphs.stats()
    finally:
        service.shutdown()


def native_steady(model, params, prompts, new):
    """Steady native steps (every lane decoding, graphs captured): host ms
    per step over 16 steps (the wall clock, the step's read back
    included), device ms of one decode step from CUDA events around the
    decode program alone (its uploads and its replay; median of 5), and
    32 profiled steps (aten calls per step, the idle share)."""
    import gc

    from pie_tpu_torch.engine.scheduler import PagedEngine
    from pie_tpu_torch.ops.sampling import sampler_kind_for
    from pie_tpu_torch.runtime.native_scheduler import NativeScheduler

    engine = PagedEngine(model, params, num_lanes=len(prompts), num_pages=112,
                         max_pages_per_seq=12, kv_quantized=True)
    sched = NativeScheduler(engine)
    reqs = [sched.add_request(p, max_new_tokens=new, temperature=0.0) for p in prompts]
    for _ in range(4):
        sched.step()
    core = sched.core
    if core.decode_view() != len(prompts):
        raise AssertionError("native steady: not every lane decodes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        sched.step()
    host = (time.perf_counter() - t0) / 16 * 1e3
    core.decode_view()
    act = core.active.astype(bool)
    kind = sampler_kind_for(core.temperature[act], core.top_p[act], core.min_p[act],
                            core.top_k[act])
    args = (engine.params, core.last_tokens, core.context_lens, core.block_tables,
            core.histories, sched._sampling(slice(None)), sched._penalties(slice(None)),
            core.active, kind, False)
    dev = sorted(event_ms(lambda: engine._decode(*args)) for _ in range(5))[2]
    trace = profiled(lambda: [sched.step() for _ in range(32)])
    trace["aten_calls_per_step"] = trace["aten_calls"] / 32
    sched.run_to_completion()
    if any(len(r.output_ids) != new for r in reqs):
        raise AssertionError("native steady: a request came short")
    stats = engine.graphs.stats()
    del sched, engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(host_ms_per_step=host, device_ms_per_step=dev,
                idle_share_32_steps=trace["device_idle_share"],
                aten_calls_per_step=trace["aten_calls_per_step"], profiled_32_steps=trace,
                graphs=stats)


def native_vs_eager(model, params, prompts, new=16):
    """The native programs replayed from their graphs against the same
    programs run eagerly on the card by a twin scheduler: equal tokens, every
    prefill's and decode step's logits within 1e-3 normalized, equal first
    tokens, byte-equal pools."""
    import gc

    from pie_tpu_torch.engine.scheduler import PagedEngine
    from pie_tpu_torch.runtime.native_scheduler import NativeScheduler

    scheds = [NativeScheduler(PagedEngine(model, params, num_lanes=len(prompts),
                                          num_pages=112, max_pages_per_seq=12,
                                          kv_quantized=True)) for _ in range(2)]
    scheds[1].engine.graphs = eager_steps(scheds[1].engine.graphs)
    taps, streams = [], []
    for s in scheds:
        s.engine.graphs = NativeTap(s.engine.graphs)
        taps.append(s.engine.graphs)
        reqs = [s.add_request(p, max_new_tokens=new, temperature=0.0) for p in prompts]
        s.run_to_completion()
        streams.append([r.output_ids for r in reqs])
    if streams[0] != streams[1]:
        raise AssertionError(f"native graphs vs eager: {streams}")
    kinds = [k for k, _ in taps[0].outs]
    if kinds != [k for k, _ in taps[1].outs]:
        raise AssertionError("native graphs vs eager: different programs ran")
    errs = {"native_prefill": 0.0, "native": 0.0}
    for (kind, got), (_, want) in zip(taps[0].outs, taps[1].outs):
        if kind == "first":
            if not torch.equal(got, want):
                raise AssertionError("native graphs vs eager: first tokens differ")
            continue
        err = ((got - want).abs().max() / want.abs().max()).item()
        errs[kind] = max(errs[kind], err)
    pools = [[t for t in (s.engine.pool.k, s.engine.pool.v, s.engine.pool.k_scale,
                          s.engine.pool.v_scale) if t is not None] for s in scheds]
    pools_equal = all(torch.equal(a, b) for a, b in zip(*pools))
    if not (max(errs.values()) < 1e-3 and pools_equal):
        raise AssertionError(f"native graphs vs eager: {errs}, pools equal {pools_equal}")
    row = dict(tokens_equal=True, prefill_logits_norm_err=errs["native_prefill"],
               decode_logits_norm_err=errs["native"], pools_byte_equal=pools_equal,
               programs={k: kinds.count(k) for k in sorted(set(kinds))},
               replays=taps[0].inner.replays, captures=taps[0].inner.captures)
    del scheds, taps
    gc.collect()
    torch.cuda.empty_cache()
    return row


def native_model_check(layers=16):
    """The native decode step at the full 8B widths over ``layers`` layers
    (random INT4 g64), card against the CPU's plain path on the same
    weights: the card's native prefill writes three prompts (40, 20 and 33
    tokens) into its INT8 pool, the CPU engine's pool takes a copy, and one
    ``_decode`` step with the three lanes active and one frozen runs on
    both; the normalized max error of its logits (limit 0.03). One CPU
    pass over the 16 layers and the head takes ~50 s, so the prefills run
    on the card only (phase 3 holds the paged prefill against the CPU)."""
    import gc

    import numpy as np

    from pie_tpu_torch.engine.scheduler import HISTORY_LEN, PagedEngine
    from pie_tpu_torch.models.llama import LlamaModel

    model = LlamaModel(llama8b_config(layers))
    gpu_params = model.init_quantized_params(seed=3, group_size=64, bits=4)
    params = {"cuda": gpu_params, "cpu": to_device(gpu_params, "cpu")}
    engines = {d: PagedEngine(model, params[d], num_lanes=4, num_pages=12,
                              max_pages_per_seq=3, prefill_chunk=64, kv_quantized=True,
                              device=d) for d in ("cpu", "cuda")}
    tables = np.array([[3, 7, 10], [11, 0, 5], [9, 2, 6], [-1, -1, -1]], np.int32)
    lens = (40, 20, 33)
    prompts = np.random.default_rng(6).integers(0, VOCAB, (3, 40)).astype(np.int32)
    gpu = engines["cuda"]
    for lane, n in enumerate(lens):
        ids = np.zeros((1, 64), np.int32)
        pos = np.full((1, 64), -1, np.int32)
        ids[0, :n], pos[0, :n] = prompts[lane, :n], np.arange(n)
        gpu._prefill_logits(gpu.params, ids, pos, tables[lane:lane + 1],
                            np.array([n], np.int32), n - 1)
    for name in ("k", "v", "k_scale", "v_scale"):
        getattr(engines["cpu"].pool, name).copy_(getattr(gpu.pool, name).cpu())
    samp = {"temperature": np.zeros(4, np.float32), "top_p": np.ones(4, np.float32),
            "min_p": np.zeros(4, np.float32), "top_k": np.full(4, -1, np.int32)}
    pen = {"repetition": np.ones(4, np.float32), "presence": np.zeros(4, np.float32),
           "frequency": np.zeros(4, np.float32)}
    last = np.array([11, 12, 13, 0], np.int32)
    ctx = np.array([n + 1 for n in lens] + [0], np.int32)
    hist = np.full((4, HISTORY_LEN), -1, np.int32)
    t0 = time.perf_counter()
    out = {d: e._decode(e.params, last, ctx, tables, hist, samp, pen,
                        np.array([1, 1, 1, 0], np.uint8), "greedy", False)[1][:3].float().cpu()
           for d, e in engines.items()}
    err = ((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()).item()
    if not (torch.isfinite(out["cuda"]).all() and err < 0.03):
        raise AssertionError(f"native model check: err {err}")
    row = dict(layers=layers, widths="llama3-8b", kv="int8 paged", lanes="3 of 4 active",
               norm_err=err, decode_seconds=time.perf_counter() - t0, limit=0.03)
    del engines, params, gpu_params, gpu
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_native_8b(single, card):
    """Phase 15b: the native scheduler at the full 8B width (the single-stream
    engine's 32-layer random INT4 g64 weights, 8 lanes, INT8 pages)."""
    model, params = single.model, single.params
    lanes, new = 8, 128
    prompts = native_prompts(lanes)
    streams, tok_s, launches, steps, graphs = native_service_run(
        model, params, "native", prompts, new)
    n_prefill = len(prompts)  # each 64-token prompt is one bucket-64 chunk
    want = dict(K3=LAYERS * steps, K2=(4 * LAYERS) * n_prefill,
                K1=(4 * LAYERS + 1) * steps + n_prefill)
    want["K1 ln"] = (LAYERS + 1) * steps  # the paged decode folds ln1 and the final norm
    if not (steps > 0 and all(launches[k] == v for k, v in want.items())):
        raise AssertionError(f"native path launches {launches} over {steps} steps, "
                             f"{n_prefill} prefills: want {want}")
    first = [single.generate(p, max_completion_tokens=1, temperature=0.0).token_ids[0]
             for p in prompts]
    if [s[0] for s in streams] != first:
        raise AssertionError(f"native first tokens {[s[0] for s in streams]} != "
                             f"single stream's {first}")
    py_streams, py_tok_s, py_launches, py_steps, _ = native_service_run(
        model, params, "python", prompts, new)

    def shared(a, b):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        return n

    steady = native_steady(model, params, prompts, new)
    eager = native_vs_eager(model, params, prompts)
    row = dict(phase="native 8B", geometry="llama3-8b int4 g64", layers=LAYERS,
               lanes=lanes, kv="int8 paged", prompts=f"{lanes} distinct x 64 tokens",
               new_tokens=new, native_tok_s=tok_s, python_tok_s=py_tok_s,
               native_decode_steps=steps, python_device_steps=py_steps,
               launches=launches, per_step=dict(K1=(launches["K1"] - n_prefill) / steps,
                                                K3=launches["K3"] / steps),
               k2_per_prefill=launches["K2"] / n_prefill, python_launches=py_launches,
               first_tokens_equal_single_stream=True,
               tokens_shared_with_python=[shared(a, b) for a, b in zip(streams, py_streams)],
               graphs=graphs, steady=steady, graphs_vs_eager=eager, card=card)
    emit(row)
    check = native_model_check()
    emit(dict(phase="native model check", **check))
    row["model_check"] = check
    return row


def phase_native_process(snap, card):
    """Phase 15c: ``python -m pie_tpu_torch.runtime.engine_main`` on the 1B
    snapshot (INT8 pages) as a subprocess; from this process an IpcFrontend
    sends a warm-up request, then 4 greedy requests at once, then a fifth it
    cancels after two tokens; the 4 streams must equal an in-process native
    scheduler's on the same snapshot; SIGTERM must end the process with
    code 0 and its shm segment unlinked."""
    import gc
    import os
    import re
    import signal

    from pie_tpu_torch.engine.scheduler import PagedEngine
    from pie_tpu_torch.models.loader import load_model
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.runtime.ipc import IpcFrontend
    from pie_tpu_torch.runtime.native_scheduler import NativeScheduler

    prompts, new = native_prompts(4, salt=40), 32
    name = f"/pie_smoke_{os.getpid()}"
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pie_tpu_torch.runtime.engine_main", "--model-path",
         str(snap), "--channel", name, "--kv-quantized", "--log-level", "INFO"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fe = None
    try:
        while fe is None:
            try:
                fe = IpcFrontend(name)
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 600:
                    raise AssertionError(f"engine process did not come up:\n"
                                         f"{proc.stdout.read()[-4000:]}")
                time.sleep(0.1)
        ready = time.perf_counter() - t0
        t1 = time.perf_counter()
        fe.collect(fe.submit(prompts[0], max_new_tokens=8, temperature=0.0), timeout_s=300)
        first_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        rids = [fe.submit(p, max_new_tokens=new, temperature=0.0) for p in prompts]
        got = [fe.collect(rid, timeout_s=300) for rid in rids]
        wall_ms = (time.perf_counter() - t1) * 1e3
        cancelled = fe.submit(prompts[1], max_new_tokens=300, temperature=0.0)
        toks = []
        for tok in fe.stream(cancelled, timeout_s=300):
            toks.append(tok)
            if len(toks) == 2:
                fe.cancel(cancelled)
        reason = fe.last_finish_reason
    finally:
        if fe is not None:
            fe.close()
        proc.send_signal(signal.SIGTERM)
        try:
            log, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    shm_gone = not Path("/dev/shm", name.lstrip("/")).exists()
    m = re.search(r"launches (\{.*\})", log)
    proc_launches = json.loads(m.group(1)) if m else None
    if not (proc.returncode == 0 and shm_gone and reason == "cancelled"
            and all(r == "length" for _, r in got) and proc_launches
            and proc_launches["K4"] > 0):
        raise AssertionError(f"engine process: rc {proc.returncode}, shm gone {shm_gone}, "
                             f"cancel {reason}, finishes {[r for _, r in got]}, "
                             f"launches {proc_launches}:\n{log[-4000:]}")

    # the same requests through an in-process native scheduler on the snapshot
    model, params = load_model(snap)
    engine = PagedEngine(model, params, num_lanes=8, num_pages=1024, max_pages_per_seq=64,
                         kv_quantized=True)
    sched = NativeScheduler(engine)
    reqs = [sched.add_request(p, max_new_tokens=new, temperature=0.0) for p in prompts]
    qmc.reset_counts()
    steps0 = engine.device_steps
    sched.run_to_completion()
    launches, steps = dict(qmc.launch_counts), engine.device_steps - steps0
    want = [r.output_ids for r in reqs]
    if [g for g, _ in got] != want:
        raise AssertionError(f"engine process streams {[g for g, _ in got]} != "
                             f"in-process {want}")
    if launches["K4"] != LAYERS1 * steps:
        raise AssertionError(f"1B native: {launches} over {steps} decode steps")
    del sched, engine, model, params
    gc.collect()
    torch.cuda.empty_cache()
    row = dict(phase="native engine process", entry="python -m "
               "pie_tpu_torch.runtime.engine_main --kv-quantized", geometry="llama3.2-1b",
               start_to_ready_s=ready, first_request_ms=first_ms,
               requests=len(prompts), new_tokens=new, requests_wall_ms=wall_ms,
               ms_per_request=wall_ms / len(prompts), cancelled_after=len(toks),
               streams_equal_in_process=True, exit_code=proc.returncode,
               shm_unlinked=shm_gone, process_launches=proc_launches,
               in_process_launches=launches, in_process_decode_steps=steps,
               k4_per_decode_step=launches["K4"] / steps, card=card)
    emit(row)
    return row


def phase_native_serve(snap):
    """Phase 15d: NATIVE_SCHEDULER=1 BATCHING=1 KV_QUANTIZED=1 serving the 1B
    snapshot: 4 concurrent chats (200), a json_schema chat sampled at
    temperature 1 (the native path takes no logit bias to steer random
    weights, so greedy decoding would fill the budget with whitespace) that
    parses to the schema, and a logit_bias chat refused with the native
    scheduler's reason."""
    from concurrent.futures import ThreadPoolExecutor

    chat = dict(messages=[{"role": "user", "content": "hello world"}], max_tokens=8,
                temperature=0.0)

    def ask(url):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            many = list(pool.map(lambda _: http("POST", f"{url}/v1/chat/completions",
                                                chat), range(4)))
        wall = (time.perf_counter() - t0) * 1e3
        if any(status != 200 for status, _, _ in many):
            raise AssertionError(f"native server chats: {[m[0] for m in many]} "
                                 f"{many[0][2][:2000]}")
        texts = {json.loads(t)["choices"][0]["message"]["content"] for _, _, t in many}
        status, secs, text = http("POST", f"{url}/v1/chat/completions", dict(
            chat, max_tokens=256, temperature=1.0, response_format={
                "type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}))
        if status != 200:
            raise AssertionError(f"native json_schema chat: {status} {text[:2000]}")
        content = json.loads(text)["choices"][0]["message"]["content"]
        check_schema(content)
        hello = word_tokenizer().encode("hello", add_bos=False)[0]
        bstatus, _, btext = http("POST", f"{url}/v1/chat/completions",
                                 dict(chat, logit_bias={str(hello): 100.0}))
        message = json.loads(btext).get("error", {}).get("message", "")
        if not (bstatus == 400 and "native scheduler" in message):
            raise AssertionError(f"native logit_bias: {bstatus} {btext[:2000]}")
        return dict(concurrent_ms=[m[1] * 1e3 for m in many], concurrent_wall_ms=wall,
                    distinct_replies=len(texts), json_schema_ms=secs * 1e3,
                    json_schema_content=content, logit_bias_status=bstatus,
                    logit_bias_error=message)

    env = {"BATCHING": "1", "NATIVE_SCHEDULER": "1", "KV_QUANTIZED": "1", "NUM_LANES": "8"}
    startup, out = serve_and_ask(snap, env, ask)
    row = dict(phase="native server", entry="python -m pie_tpu_torch.server", env=env,
               startup_s=startup, **out)
    emit(row)
    return row


# -- phase 16: tensor / data parallelism and the front tier --------------------


def nccl_mesh_of_one():
    """A ("dp", "tp") = (1, 1) mesh over a one-process NCCL group on
    localhost (joined once, through parallel.distributed.initialize)."""
    import torch.distributed as dist

    from pie_tpu_torch.parallel import distributed, make_mesh

    if not dist.is_initialized():
        distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    return make_mesh(tp=1, dp=1)


def mesh_steady(sched, prompt, lanes, chunks=3):
    """Collectives and K1 / K3 launches per device step over ``chunks``
    steady chunks (every lane decoding, no admission)."""
    from pie_tpu_torch.engine.scheduler import SeqStatus
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.parallel.tp import collective_counts

    engine = sched.engine
    seqs = [sched.add_request(prompt, max_new_tokens=8 * (chunks + 4), temperature=0.0)
            for _ in range(lanes)]
    while sched.waiting or any(s.status != SeqStatus.DECODING for s in seqs):
        sched.step()
    sched.step()
    torch.cuda.synchronize()
    qmc.reset_counts()
    c0, s0 = dict(collective_counts), engine.device_steps
    for _ in range(chunks):
        sched.step()
    torch.cuda.synchronize()
    steps = engine.device_steps - s0
    per = {k: (collective_counts[k] - c0[k]) / steps for k in c0}
    launches = {k: v / steps for k, v in qmc.launch_counts.items()}
    sched.run_to_completion()
    return dict(steps=steps, collectives_per_step=per, launches_per_step=launches)


def phase_tp1_nccl(model, params, card):
    """16a: the 8B paged engine (8 lanes, 112 INT8 pages, phase 6's prompt)
    as rank 0 of a one-process NCCL mesh (tp = 1, dp = 1): its steps
    replay CUDA graphs with the collectives (2 all-reduces a layer, the
    embedding's, the logits' all-gather) captured inside. Its greedy
    tokens equal the group-less engine's bit for bit; tok/s of both in
    turns (plain, mesh, mesh, plain); graphs by kind; launches of the
    counted run; collectives, launches and aten calls per steady step."""
    import gc

    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.parallel import shard_params
    from pie_tpu_torch.parallel.tp import collective_counts

    mesh = nccl_mesh_of_one()
    sharded = shard_params(params, mesh, model.config)
    lanes, new = 8, 128
    prompt = list(range(1, 65))
    scheds = {}
    for kind in ("plain", "mesh"):
        engine = PagedEngine(model, params if kind == "plain" else sharded,
                             num_lanes=lanes, num_pages=112, max_pages_per_seq=12,
                             kv_quantized=True, mesh=None if kind == "plain" else mesh)
        scheds[kind] = Scheduler(engine, decode_steps=8)
        scheds[kind].add_request(prompt, max_new_tokens=17, temperature=0.0)
        scheds[kind].run_to_completion()  # warm up: the captures

    runs = []
    for kind in ("plain", "mesh", "mesh", "plain"):
        sched = scheds[kind]
        qmc.reset_counts()
        c0, s0 = dict(collective_counts), sched.engine.device_steps
        seqs = [sched.add_request(prompt, max_new_tokens=new, temperature=0.0)
                for _ in range(lanes)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.run_to_completion()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs.append(dict(kind=kind, tok_s=sum(len(s.output_ids) for s in seqs) / dt,
                         outputs=[s.output_ids for s in seqs],
                         launches=dict(qmc.launch_counts),
                         collectives={k: collective_counts[k] - c0[k] for k in c0},
                         steps=sched.engine.device_steps - s0))
    plain, mesh_run = runs[0], runs[1]
    equal = all(r["outputs"] == plain["outputs"] for r in runs)
    steady = {kind: mesh_steady(scheds[kind], prompt, lanes) for kind in ("plain", "mesh")}
    aten = {kind: steady_paged(scheds[kind], prompt, lanes, chunks=2)["profiled_chunk"]
            for kind in ("plain", "mesh")}
    stats = scheds["mesh"].engine.graphs.stats()
    per = steady["mesh"]["collectives_per_step"]
    la = mesh_run["launches"]
    row = dict(phase="16a tp=1 over NCCL", geometry="llama3-8b int4 g64", layers=LAYERS,
               lanes=lanes, kv="int8 paged", backend="nccl", world=1,
               tokens_equal=equal, new_tokens=new,
               tok_s=dict(plain=[runs[0]["tok_s"], runs[3]["tok_s"]],
                          mesh=[runs[1]["tok_s"], runs[2]["tok_s"]]),
               launches=la, steps=mesh_run["steps"],
               collectives=mesh_run["collectives"], steady=steady,
               aten_calls_per_step={k: v["aten_calls_per_step"] for k, v in aten.items()},
               idle_share={k: v["device_idle_share"] for k, v in aten.items()},
               graphs=dict(by_kind=stats["by_kind"], graphs=stats["graphs"],
                           pool_bytes=stats["pool_bytes"]), card=card)
    emit(row)
    want = {"tp all_reduce": 2 * LAYERS + 1, "tp all_gather": 1, "dp all_gather": 0}
    if not (equal and per == want and la["K1"] > 0 and la["K2"] > 0
            and la["K3"] == LAYERS * mesh_run["steps"] and la["K4"] == 0
            and stats["by_kind"].get("decode", {}).get("replays", 0) > 0):
        raise AssertionError(f"16a: tp=1 over NCCL {row}")
    del scheds, sharded
    gc.collect()
    torch.cuda.empty_cache()
    return row


def tp2_rank(out_path):
    """One rank of phase 16b (a subprocess; PIE_COORDINATOR,
    PIE_NUM_PROCESSES=2 and PIE_PROCESS_ID set by phase_tp2): the 8B at
    full width (32 layers, random INT4 g64, seed 0 as phase 4) sharded over
    tp = 2 on the one card, gloo between the two processes, eager steps.
    Rank 0 first runs the tp = 1 reference on its full weights (prefill of
    phase 6's prompt and 4 greedy steps through paged_forward, then the
    paged engine's outputs) and broadcasts the reference tokens; then both
    ranks run the same prefill and steps teacher-forced on their shards
    (rank 0 holds its gathered logits against the reference), a capture
    over the gloo group (refused), and the sharded paged engine (8 lanes,
    112 INT8 pages) with counted launches. Writes its row as JSON."""
    import gc

    import torch.distributed as dist

    from pie_tpu_torch.cache.paged import PagedKVPool
    from pie_tpu_torch.engine.graphs import StepGraphs
    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler
    from pie_tpu_torch.models.llama import LlamaModel
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.parallel import (
        distributed,
        make_mesh,
        mesh_ops,
        shard_model,
        shard_params,
    )
    from pie_tpu_torch.parallel.tp import collective_counts

    t_start = time.perf_counter()
    assert distributed.initialize(device="cuda", backend="gloo")
    rank = dist.get_rank()
    mesh = make_mesh(tp=2, dp=1)
    qmc.build()
    model = LlamaModel(llama8b_config(LAYERS))
    params = model.init_quantized_params(seed=0, group_size=64, bits=4)
    sharded = shard_params(params, mesh, model.config)
    if rank != 0:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out = dict(rank=rank, ready_s=time.perf_counter() - t_start,
               shapes={n: list(sharded["layers"][n].shape)
                       for n in ("wqkv", "wo", "wgu", "wd")},
               lm_head=list(sharded["lm_head"].shape))
    lanes, new, prompt = 8, 32, list(range(1, 65))

    def forward_run(m, p, tokens=None):
        """Prefill + 4 greedy (or ``tokens``-forced) decode steps over a
        fresh INT8 pool; the 5 logits rows and the tokens."""
        cfg = m.config
        pool = PagedKVPool.create(LAYERS, 4, cfg.num_key_value_heads, DH,
                                  quantized=True, device="cuda")
        table = torch.tensor([[0, 1]], dtype=torch.int32, device="cuda")
        ids = torch.tensor([prompt], dtype=torch.int32, device="cuda")
        pos = torch.arange(64, dtype=torch.int32, device="cuda")[None]
        logits, _ = m.paged_forward(p, ids, pool, table, pos,
                                    torch.tensor([64], dtype=torch.int32, device="cuda"),
                                    last_idx=torch.tensor([63], device="cuda"))
        rows, toks = [logits[0, 0].float()], []
        for s in range(4):
            tok = int(rows[-1].argmax()) if tokens is None else int(tokens[s])
            toks.append(tok)
            logits, _ = m.paged_forward(
                p, torch.tensor([[tok]], dtype=torch.int32, device="cuda"), pool, table,
                torch.tensor([[64 + s]], dtype=torch.int32, device="cuda"),
                torch.tensor([65 + s], dtype=torch.int32, device="cuda"))
            rows.append(logits[0, 0].float())
        return rows, toks

    def serve(m, p, **kw):
        engine = PagedEngine(m, p, num_lanes=lanes, num_pages=112, max_pages_per_seq=12,
                             kv_quantized=True, **kw)
        sched = Scheduler(engine, decode_steps=8)
        return engine, sched

    ref_tokens = torch.zeros(4, dtype=torch.int64)
    if rank == 0:
        ref_rows, toks = forward_run(model, params)
        ref_tokens = torch.tensor(toks)
        engine, sched = serve(model, params)
        sched.add_request(prompt, max_new_tokens=9, temperature=0.0)
        sched.run_to_completion()
        seqs = [sched.add_request(prompt, max_new_tokens=new, temperature=0.0)
                for _ in range(lanes)]
        sched.run_to_completion()
        ref_outputs = [s.output_ids for s in seqs]
        del engine, sched, params
        gc.collect()
        torch.cuda.empty_cache()
    dist.broadcast(ref_tokens, src=0)

    lmodel = shard_model(model, mesh)
    c0 = dict(collective_counts)
    rows, _ = forward_run(lmodel, sharded, ref_tokens.tolist())
    out["forward_collectives"] = {k: collective_counts[k] - c0[k] for k in c0}
    if rank == 0:
        out["logits_norm_err"] = [
            float((g - w).abs().max() / w.abs().max()) for g, w in zip(rows, ref_rows)]
        out["ref_tokens"] = ref_tokens.tolist()
        out["sharded_argmax"] = [int(r.argmax()) for r in rows]
    try:
        StepGraphs(torch.device("cuda"), None, mesh_ops(mesh))(("decode",), lambda: ())
        out["capture_refused"] = None
    except RuntimeError as e:
        out["capture_refused"] = str(e)

    engine, sched = serve(model, sharded, mesh=mesh, eager_steps=True)
    sched.add_request(prompt, max_new_tokens=9, temperature=0.0)
    sched.run_to_completion()
    qmc.reset_counts()
    s0 = engine.device_steps
    seqs = [sched.add_request(prompt, max_new_tokens=new, temperature=0.0)
            for _ in range(lanes)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run_to_completion()
    torch.cuda.synchronize()
    out.update(tok_s=lanes * new / (time.perf_counter() - t0),
               launches=dict(qmc.launch_counts), device_steps=engine.device_steps - s0,
               pool_heads=int(engine.pool.k.shape[2]))
    outputs = [s.output_ids for s in seqs]
    if rank == 0:
        shared = []
        for a, b in zip(outputs, ref_outputs):
            n = 0
            while n < min(len(a), len(b)) and a[n] == b[n]:
                n += 1
            shared.append(n)
        out.update(tokens_shared_with_tp1=shared, new_tokens=new)
    out["total_s"] = time.perf_counter() - t_start
    dist.barrier()
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))


def phase_tp2(card):
    """16b: two processes on the one card as the tp = 2 ranks of the 8B
    (``tp2_rank``), joined by gloo over localhost; each is stopped if it
    has not ended in 600 s. Checks: rank 0's gathered logits for the
    prefill and 4 steps within 0.03 (normalized) of tp = 1 on the card; on
    each rank K1 ran on its shards (wqkv N 3,072, wgu N 14,336), K2 in the
    prefills, K3 once a layer a step at 16 / 4 heads and K4 never; the
    capture over gloo refused."""
    import os

    root = str(Path(__file__).resolve().parent)
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="pie-tp2-") as tmp:
        procs, paths = [], []
        for rank in range(2):
            path = Path(tmp) / f"rank{rank}.json"
            env = dict(os.environ, PIE_COORDINATOR=f"127.0.0.1:{port}",
                       PIE_NUM_PROCESSES="2", PIE_PROCESS_ID=str(rank))
            env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.tp2_rank({str(path)!r})"],
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
            paths.append(path)
        logs = []
        try:
            deadline = time.perf_counter() + 600
            for p in procs:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.perf_counter()))
                logs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs) or not all(p.exists() for p in paths):
            raise AssertionError("16b ranks: " + " | ".join(
                f"rank {r} exit {p.returncode}: {log[-3000:]}"
                for r, (p, log) in enumerate(zip(procs, logs))))
        ranks = [json.loads(p.read_text()) for p in paths]
    row = dict(phase="16b tp=2 over gloo (two processes, one card, eager)",
               geometry="llama3-8b int4 g64", layers=LAYERS, lanes=8, kv="int8 paged",
               ranks=ranks, card=card)
    emit(row)
    r0 = ranks[0]
    ok = max(r0["logits_norm_err"]) < 0.03
    for r in ranks:
        la = r["launches"]
        ok &= (r["shapes"]["wqkv"] == [D, (HQ + 2 * HKV) * DH // 2]
               and r["shapes"]["wgu"] == [D, DI] and r["pool_heads"] == HKV // 2
               and la["K1"] > 0 and la["K2"] > 0 and la["K4"] == 0
               and la["K3"] == LAYERS * r["device_steps"]
               and r["capture_refused"] is not None and "gloo" in r["capture_refused"])
    if not ok:
        raise AssertionError(f"16b: tp=2 {row}")
    return row


def shard_kernel_case(label, k, n, m, rope_dim, full_k, tp, seed=0):
    """K1 (m <= 32) or K2 at one shard shape: a row shard (K = full_k / tp,
    re-padded to 512 by parallel.tp.row_shard) or a column shard, against
    its plain version (normalized max error < 0.025, phase 2's), timed
    over rotating copies (device time of a captured graph) beside the
    bytes / operations bound."""
    from pie_tpu_torch.ops import quant_matmul_cuda as qmc
    from pie_tpu_torch.ops.rope import make_inv_freq, rope_qkv_cs
    from pie_tpu_torch.parallel.tp import row_shard

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if full_k != k:  # a row shard of the full weight
        qt = row_shard(random_qt(full_k, n, 4, 64, ROTATE, gen), tp - 1, tp)
    else:
        qt = random_qt(k, n, 4, 64, ROTATE, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    kw = {}
    if rope_dim:
        hkv = n // rope_dim // 6  # Llama's 4 query heads a KV head: Hq + 2 Hkv = 6 Hkv
        inv = torch.from_numpy(make_inv_freq(rope_dim, 500000.0)).to("cuda")
        pos = torch.arange(m, dtype=torch.int32, device="cuda") + 100
        kw.update(rope_cs=rope_qkv_cs(pos, inv, 4 * hkv, hkv, rope_dim), rope_dim=rope_dim)
    got = qmc.quant_matmul_cuda(x, qt, layer=0, **kw)
    want = qmc.quant_matmul_ref(x, qt, layer=0, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    norm = diff / want.float().abs().max().item()
    if not norm < 0.025:
        raise AssertionError(f"16c {label} M={m}: kernel vs plain normalized err {norm}")
    ms = device_ms(lambda i: qmc.quant_matmul_cuda(x, qt, layer=i % ROTATE, **kw), iters=20)
    # the product's own bytes: a re-padded shard's zero rows are not work
    nbytes = (k // 8 * n * 4 + 2 * (k // 64) * n * 2
              + m * k * 2 + m * n * 2 + (2 * m * n * 4 if rope_dim else 0))
    flops = 2 * m * k * n
    bb, bo = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return dict(case=label, kernel="K1" if m <= qmc.DECODE_MAX_M else "K2", m=m, k=k,
                padded_k=qt.padded_k, n=n, rope=rope_dim, norm_err=norm, max_abs_err=diff,
                kernel_ms=ms, bound_ms=max(bb, bo), bound_by="bytes" if bb >= bo else "operations")


def phase_shard_kernels(card):
    """16c: K1 (M = 8, a paged step's lanes) and K2 (M = 512, a prefill) at
    every distinct shard shape a rank runs (parallel.tp.projection_shards:
    Gemma-3 4B at tp 8 after replicate_kv_heads) of the four geometries
    (Llama-3-8B and Llama-3.2-1B fused, Gemma-3 4B and Qwen2.5-VL-7B with
    projections apart) at tp 2 and tp 8 (Qwen: tp 2 and 4, its 28 query
    heads do not split over 8), INT4 g64, the re-padded row shards
    included."""
    from pie_tpu_torch.models.gemma3 import Gemma3Config
    from pie_tpu_torch.models.llama import LlamaConfig
    from pie_tpu_torch.models.qwen2_vl import Qwen2VLConfig
    from pie_tpu_torch.parallel.tp import projection_shards

    geos = {
        "8B": (llama8b_config(1), True, True, (2, 8)),
        "1B": (LlamaConfig(hidden_size=D1, intermediate_size=DI1, num_attention_heads=HQ1,
                           num_key_value_heads=HKV1, head_dim=DH1, vocab_size=VOCAB),
               True, True, (2, 8)),
        "gemma3-4b": (Gemma3Config(**{k: v for k, v in G4.items() if k != "rope_scaling"}),
                      False, False, (2, 8)),
        "qwen2.5-vl-7b": (Qwen2VLConfig(**Q7), False, True, (2, 4)),
    }
    shapes = {}
    for geo, (cfg, fused, head, tps) in geos.items():
        full = projection_shards(cfg, 1, fused, head)
        for tp in tps:
            for name, (k, n, rope) in projection_shards(cfg, tp, fused, head).items():
                shapes.setdefault((k, n, rope, full[name][0]),
                                  (f"{geo} tp{tp} {name}", tp))
    rows = []
    for (k, n, rope, full_k), (label, tp) in shapes.items():
        for m in (8, 512):
            rows.append(shard_kernel_case(label, k, n, m, rope, full_k, tp))
    row = dict(phase="16c K1 / K2 at shard shapes", bits=4, group_size=64,
               shapes=len(shapes), rows=rows, card=card)
    emit(row)
    return row


def phase_frontier(snap, card):
    """16d: two `python -m pie_tpu_torch.server` processes (BATCHING=1,
    KV_QUANTIZED=1, NUM_LANES=8) on the 1B snapshot behind `python -m
    pie_tpu_torch.server.frontier --hosts a,b`: the frontier's added ms per
    request against the same chat sent straight to a server (medians of 8
    sequential 8-token chats each way), then 7 concurrent 256-token chats,
    one server SIGKILLed while they are in flight (every one must still
    answer 200, on the survivor), then a streamed chat (SSE) through the
    frontier after the kill."""
    import os
    import signal
    import urllib.error
    from concurrent.futures import ThreadPoolExecutor

    env = {"BATCHING": "1", "KV_QUANTIZED": "1", "NUM_LANES": "8"}
    hello = word_tokenizer().encode("hello", add_bos=False)[0]
    chat = dict(messages=[{"role": "user", "content": "hello world"}], max_tokens=8,
                temperature=0.0, logit_bias={str(hello): 100.0})
    with ThreadPoolExecutor(2) as pool:  # both start at once
        starts = [pool.submit(start_server, snap, env) for _ in range(2)]
        servers = [f.result() for f in starts]
    front = None
    try:
        urls = [url for _, url, _ in servers]
        port = free_port()
        root = str(Path(__file__).resolve().parent)
        fenv = dict(os.environ, LOG_LEVEL="WARNING")
        fenv["PYTHONPATH"] = root + os.pathsep + fenv.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        front = subprocess.Popen(
            [sys.executable, "-m", "pie_tpu_torch.server.frontier", "--hosts",
             ",".join(urls), "--port", str(port)], cwd=root, env=fenv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        furl = f"http://127.0.0.1:{port}"
        while True:
            if front.poll() is not None:
                raise AssertionError(f"frontier exited {front.returncode}: "
                                     f"{front.stdout.read()[-3000:]}")
            try:
                if http("GET", f"{furl}/health", timeout=5)[0] == 200:
                    break
            except (urllib.error.URLError, OSError):
                pass
            if time.perf_counter() - t0 > 120:
                raise AssertionError("frontier did not answer /health in 120 s")
            time.sleep(0.2)
        front_startup = time.perf_counter() - t0

        def post(url, body):
            status, secs, text = http("POST", f"{url}/v1/chat/completions", body)
            if status != 200:
                raise AssertionError(f"16d: {status} {text[:2000]}")
            return secs * 1e3, text

        for url in urls + [furl, furl]:  # warm up: each server's graph captures
            post(url, chat)
        direct = sorted(post(urls[1], chat)[0] for _ in range(8))
        relayed = sorted(post(furl, chat)[0] for _ in range(8))
        long_chat = dict(chat, max_tokens=256, logit_bias={})
        with ThreadPoolExecutor(7) as pool:
            futures = [pool.submit(post, furl, long_chat) for _ in range(7)]
            time.sleep(0.3)
            victim = servers[0][0]
            victim.send_signal(signal.SIGKILL)
            victim.wait(30)
            killed_at = sum(f.done() for f in futures)
            answered = [f.result() for f in futures]
        sse_ms, text = post(furl, dict(chat, stream=True))
        if not (text.rstrip().endswith("data: [DONE]") and "hello" in text):
            raise AssertionError(f"16d stream: {text[:2000]}")
        health = json.loads(http("GET", f"{furl}/health")[2])
    finally:
        if front is not None:
            front.terminate()
            try:
                front.wait(timeout=30)
            except subprocess.TimeoutExpired:
                front.kill()
                front.wait()
        for proc, _, _ in servers:
            stop_server(proc)
    row = dict(phase="16d frontier", entry="python -m pie_tpu_torch.server.frontier",
               servers=2, env=env, server_startup_s=[s for _, _, s in servers],
               frontier_startup_s=front_startup,
               direct_ms_p50=direct[4], relayed_ms_p50=relayed[4],
               added_ms_per_request=relayed[4] - direct[4],
               in_flight_at_kill=7 - killed_at, answered_after_kill=len(answered),
               chat_ms_through_kill=[ms for ms, _ in answered], sse_ms=sse_ms,
               live_hosts=health["hosts"], card=card)
    emit(row)
    if not (killed_at < 7 and health["hosts"] == [urls[1]] and len(answered) == 7):
        raise AssertionError(f"16d: frontier failover {row}")
    return row


# -- main ----------------------------------------------------------------------


def timed(name, fn, *args):
    """fn(*args), then a line with the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit(dict(phase_seconds=name, seconds=time.perf_counter() - t0))
    return out


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

    import threading

    from pie_tpu_torch.ops import quant_matmul_cuda as qmc

    # phase 15a, g++ building native/, beside the nvcc builds
    native_build = {}

    def build_native_bg():
        try:
            native_build["row"] = build_native()
        except BaseException as e:  # re-raised below, on the main thread
            native_build["error"] = e

    gxx = threading.Thread(target=build_native_bg)
    gxx.start()
    t0 = time.perf_counter()
    paths = qmc.build()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libs=sorted(str(p) for p in paths.values())))
    gxx.join()
    if "error" in native_build:
        raise native_build["error"]

    probe = timed("kernels B7", phase_hbm_probe, card)
    rows = timed("kernels K1/K2 8B", phase_kernels)
    rows_1b = timed("kernels K1/K2 1B", phase_kernels_1b)
    ln_rows = timed("kernels K1 ln pre-pass", phase_ln_prepass)
    k4_rows = timed("kernels K4", phase_fused_mlp)
    k3_rows, k3_err = timed("kernels K3", phase_paged_kernel)
    k5_rows, k5_err = timed("kernels K5", phase_prefill_kernel, card, probe)
    timed("model 8B", phase_model)
    check_1b = timed("model 1B", phase_model_1b)
    # K2's INT4 weights with bf16 scales used to round twice; the parent's
    # reading of this check is in CHANGES.md (PRs 8-9)
    emit(dict(phase="model 1B check, K2 rounding", norm_err=check_1b,
              before_single_rounding=0.0271, limit=0.03))
    engine, eng = timed("engine 8B", phase_engine, card)
    timed("requests 8B", phase_requests, engine)
    paged = timed("paged engine 8B", phase_paged_engine, engine.model, engine.params, card)
    timed("graphs vs eager 8B", phase_graphs, engine.model, engine.params,
          "llama3-8b int4 g64")
    timed("batched requests 8B", phase_batched_requests, engine.model, engine.params)
    timed("constrained 8B", phase_constrained, engine, card)
    native8 = timed("native 8B", phase_native_8b, engine, card)
    tp1 = timed("16a tp=1 over NCCL 8B", phase_tp1_nccl, engine.model, engine.params, card)
    del engine
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="pie-1b-") as tmp:
        snap = Path(tmp)
        timed("snapshot 1B", write_snapshot_1b, snap)
        timed("serve 1B", phase_serve, snap)
        eng1b, model1b = timed("engine 1B", phase_engine_1b, snap, card)
        timed("graphs vs eager 1B", phase_graphs, *model1b,
              "llama3.2-1b int4 g64 (snapshot)")
        del model1b
        torch.cuda.empty_cache()
        paged1b = timed("paged engine 1B", phase_paged_engine_1b, snap, card)
        native_proc = timed("native engine process 1B", phase_native_process, snap, card)
        native_http = timed("native server 1B", phase_native_serve, snap)
        front = timed("16d frontier 1B", phase_frontier, snap, card)
    gemma = timed("gemma3", phase_gemma3, card)
    qwen = timed("qwen2.5-vl", phase_qwen2vl, card)
    gvis = timed("gemma3 vision", phase_gemma3_vision, card)
    torch.cuda.empty_cache()
    tp2 = timed("16b tp=2 over gloo 8B", phase_tp2, card)
    shard_k = timed("16c K1 / K2 at shard shapes", phase_shard_kernels, card)

    summary = []
    for kname, src, what, per_rows, launches in (
        ("K1", "pie_tpu_torch/csrc/quant_gemv.cu", "8B int4 g64, per decoded token",
         rows["K1"], eng["launches"]["K1"]),
        ("K2", "pie_tpu_torch/csrc/quant_gemm.cu", "8B int4 g64, per 512-token prefill",
         rows["K2"], eng["launches"]["K2"]),
        ("K2", "pie_tpu_torch/csrc/quant_gemm.cu",
         "1B int4 g64 with the f32-scale tied head, per 512-token prefill",
         rows_1b["K2"], eng1b["launches"]["K2"]),
        ("K1", "pie_tpu_torch/csrc/quant_gemv.cu",
         "Qwen2.5-VL-7B int4 g64, per decoded token", qwen["rows"][1],
         qwen["engine"]["launches"]["K1"]),
        ("K2", "pie_tpu_torch/csrc/quant_gemm.cu",
         "Qwen2.5-VL-7B int4 g64, per 512-token prefill", qwen["rows"][512],
         qwen["engine"]["launches"]["K2"]),
    ):
        total = lambda key: sum(per * r[key] for per, r in per_rows)
        summary.append(dict(
            name=f"{kname} {'quant_gemv' if kname == 'K1' else 'quant_gemm'} ({what})",
            route="cuda", source=src,
            replaces="pie_tpu/ops/quant_matmul_pallas.py:593",
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for _, r in per_rows),
            ms=total("kernel_ms"), kernel_ms=total("kernel_ms"), plain_ms=total("plain_ms"),
            **summed_bound(per_rows, probe), library_ms=total("library_ms"),
            tflop_s=sum(per * r["flops"] for per, r in per_rows) / total("kernel_ms") / 1e9,
        ))
    ln1 = ln_rows[(1, D)]  # per decoded 8B token: wqkv and wgu of every layer, the head
    summary.append(dict(
        name="K1 ln pre-pass (8B, M = 1, per decoded token; inside K1's time)",
        route="cuda", source="pie_tpu_torch/csrc/quant_gemv.cu",
        replaces="pie_tpu/ops/quant_matmul_pallas.py:294",
        launches=eng["launches"]["K1 ln"], max_abs_err=max(r["max_abs_err"]
                                                          for r in ln_rows.values()),
        **{key: (2 * LAYERS + 1) * ln1[key]
           for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
        ms=(2 * LAYERS + 1) * ln1["kernel_ms"], bound_by="bytes",
    ))
    for label, per_rows in (("K2 per 8B 512-token prefill", rows["K2"]),
                            ("K2 per 1B 512-token prefill", rows_1b["K2"]),
                            ("K1 per 8B paged decode step (M = 8)", rows["K1 M=8"]),
                            ("K1 per 1B paged decode step (M = 8)", rows_1b["K1 M=8"]),
                            *((f"K1 per 8B decode step at M = {m}", rows[f"K1 M={m}"])
                              for m in K1_ROWS if m not in (1, 8))):
        emit(dict(phase="summary", case=label,
                  launches=sum(per for per, _ in per_rows),
                  **{key: sum(per * r[key] for per, r in per_rows)
                     for key in ("kernel_ms", "plain_ms", "library_ms", "flops", "bytes")},
                  **summed_bound(per_rows, probe)))
    k3 = k3_rows[True]  # per device step: one launch per layer
    summary.append(dict(
        name="K3 paged_attention (8B heads, 8 lanes x 2,048-token INT8 pages, "
             "per device step)",
        route="cuda", source="pie_tpu_torch/csrc/paged_attention.cu",
        replaces="pie_tpu/ops/paged_attention.py:510",
        launches=paged["launches"]["K3"], max_abs_err=k3_err,
        ms=LAYERS * k3["kernel_ms"], kernel_ms=LAYERS * k3["kernel_ms"],
        plain_ms=LAYERS * k3["plain_ms"], bound_ms=LAYERS * k3["bound_ms"],
        bound_by=k3["bound_by"], library_ms=LAYERS * k3["library_ms"],
    ))
    g3 = gemma["k3"][True]  # per 4B device step: one launch per layer
    summary.append(dict(
        name="K3 paged_attention_d256 (B8: Gemma-3 4B heads 8 / 4, D 256, 8 lanes x "
             "2,048-token INT8 pages, 29 layers windowed to 1,024 + 5 full, per device step)",
        route="cuda", source="pie_tpu_torch/csrc/paged_attention.cu",
        replaces="pie_tpu/ops/paged_attention.py:510",
        launches=gemma["paged"]["launches"]["K3"], max_abs_err=gemma["k3_err"],
        ms=g3["kernel_ms"], kernel_ms=g3["kernel_ms"], plain_ms=g3["plain_ms"],
        bound_ms=g3["bound_ms"], bound_by=g3["bound_by"], library_ms=g3["library_ms"],
    ))
    q3 = qwen["k3"][True]  # per Qwen2.5-VL-7B device step: one launch per layer
    summary.append(dict(
        name="K3 paged_attention (Qwen2.5-VL-7B heads 28 / 4, a group of 7, D 128, "
             "8 lanes x 2,048-token INT8 pages, per device step)",
        route="cuda", source="pie_tpu_torch/csrc/paged_attention.cu",
        replaces="pie_tpu/ops/paged_attention.py:510",
        launches=qwen["paged"]["launches"]["K3"], max_abs_err=qwen["k3_err"],
        ms=Q7_LAYERS * q3["kernel_ms"], kernel_ms=Q7_LAYERS * q3["kernel_ms"],
        plain_ms=Q7_LAYERS * q3["plain_ms"], bound_ms=Q7_LAYERS * q3["bound_ms"],
        bound_by=q3["bound_by"], library_ms=Q7_LAYERS * q3["library_ms"],
    ))
    for name in ("qwen 256 at 0", "qwen 256 at 3840", "mistral 256 at 0"):
        k5 = k5_rows[name]  # every layer's launch: one chunk
        summary.append(dict(
            name=f"K5 prefill_attention ({k5['hq']} / {k5['hkv']} heads, D 128, INT8 "
                 f"pages, {k5['tokens']} tokens at positions {k5['first']}-"
                 f"{k5['first'] + k5['tokens'] - 1} over a {k5['table_pages']}-page "
                 f"table, per {k5['layers']}-layer chunk)",
            route="cuda", source="pie_tpu_torch/csrc/paged_prefill_attention.cu",
            replaces=None, launches=paged["launches"]["K5"], max_abs_err=k5_err,
            ms=k5["kernel_ms"], kernel_ms=k5["kernel_ms"], plain_ms=k5["plain_ms"],
            bound_ms=k5["bound_ms"], bound_by=k5["bound_by"], library_ms=k5["library_ms"],
        ))
    k4 = k4_rows[(4, 1)]  # per decoded token at 1B: one launch per layer
    summary.append(dict(
        name="K4 fused_mlp (1B int4 g64, M = 1, per decoded token)",
        route="cuda", source="pie_tpu_torch/csrc/fused_mlp.cu",
        replaces="pie_tpu/ops/fused_mlp_pallas.py:270",
        launches=eng1b["launches"]["K4"],
        max_abs_err=max(r["max_abs_err"] for r in k4_rows.values()),
        ms=LAYERS1 * k4["kernel_ms"], kernel_ms=LAYERS1 * k4["kernel_ms"],
        plain_ms=LAYERS1 * k4["plain_ms"], bound_ms=LAYERS1 * k4["bound_ms"],
        bound_by=k4["bound_by"], library_ms=LAYERS1 * k4["library_ms"],
        unfused_ms=LAYERS1 * k4["unfused_ms"],
        paged_launches=paged1b["launches"]["K4"],
    ))
    k4_8 = k4_rows[(4, 8)]  # per 1B paged decode step: one launch per layer at M = 8
    emit(dict(phase="summary", case="K4 per 1B paged decode step (M = 8)",
              launches=LAYERS1, plan=k4_8["plan"], **with_probe(dict(
                  bound_by=k4_8["bound_by"],
                  **{key: LAYERS1 * k4_8[key] for key in (
                      "kernel_ms", "plain_ms", "unfused_ms", "library_ms", "bound_ms")}), probe)))
    k1_1b = sum(per * r["kernel_ms"] for per, r in rows_1b["K1"])
    emit(dict(phase="summary 1B", k1_ms_per_decoded_token=k1_1b,
              k1_library_ms_per_decoded_token=sum(per * r["library_ms"]
                                                  for per, r in rows_1b["K1"]),
              k1_bound_ms_per_decoded_token=sum(per * r["bound_ms"]
                                                for per, r in rows_1b["K1"]),
              k1_bound_probe_ms_per_decoded_token=summed_bound(
                  rows_1b["K1"], probe).get("bound_probe_ms"),
              k4_ms_per_decoded_token=LAYERS1 * k4["kernel_ms"],
              k3_per_device_step=with_probe(dict(
                  bound_by=k3_rows["1B"]["bound_by"],
                  **{key: LAYERS1 * k3_rows["1B"][key]
                     for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}), probe),
              decode_tok_s=eng1b["decode_tok_s"], paged_tok_s=paged1b["decode_tok_s"]))
    emit(dict(phase="summary gemma3", k3_per_device_step_bf16=with_probe(dict(
        (key, gemma["k3"][False][key])
        for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")), probe),
        model_checks=gemma["checks"], decode_tok_s=gemma["engine"]["decode_tok_s"],
        ttft_p50_ms=gemma["engine"]["ttft_p50_ms"],
        paged_tok_s=gemma["paged"]["decode_tok_s"],
        paged_ctx2048_tok_s=gemma["paged"]["ctx2048_tok_s"],
        k1_per_decoded_token=gemma["engine"]["k1_per_decoded_token"],
        k2_per_prefill=gemma["engine"]["k2_per_prefill"],
        k3_per_paged_step=gemma["paged"]["k3_per_step"],
        graph_pool_bytes=dict(single=gemma["engine"]["graphs"],
                              paged=gemma["paged"]["graphs"]), card=card))
    emit(dict(phase="summary qwen2.5-vl", card=card, model_checks=qwen["checks"],
              k1_per_decoded_token=qwen["engine"]["k1_per_decoded_token"],
              k2_per_prefill=qwen["engine"]["k2_per_prefill"],
              **{f"{name}_{key}": sum(per * r[key] for per, r in qwen["rows"][m])
                 for name, m in (("k1_m1", 1), ("k1_m8", 8), ("k2_m512", 512))
                 for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
              **{f"{name}_{key}": value
                 for name, m in (("k1_m1", 1), ("k1_m8", 8), ("k2_m512", 512))
                 for key, value in summed_bound(qwen["rows"][m], probe).items()
                 if key != "bound_ms"},
              k3_per_device_step_bf16=with_probe(dict(
                  bound_by=qwen["k3"][False]["bound_by"],
                  **{key: Q7_LAYERS * qwen["k3"][False][key]
                     for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}), probe),
              ttft_p50_ms=qwen["engine"]["ttft_p50_ms"], image=qwen["engine"]["image"],
              decode_tok_s=qwen["engine"]["decode_tok_s"],
              image_decode_tok_s=qwen["engine"]["image_decode_tok_s"],
              paged_tok_s=qwen["paged"]["decode_tok_s"],
              k3_per_paged_step=qwen["paged"]["k3_per_step"],
              http=qwen["http"] is not None))
    ge = gvis["engine"]
    emit(dict(phase="summary gemma3 vision", card=card,
              model_check=gvis["check"]["norm_err"],
              tower_norm_err=gvis["check"]["tower_norm_err"],
              projector_norm_err=gvis["check"]["projector_norm_err"],
              tower_ms=ge["tower_ms"], tower_bound_ms=ge["tower_bound_ms"],
              tower_bound_f32_ms=ge["tower_bound_f32_ms"], image=ge["image"],
              image_2chunks=ge["image_2chunks"], image_decode_tok_s=ge["image_decode_tok_s"],
              paged_tok_s=gvis["paged"]["decode_tok_s"],
              launches=dict(k1_per_decoded_token=ge["k1_per_decoded_token"],
                            k2_per_prefill=ge["k2_per_prefill"],
                            k3_per_paged_step=gvis["paged"]["k3_per_step"]),
              graphs_vs_eager=ge["graphs_vs_eager"], http=gvis["http"] is not None))
    emit(dict(phase="summary prefill graphs", card=card, geometries={
        label: dict(ttft_p50_ms=row["ttft_p50_ms"],
                    **{k: row[k] for k in ("prefill_512", "prefill_2048") if k in row},
                    prefill_graphs=row["graphs"]["by_kind"].get("prefill"),
                    pool_bytes=row["graphs"]["pool_bytes"])
        for label, row in (("llama3-8b", eng), ("llama3.2-1b", eng1b),
                           ("gemma3-4b", gemma["engine"]),
                           ("qwen2.5-vl-7b", qwen["engine"]))},
        ttft_under_load_p50_ms=dict(llama3_8b=paged["ttft_under_load_p50_ms"],
                                    llama32_1b=paged1b["ttft_under_load_p50_ms"]),
        aten_calls_per_8b_admission=paged["aten_calls_per_admission"]))
    emit(dict(phase="summary native scheduler", card=card,
              build=native_build["row"],
              native_tok_s=native8["native_tok_s"], python_tok_s=native8["python_tok_s"],
              host_ms_per_step=native8["steady"]["host_ms_per_step"],
              device_ms_per_step=native8["steady"]["device_ms_per_step"],
              idle_share_32_steps=native8["steady"]["idle_share_32_steps"],
              aten_calls_per_step=native8["steady"]["aten_calls_per_step"],
              graphs_by_kind=native8["graphs"]["by_kind"], launches=native8["launches"],
              tokens_shared_with_python=native8["tokens_shared_with_python"],
              graphs_vs_eager=native8["graphs_vs_eager"],
              model_check=native8["model_check"]["norm_err"],
              engine_process=dict((k, native_proc[k]) for k in (
                  "start_to_ready_s", "first_request_ms", "ms_per_request",
                  "process_launches", "k4_per_decode_step")),
              server=dict(startup_s=native_http["startup_s"],
                          concurrent_wall_ms=native_http["concurrent_wall_ms"],
                          json_schema_content=native_http["json_schema_content"],
                          logit_bias_status=native_http["logit_bias_status"])))
    emit(dict(phase="summary parallel", card=card,
              tp1_nccl=dict(tokens_equal=tp1["tokens_equal"], tok_s=tp1["tok_s"],
                            collectives_per_step=tp1["steady"]["mesh"]["collectives_per_step"],
                            aten_calls_per_step=tp1["aten_calls_per_step"],
                            graphs_by_kind=tp1["graphs"]["by_kind"],
                            launches=tp1["launches"], steps=tp1["steps"]),
              tp2_gloo=[dict(rank=r["rank"], launches=r["launches"],
                             device_steps=r["device_steps"], tok_s=r["tok_s"],
                             **{k: r[k] for k in ("logits_norm_err", "tokens_shared_with_tp1")
                                if k in r}) for r in tp2["ranks"]],
              shard_kernels=dict(shapes=shard_k["shapes"],
                                 max_norm_err=max(r["norm_err"] for r in shard_k["rows"])),
              frontier=dict((k, front[k]) for k in (
                  "added_ms_per_request", "direct_ms_p50", "relayed_ms_p50",
                  "in_flight_at_kill", "answered_after_kill"))))
    for path in ("ldg", "tma"):
        r = probe[path]
        summary.append(dict(
            name=f"B7 hbm_read {path} (4 GiB read, per probe call; off the serving path)",
            route="cuda", source="pie_tpu_torch/csrc/hbm_read.cu",
            replaces="benchmarks/hbm_peak.py:56", launches=probe["launches"][f"B7 {path}"],
            max_abs_err=max(probe["check_err"][path], r["max_abs_err"]),
            ms=r["ms"], kernel_ms=r["ms"], plain_ms=probe["plain"]["ms"],
            bound_ms=probe["bound_ms"], bound_by="bytes", library_ms=probe["library"]["ms"],
            read_bytes_per_s=r["read_bytes_per_s"], plan=r["plan"],
        ))
    for row in summary:
        with_probe(row, probe)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
