"""What the metric files (``metrics/<name>.py``) read, from a run's records,
the program's counters and the traced slice. A reader that finds nothing
to read returns None, and the run leaves its metric out.

Kernel names are the port's CUDA functions: K1 the decode GEMV
(``gemv_kernel``, with its rms-norm pre-pass ``ln_rows_kernel``), K2 the
prefill GEMM (``gemm_kernel``), K3 the paged decode attention
(``paged_attention_kernel``, and ``paged_attention_d256`` at head size
256). The port sends products of at most 32 rows to K1 and larger ones to
K2; a decode step's rows are its lanes.
"""

from __future__ import annotations

import numpy as np

from portbench import counts
from portbench.tracing import kernel_seconds

K1 = (r"\bgemv_kernel\b", r"\bln_rows_kernel\b")
K2 = (r"(^|::|\s)gemm_kernel\b",)
K3 = (r"\bpaged_attention_kernel\b", r"\bpaged_attention_d256\b")
K1_MAX_ROWS = 32


def pct(values: list, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def ttft_values(run) -> list:
    """Each request sent in the window: the time from when it was due to its
    first token; a request with no token by the close counts the time it
    had waited then."""
    return [min(r.times[0] if r.times else run.t_close, run.t_close) - r.due
            for r in run.sent]


def tpot_values(run) -> list:
    """(last token - first token) / (tokens - 1) of each request with two
    tokens or more inside the window."""
    per = []
    for r in run.sent:
        t = [x for x in r.times if x <= run.t_close]
        if len(t) >= 2:
            per.append((t[-1] - t[0]) / (len(t) - 1))
    return per


def ttft_ms(run, q: float):
    """The q-th percentile of ``ttft_values``, ms."""
    waits = ttft_values(run)
    return 1e3 * pct(waits, q) if waits else None


def tpot_ms(run, q: float):
    """The q-th percentile of ``tpot_values``, ms."""
    per = tpot_values(run)
    return 1e3 * pct(per, q) if per else None


def tokens_in_window(run) -> int:
    return sum(1 for r in run.records for t in r.times if run.t_open <= t <= run.t_close)


def output_tok_s(run):
    """Every output token streamed inside the window over its seconds."""
    return tokens_in_window(run) / run.seconds


def image_ttft_ms(run, q: float):
    """The q-th percentile of ``ttft_values`` over the requests that carry
    inputs (an image), ms; None where none was sent."""
    waits = [w for r, w in zip(run.sent, ttft_values(run)) if r.extras]
    return 1e3 * pct(waits, q) if waits else None


def token_gaps(run) -> list:
    """Every gap between two consecutive tokens of one request, both inside
    the window, over all requests."""
    gaps = []
    for r in run.records:
        t = [x for x in r.times if run.t_open <= x <= run.t_close]
        gaps.extend(b - a for a, b in zip(t, t[1:]))
    return gaps


def token_gap_ms(run, q: float):
    """The q-th percentile of ``token_gaps``, ms: the stall a tower call or
    a rider chunk puts into every decoding lane shows in its tail."""
    gaps = token_gaps(run)
    return 1e3 * pct(gaps, q) if gaps else None


def setup_s(run):
    """Process start to the window's opening: weights made and quantized,
    the kernels loaded (built on a checkout's first run), warm-up."""
    return run.setup_s


# -- per layer ------------------------------------------------------------------


def k1_roofline(run):
    """K1's work (every decode step's projections and head at the lanes'
    rows, the head of a mixed step, prefill chunks of at most 32 rows) at
    the data sheet's peaks, over K1's device time in the slice, in %."""
    tr = run.trace
    t = kernel_seconds(tr, K1) if tr else 0.0
    if t <= 0:
        return None
    cfg, b = run.cfg, run.lanes
    full = counts.bound_s(*counts.decode_pass(cfg, b))
    head = counts.bound_s(*counts.gemm_work([counts.head_shape(cfg)], b))
    work = 0.0
    for c in tr["chunks"]:
        mixed = sum(1 for r in c["rider_tokens"] if r > 0)
        work += (c["steps"] - mixed) * full + mixed * head
    for p in tr["prefills"]:
        if p["bucket"] <= K1_MAX_ROWS:
            work += counts.bound_s(*counts.prefill_pass(cfg, len(p["positions"])))
    return 100.0 * work / t


def k2_roofline(run):
    """K2's work (prefill chunks of more than 32 rows over the layers, and
    mixed steps' lanes plus rider tokens) at the data sheet's peaks, over
    K2's device time in the slice, in %."""
    tr = run.trace
    t = kernel_seconds(tr, K2) if tr else 0.0
    if t <= 0:
        return None
    cfg, b = run.cfg, run.lanes
    work = 0.0
    for p in tr["prefills"]:
        if p["bucket"] > K1_MAX_ROWS:
            work += counts.bound_s(*counts.prefill_pass(cfg, len(p["positions"])))
    for c in tr["chunks"]:
        for r in c["rider_tokens"]:
            if r > 0:
                work += counts.bound_s(*counts.gemm_work(counts.layers_shapes(cfg), b + r))
    return 100.0 * work / t


def k3_roofline(run):
    """K3's work (each step's lanes' context KV, once per layer) at the data
    sheet's peaks, over K3's device time in the slice, in %."""
    tr = run.trace
    t = kernel_seconds(tr, K3) if tr else 0.0
    if t <= 0:
        return None
    work = sum(counts.bound_s(*counts.attention_step(run.cfg, ctxs))
               for c in tr["chunks"] if c["ctxs"] for ctxs in c["ctxs"] if ctxs)
    return 100.0 * work / t


def mfu_pct(run):
    """Model FLOPs (the configuration's kit counts them) of the slice's
    decoded tokens, rider slices, prefill chunks and tower calls over its
    device-busy seconds at the bf16 peak, in %."""
    tr = run.trace
    if not tr or tr.get("busy_s", 0) <= 0:
        return None
    cfg, kit = run.cfg, run.kit
    flops = 0.0
    for c in tr["chunks"]:
        for ctxs in c["ctxs"] or []:
            flops += sum(kit.decode_token_flops(cfg, x) for x in ctxs)
        flops += sum(kit.rider_flops(cfg, r) for r in c["rider_tokens"])
    for p in tr["prefills"]:
        flops += kit.prefill_flops(cfg, p["positions"])
    for t in tr.get("towers", []):
        flops += kit.call_flops(cfg, t)
    return 100.0 * flops / (tr["busy_s"] * counts.BF16_FLOP_PER_S)


def device_idle_pct(run):
    """Share of the traced slice in which no operation ran on the device."""
    tr = run.trace
    if not tr or tr.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def tokens_per_step(run):
    """Output tokens streamed in the window over the device steps the paged
    engine dispatched in it (``PagedEngine.device_steps``)."""
    steps = run.counters["steps"]
    return tokens_in_window(run) / steps if steps else None


def graph_capture_s(run):
    """Host seconds the step graphs took to capture in set-up
    (``StepGraphs.capture_seconds``, their eager warm-up runs included)."""
    return run.counters["capture_s"]
