"""One run of one cell: build the served model from the seed, warm up the
shapes the cell's traffic uses, drive the traffic through the batching
service for the window, then judge what it served against the plain
reference and read the metrics.

Everything that belongs to a configuration, a traffic mix, a cell's check
or a metric is a file of its own, found by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``checks/<workload>.json`` and ``metrics/<metric>.py``; what belongs to a
model (its weights, reference, FLOPs and request inputs) is the kit that
its configuration names (``kit.py``).

The entry the window drives is ``pie_tpu_torch``'s
``BatchedInferenceEngine.generate_stream`` (the Python scheduler over the
paged engine, INT8 KV pages, captured step graphs), called from client
threads of this process with greedy sampling and no stop tokens, so that
every request yields exactly the tokens it asks for, and with the inputs
it carries (``extras``: an image's ``pixel_values`` and ``image_kwargs``).
Weights are the kit's Hugging Face state dict (bf16, made on the device
from the seed), read by the model's ``from_hf_state_dict`` and quantized on
load by its ``quantize_params``, as the server's loader does.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import sys
import threading
import time
from pathlib import Path
from typing import Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "pie_tpu")
#: the traced slice's length, and how long before the window's close it
#: ends (closing the profiler holds the interpreter for seconds: that
#: stall falls after the window)
SLICE_S, SLICE_END_S = 2.0, 0.5
#: how long after the close client threads are waited for
DRAIN_S = 60.0
#: prompt bodies (prompt - 1 tokens) longer than this prefill directly in
#: the port's scheduler; shorter ones ride mixed steps
DIRECT_PREFILL_MIN = 32


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: Path, workload: str) -> tuple:
    """(cell, configuration, traffic, check) of a workload, each read from
    its own file by name."""
    m = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in m["configs"]}[cell["config"]]
    cfg = read_json(root / conf["file"])
    traffic = read_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    check = read_json(root / "portbench" / "checks" / f"{workload}.json")
    return cell, cfg, traffic, check


def cell_metrics(root: Path, workload: str, trace: bool) -> list:
    """The cell's metrics: end-to-end with ``trace`` off, per-layer with it
    on; a metric without ``workloads`` belongs to every cell."""
    m = read_json(root / "BENCHMARK.json")
    kind = "per_layer" if trace else "end_to_end"
    return [x for x in m[kind] if workload in x.get("workloads", [workload])]


def load_reader(root: Path, name: str):
    """The reader module ``metrics/<name>.py``."""
    from portbench import kit

    return kit.load(f"portbench/metrics/{name}.py", root)


@dataclasses.dataclass
class Record:
    """One request as its client saw it (host perf_counter seconds)."""

    index: int
    prompt: list
    max_tokens: int
    due: float  # when it was due to be sent
    sent: float = 0.0
    times: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    finished: Optional[float] = None  # all its tokens arrived
    error: Optional[str] = None
    extras: dict = dataclasses.field(default_factory=dict)  # its inputs


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cfg: dict
    traffic: dict
    seconds: float
    setup_s: float
    t_open: float
    t_close: float
    records: list
    lanes: int
    counters: dict
    trace: dict = dataclasses.field(default_factory=dict)
    kit: object = None  # the configuration's kit module
    #: record index -> the prompt embeddings [plen, D] the service made
    #: from the request's inputs (``record_embeddings``)
    embeds: dict = dataclasses.field(default_factory=dict)

    @property
    def sent(self) -> list:
        """Every request due in the window, whether or not a client thread
        had sent it yet."""
        return [r for r in self.records if r.due <= self.t_close]


# -- the served model --------------------------------------------------------


def build_engine(cfg: dict, seed: int, device, root: Optional[Path] = None):
    """The batching service over the model the configuration describes,
    weights from the seed (its kit's, read under ``root``), quantized on
    load."""
    import torch

    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
    from pie_tpu_torch.models.loader import build_model

    from portbench import kit

    a = cfg["assumed"]
    model = build_model({k: v for k, v in cfg.items() if k != "assumed"})
    sd = kit.of(cfg, root).state_dict(cfg, seed, device)
    params = model.from_hf_state_dict(sd, dtype=torch.bfloat16)
    del sd
    params = quantize_in_slices(model, params, a["weight_group_size"], a["weight_bits"])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return BatchedInferenceEngine(
        model, params, num_lanes=a["lanes"], num_pages=a["pool_pages"],
        max_pages_per_seq=a["max_pages_per_seq"], prefill_chunk=a["prefill_chunk"],
        kv_quantized=a["kv_bits"] == 8, decode_steps=a["decode_steps"],
        seed=seed & 0x7FFFFFFF, device=device,
    )


def record_embeddings(engine) -> dict:
    """Keep what the batching service's tower call makes: the prompt
    embeddings [plen, D] it writes an image request's features into, which
    the request's rider slices read, by the identity of the request's
    ``pixel_values`` (the call is an instance attribute: the scheduler
    thread calls through it)."""
    made = {}
    embed = engine._embed_images

    def recorded(seq):
        pixels = seq.image_inputs[0]
        ok = embed(seq)
        if ok:
            made[id(pixels)] = seq.prompt_embeds
        return ok

    engine._embed_images = recorded
    return made


def quantize_in_slices(model, params: dict, group: int, bits: int,
                       layers_per_slice: int = 4) -> dict:
    """``model.quantize_params`` over a few layers at a time, the slices'
    stacked tensors joined along the layer axis: the same tensors as one
    call over every layer (each group of each column is quantized on its
    own), at a seventh or an eighth of its transient memory (one call over
    Mistral-7B's fused gate / up stack would need ~75 GB)."""
    import torch

    from pie_tpu_torch.ops.quant import QuantizedTensor

    layers = params["layers"]
    n = next(iter(layers.values())).shape[0]
    head = {k: params[k] for k in ("lm_head",) if k in params}
    parts = []
    for a in range(0, n, layers_per_slice):
        sub = {k: v for k, v in params.items() if k not in ("layers", "lm_head")}
        sub["layers"] = {k: v[a:a + layers_per_slice] for k, v in layers.items()}
        if a == 0:
            sub.update(head)
        parts.append(model.quantize_params(sub, group, bits))
    out = dict(parts[0])
    out["layers"] = {}
    for k, v in parts[0]["layers"].items():
        vs = [p["layers"][k] for p in parts]
        if isinstance(v, QuantizedTensor):
            out["layers"][k] = dataclasses.replace(
                v, **{f: torch.cat([getattr(x, f) for x in vs])
                      for f in ("packed", "scales", "biases")})
        else:
            out["layers"][k] = torch.cat(vs)
    return out


def prefill_buckets(bodies, chunk: int) -> set:
    """The direct-prefill chunk buckets that prompt bodies (prompt - 1
    tokens) of these lengths use: chunks of ``chunk`` tokens, the last one
    padded to a power of two from 16 (bodies of ``DIRECT_PREFILL_MIN``
    tokens or fewer use none)."""
    out = set()
    for body in bodies:
        if body <= DIRECT_PREFILL_MIN:
            continue
        while body > 0:
            c = min(chunk, body)
            b = 16
            while b < c:
                b *= 2
            out.add(min(b, chunk))
            body -= c
    return out


def warm_up(engine, cfg: dict, traffic: dict, seed: int, device,
            root: Optional[Path] = None) -> None:
    """Run one request through every prefill bucket the traffic's prompt
    lengths reach (each decodes two tokens: the step graph too), all at
    once, then a full set of lanes at the traffic's shortest prompt; with
    them, where the traffic has inputs, the requests the kit warms them up
    with (for images: the tower at the largest image and the step that
    carries its embeddings)."""
    a = cfg["assumed"]
    chunk, lo_id = a["prefill_chunk"], a["ordinary_token_ids"][0]
    p = traffic["prompt_tokens"]
    bodies = range(int(p["min"]) - 1, int(p["max"]))
    lens = []
    for b in sorted(prefill_buckets(bodies, chunk)):
        body = b if b > DIRECT_PREFILL_MIN else chunk + b
        lens.append(body + 1)
    lens += [int(p["min"])] * a["lanes"]
    reqs = [([lo_id + (i % 97)] * n, {}) for i, n in enumerate(lens)]
    if "inputs" in traffic:
        from portbench import kit

        reqs += kit.of(cfg, root).warm_requests(traffic["inputs"], cfg, seed, device)
    threads = [threading.Thread(target=engine.generate, args=(prompt,),
                                kwargs=dict(max_completion_tokens=2, stop_token_ids=(),
                                            temperature=0.0, **extras))
               for prompt, extras in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


# -- the window --------------------------------------------------------------


def _client(engine, rec: Record, close_at: float) -> None:
    from pie_tpu_torch.errors import InferenceError

    rec.sent = time.perf_counter()
    gen = engine.generate_stream(rec.prompt, max_completion_tokens=rec.max_tokens,
                                 stop_token_ids=(), temperature=0.0, **rec.extras)
    try:
        for tok in gen:
            now = time.perf_counter()
            rec.times.append(now)
            rec.tokens.append(int(tok.token_id))
            if now > close_at:
                gen.close()
                return
        rec.finished = time.perf_counter()
    except InferenceError as e:  # the service finished it with an error
        rec.error = str(e)


def drive(engine, reqs: list, traffic: dict, seconds: float, lanes: int) -> tuple:
    """Send the traffic for ``seconds``; returns (open, close, records, the
    open loop's client futures)."""
    t_open = time.perf_counter()
    close_at = t_open + seconds
    records, futures = [], []
    if traffic["loop"] == "open":
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=4 * lanes)
        for r in reqs:
            due = t_open + r.due_s
            if due >= close_at:
                break
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            rec = Record(r.index, r.prompt, r.max_tokens, due, extras=r.extras)
            records.append(rec)
            futures.append(pool.submit(_client, engine, rec, close_at))
        _sleep_until(close_at)
        pool.shutdown(wait=False, cancel_futures=True)  # none is sent late
    else:
        queues: dict = {}
        for r in reqs:
            queues.setdefault(r.client, []).append(r)

        def client(mine):
            for r in mine:
                now = time.perf_counter()
                if now >= close_at:
                    return
                rec = Record(r.index, r.prompt, r.max_tokens, now, extras=r.extras)
                records.append(rec)
                _client(engine, rec, close_at)

        threads = [threading.Thread(target=client, args=(q,), daemon=True)
                   for q in queues.values()]
        for t in threads:
            t.start()
        _sleep_until(close_at)
    return t_open, close_at, records, futures


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def wait_clients(records: list, futures: list, close_at: float) -> None:
    """Wait (at most ``DRAIN_S``) until every client saw its next token
    after the close, finished, or failed: each cancels its request then.
    A client that raised raises here."""
    end = close_at + DRAIN_S
    while time.perf_counter() < end:
        if all(r.finished or r.error or (r.times and r.times[-1] > close_at)
               for r in records if r.sent):
            break
        time.sleep(0.05)
    for f in futures:
        if f.done() and not f.cancelled():
            f.result()


# -- a whole run ---------------------------------------------------------------


def serve(root: Path, workload: str, seed: int, seconds: float, trace: bool,
          device: str = "cuda", t_start: Optional[float] = None) -> tuple:
    """Set up, drive the window, free the program: (cell, run, the device's
    peak bytes in the window). The peak counter is reset once set-up is
    done, so the loader's transients do not count; set-up's own peak goes
    to ``run.counters``."""
    import torch

    from portbench import kit, tracing, traffic as traffic_mod

    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, traffic, _ = cell_files(root, workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    reqs = traffic_mod.requests(traffic, cfg, seed, seconds, dev, root)
    engine = build_engine(cfg, seed, dev, root)
    sched, core = engine.scheduler, engine.core
    made = record_embeddings(engine)
    tracer = None
    if trace:
        tracer = tracing.Slice(float("inf"), SLICE_S)
        tracer.install(sched, core, engine)
        if cuda:
            tracer.warm()
    warm_up(engine, cfg, traffic, seed, dev, root)
    made.clear()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    counters0 = dict(steps=core.device_steps, captures=core.graphs.captures,
                     capture_s=core.graphs.capture_seconds)
    if tracer is not None:
        tracer.start_at = time.perf_counter() + max(0.0, seconds - SLICE_S - SLICE_END_S)
    setup_s = time.perf_counter() - t_start
    t_open, t_close, records, futures = drive(engine, reqs, traffic, seconds,
                                              cfg["assumed"]["lanes"])
    counters = dict(steps=core.device_steps - counters0["steps"],
                    new_captures=core.graphs.captures - counters0["captures"],
                    capture_s=counters0["capture_s"], setup_peak_bytes=setup_peak,
                    pool_pages_held_at_close=(sched.manager.allocator.num_pages
                                              - sched.manager.num_free_pages()),
                    prefix_pages_at_close=len(sched.prefix_store or ()))
    wait_clients(records, futures, t_close)
    if tracer is not None and tracer.active:
        tracer.close()
    engine.shutdown()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(cfg, traffic, seconds, setup_s, t_open, t_close, records,
              cfg["assumed"]["lanes"], counters, kit=kit.of(cfg, root),
              embeds={r.index: made[id(px)] for r in records
                      if (px := r.extras.get("pixel_values")) is not None
                      and id(px) in made})
    del made
    if tracer is not None and cuda:
        run.trace = tracer.reduce()
    del engine, sched, core, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return cell, run, peak


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object (``compared`` last)."""
    import torch

    from portbench import check
    from portbench.tracing import breakdown

    cell, run, peak = serve(root, workload, seed, seconds, trace, device, t_start)
    dev = torch.device(device)
    metrics = {}
    for m in cell_metrics(root, workload, trace):
        value = load_reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = check.compare(run, run.cfg, cell_files(root, workload)[3], seed, dev)
    result = {
        "correct": all(c["ok"] for c in compared.values()),
        "attempted": len(run.sent),
        "failed": sum(1 for r in run.sent if r.error),
        "metrics": metrics,
        "device": device_info(dev, cell["chips"], peak, run.trace if trace else None),
    }
    if trace and run.trace:
        result["breakdown"] = breakdown(run.trace)
    judged = check.sample(run, seed, cell_files(root, workload)[3]["sample_tokens"])
    result["diagnostics"] = dict(diagnostics(run), requests_judged=len(judged),
                                 judged_with_inputs=sum(1 for r in judged if r.extras))
    result["compared"] = {k: {kk: v for kk, v in c.items() if kk != "ok"}
                          for k, c in compared.items()}
    result["_forbidden"] = sorted({name.split(".")[0] for name in sys.modules}
                                  & set(FORBIDDEN))
    return result


def device_info(dev, chips: int, peak: int, trace: Optional[dict]) -> dict:
    import torch

    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(peak)}
    if trace is not None:
        info["busy_s"] = trace.get("busy_s", 0.0)
        info["window_s"] = trace.get("window_s", 0.0)
    return info


def diagnostics(run: Run) -> dict:
    """Numbers beside the metrics, for the log: how late the generator ran,
    requests finished, captures inside the window (should be 0), set-up's
    device peak and the pool's pages held at the close (live sequences and
    the prefix store's cached prompts)."""
    from portbench import readers

    late = [r.sent - r.due for r in run.sent if r.sent]
    pct = {}
    for name, values in (("ttft", readers.ttft_values(run)), ("tpot", readers.tpot_values(run))):
        if values:
            pct.update({f"{name}_p{q}_ms": 1e3 * readers.pct(values, q) for q in (50, 90, 95)})
    return {
        **pct,
        "output_tok_s": readers.output_tok_s(run),
        "requests_finished": sum(1 for r in run.sent
                                 if r.finished and r.finished <= run.t_close),
        "generator_late_max_s": max(late) if late else 0.0,
        "captures_in_window": run.counters["new_captures"],
        "device_steps": run.counters["steps"],
        "setup_peak_bytes": run.counters["setup_peak_bytes"],
        "pool_pages_held_at_close": run.counters["pool_pages_held_at_close"],
        "prefix_pages_at_close": run.counters["prefix_pages_at_close"],
        "queued_at_close": sum(1 for r in run.sent if not r.times
                               or r.times[0] > run.t_close),
        "sent_with_inputs": sum(1 for r in run.sent if r.extras),
    }
