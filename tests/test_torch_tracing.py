"""The port's host tracer (pie_tpu_torch.utils.profiling) on the CPU: spans
nest per thread with parent ids and thread CPU time, nothing is recorded
while it is off and nothing is held once a window is closed, its anchors
put a span on torch.profiler's clock, and the batching service stamps each
request and records its scheduler's steps, chunks and read-backs, through
the same methods the benchmark's slice wraps."""

import gc
import threading
import time
import weakref

import pytest
import torch

from pie_tpu_torch.utils import profiling

TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
            rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=256,
            tie_word_embeddings=False, model_type="llama")
#: a prompt whose body (prompt - 1 tokens) prefills directly (over 32
#: tokens), in chunks of 16
LONG = [(7 * i) % 200 + 20 for i in range(50)]


@pytest.fixture
def tracing():
    profiling.enable()
    yield profiling
    profiling.disable()


@pytest.fixture(scope="module")
def engine():
    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    model = LlamaModel(LlamaConfig.from_dict(TINY))
    params = model.init_params(seed=3, dtype=torch.float32, device="cpu")
    eng = BatchedInferenceEngine(model=model, params=params, num_lanes=4, num_pages=32,
                                 max_pages_per_seq=8, prefill_chunk=16,
                                 kv_dtype=torch.float32, device="cpu")
    yield eng
    eng.shutdown()
    torch.set_num_threads(n)


def _spin(ns: int) -> None:
    """Busy for ``ns`` of this thread's CPU time."""
    end = time.thread_time_ns() + ns
    while time.thread_time_ns() < end:
        pass


def _settled() -> dict:
    """The window once every span that has a recorded child has ended too:
    a caller's last token comes back while the scheduler's step that
    handed it out is still open."""
    deadline = time.monotonic() + 30
    while True:
        got = profiling.collect()
        ids = {s.id for s in got["spans"]}
        if all(s.parent in ids for s in got["spans"] if s.parent) or time.monotonic() > deadline:
            return got
        time.sleep(0.01)


class _Seq:
    """A request as the tracer reads it: an id and three stamps."""

    def __init__(self, i, stamps=(0, 0, 0)):
        self.seq_id = i
        self.t_submit, self.t_admit, self.t_first = stamps


def test_spans_nest_with_parents_requests_attrs_and_cpu(tracing):
    """Parents per thread and thread CPU time on the spans; a registered
    request is read with its stamps as they stand at the collect."""
    seq = _Seq(7)
    profiling.request(seq)
    with profiling.span("outer"):
        with profiling.span("inner"):
            _spin(2_000_000)
        seq.t_submit, seq.t_admit = 5, 6
    other = threading.Thread(target=lambda: profiling.span("elsewhere").__enter__()
                             .__exit__(None, None, None))
    other.start()
    other.join(timeout=10)
    assert not other.is_alive()
    got = profiling.collect()
    spans = {s.name: s for s in got["spans"]}
    o, i, e = spans["outer"], spans["inner"], spans["elsewhere"]
    assert o.parent == 0 and i.parent == o.id and e.parent == 0
    assert len({o.id, i.id, e.id}) == 3
    assert got["requests"] == [profiling.Request(7, 5, 6, 0)]
    assert o.start_ns <= i.start_ns < i.end_ns <= o.end_ns
    assert i.end_ns - i.start_ns >= 2_000_000
    assert i.cpu_ns >= 2_000_000 and o.cpu_ns >= i.cpu_ns


def test_off_records_nothing_and_returns_the_shared_no_op():
    profiling.disable()
    s = profiling.span("x")
    assert s is profiling.OFF and profiling.span("y") is profiling.OFF
    with s as inside:
        assert not inside
    profiling.request(_Seq(1, (1, 2, 3)))
    profiling.enable()
    try:
        got = profiling.collect()
        assert got["spans"] == [] and got["requests"] == []
        assert got["dropped"] == {"spans": 0, "requests": 0}
    finally:
        profiling.disable()


def test_windows_are_bounded_and_cleared(tracing, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    monkeypatch.setattr(profiling, "MAX_REQUESTS", 1)

    for i in range(5):
        with profiling.span(f"s{i}"):
            pass
        profiling.request(_Seq(i))
    got = profiling.collect()
    assert [s.name for s in got["spans"]] == ["s0", "s1", "s2"]
    assert [r.id for r in got["requests"]] == [0]
    assert got["dropped"] == {"spans": 2, "requests": 4}
    a0, a1 = got["anchors"]
    assert a0[0] < a1[0] and a0[1] < a1[1]
    profiling.enable()
    got = profiling.collect()
    assert got["spans"] == [] and got["dropped"] == {"spans": 0, "requests": 0}


def test_spans_land_on_the_profiler_clock(tracing):
    """A program span around a record_function block, converted through
    the anchors, encloses the profiler's event to within 50 us at each end:
    no block's event starts before its span or ends after it by more, and
    the closest block's ends lie within 50 us of the event's (entering
    record_function takes tens of us on a loaded CPU, and a preempted block
    only widens its own margins)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        for i in range(40):
            with profiling.span(f"blk{i}"):
                with record_function(f"blk{i}"):
                    pass
            time.sleep(0.001)
    got = profiling.collect()
    events = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("blk")}
    lead, tail = [], []
    for s in got["spans"]:
        es, et = events[s.name]
        lead.append(es - profiling.to_profiler_ns(got["anchors"], s.start_ns))
        tail.append(profiling.to_profiler_ns(got["anchors"], s.end_ns) - et)
    assert len(lead) == 40
    assert -50_000 <= min(lead) <= 50_000, sorted(lead)
    assert -50_000 <= min(tail) <= 50_000, sorted(tail)


def test_batched_service_stamps_requests_and_records_its_spans(engine, tracing):
    short = [5, 17, 42, 7]
    results = [None, None]

    def run(i, prompt):
        results[i] = engine.generate(prompt, max_completion_tokens=6, temperature=0.0)

    threads = [threading.Thread(target=run, args=(i, p)) for i, p in enumerate((LONG, short))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert [len(r.token_ids) for r in results] == [6, 6]
    got = _settled()
    reqs = got["requests"]
    assert len(reqs) == 2
    for r in reqs:
        assert 0 < r.t_submit <= r.t_admit <= r.t_first
    spans = got["spans"]
    by_id = {s.id: s for s in spans}
    assert {s.name for s in spans} == {"pie.sched.step", "pie.engine.chunk",
                                       "pie.sched.readback"}
    steps = [s for s in spans if s.name == "pie.sched.step"]
    assert all(s.parent == 0 for s in steps)
    # each chunk and each read-back inside the step that dispatched or
    # drained it
    for name in ("pie.engine.chunk", "pie.sched.readback"):
        inner = [s for s in spans if s.name == name]
        assert inner
        for c in inner:
            p = by_id[c.parent]
            assert p.name == "pie.sched.step" and p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns


def test_the_benchmark_slice_still_wraps_every_method(engine, tracing):
    """portbench's slice wraps the scheduler's and the paged engine's
    methods as instance attributes; the program's own calls still go
    through them, so it sees every chunk and direct prefill the spans do."""
    from portbench.tracing import SPANS, Slice

    sched, core = engine.scheduler, engine.core
    sl = Slice(float("inf"), 2.0)
    sl.install(sched, core)
    try:
        for name in [*SPANS, "_emit_chunk"]:
            assert name in vars(sched), name
        assert "_chunk" in vars(core) and "_prefill" in vars(core)
        res = engine.generate(LONG, max_completion_tokens=5, temperature=0.0)
        assert len(res.token_ids) == 5
    finally:
        for name in [*SPANS, "_emit_chunk"]:
            vars(sched).pop(name, None)
        vars(core).pop("_chunk", None)
        vars(core).pop("_prefill", None)
    spans = _settled()["spans"]
    assert len(sl.chunks) == sum(1 for s in spans if s.name == "pie.engine.chunk") > 0
    # the prompt's 49-token body in direct prefills of 16, 16, 16 and 1
    assert len(sl.prefills) == 4
    assert all(c["ctxs"] is not None for c in sl.chunks)


def test_metrics_read_queue_wait_and_ttft_from_the_stamps(engine):
    from pie_tpu_torch.utils.metrics import get_metrics

    def counts():
        lines = dict(line.rsplit(" ", 1) for line in get_metrics().render().splitlines())
        return (int(lines["pie_ttft_seconds_count"]),
                int(lines["pie_queue_wait_seconds_count"]))

    before = counts()
    engine.generate([9, 3, 3, 7, 1], max_completion_tokens=3, temperature=0.0)
    deadline = time.monotonic() + 10
    while counts() == before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert counts() == (before[0] + 1, before[1] + 1)


def test_a_closed_window_holds_no_request():
    """``disable()`` lets go of the registered requests and the spans: a
    request finished after the close is not kept alive by the tracer."""
    profiling.enable()
    seq = _Seq(3)
    profiling.request(seq)
    with profiling.span("s"):
        pass
    assert len(profiling.collect()["requests"]) == 1
    profiling.disable()
    ref = weakref.ref(seq)
    del seq
    gc.collect()
    assert ref() is None
    profiling.enable()
    try:
        got = profiling.collect()
        assert got["spans"] == [] and got["requests"] == []
    finally:
        profiling.disable()
