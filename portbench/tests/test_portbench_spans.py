"""The readings over the program's spans and request stamps
(``portbench/spans.py``): each on a synthetic run worked out by hand,
nothing where the program recorded nothing, and a whole CPU run with the
program's tracer on around the unchanged harness."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from pie_tpu_torch.utils.profiling import Request, Span
from portbench import harness, spans, tracing

MS = 1_000_000


def _span(name, start, end, cpu=0, sid=0, parent=0):
    return Span(name, start * MS, end * MS, cpu * MS, sid, parent)


def _run(requests=(), spans_=(), trace=None):
    # the window is [1.0 s, 2.0 s] on the host clock; the anchors make the
    # profiler's clock the host's plus 5 s
    prog = {"requests": list(requests), "spans": list(spans_), "dropped": {},
            "anchors": [(0, 5_000 * MS), (10_000 * MS, 15_000 * MS)]}
    return SimpleNamespace(t_open=1.0, t_close=2.0, program=prog, trace=trace or {})


def test_queue_wait_and_admit_to_first():
    reqs = [Request(1, 900 * MS, 1_100 * MS, 1_200 * MS),  # submitted before
            Request(2, 1_100 * MS, 1_150 * MS, 1_400 * MS),  # 50 ms, 250 ms
            Request(3, 1_200 * MS, 1_300 * MS, 0),           # 100 ms, to the close 700
            Request(4, 1_800 * MS, 0, 0),                    # not admitted: 200 ms
            Request(5, 1_900 * MS, 2_500 * MS, 2_600 * MS)]  # admitted after: 100 ms
    run = _run(reqs)
    assert spans.queue_wait_ms(run, 50) == pytest.approx(100.0)
    assert spans.queue_wait_ms(run, 100) == pytest.approx(200.0)
    # admitted in the window: 1 (100 ms), 2 (250 ms), 3 (700 ms)
    assert spans.admit_to_first_ms(run, 50) == pytest.approx(250.0)
    assert spans.admit_to_first_ms(run, 100) == pytest.approx(700.0)


def test_host_time_per_chunk_and_cpu_share():
    ss = [_span("pie.sched.step", 1_000, 1_030, cpu=12, sid=1),
          _span("pie.sched.readback", 1_010, 1_020, cpu=6, parent=1),
          _span("pie.engine.chunk", 1_002, 1_004, parent=1),
          _span("pie.sched.step", 1_100, 1_110, cpu=4, sid=2),
          _span("pie.engine.chunk", 1_101, 1_102, parent=2),
          _span("pie.sched.step", 2_100, 2_200, cpu=50),  # after the close
          _span("pie.engine.chunk", 2_101, 2_102)]
    run = _run(spans_=ss)
    # (30 - 10 + 10) ms of host time over 2 chunks; (12 - 6 + 4) ms of CPU
    assert spans.host_ms_per_chunk(run) == pytest.approx(15.0)
    assert spans.sched_cpu_pct(run) == pytest.approx(100.0 * 10 / 30)


def test_idle_host_share_of_the_slice():
    ss = [_span("pie.sched.step", 1_000, 1_030),
          _span("pie.sched.readback", 1_010, 1_020),
          _span("pie.sched.step", 1_040, 1_050)]
    # profiler clock = host + 5 s: the slice is [6.000, 6.100] s; idle gaps
    # [6.005, 6.015] (5 ms in a step, 5 in its read-back), [6.025, 6.045]
    # (5 in the first step, 5 between steps, 5 in the second), [6.090, 6.100]
    gaps = [(6_005 * MS, 6_015 * MS), (6_025 * MS, 6_045 * MS), (6_090 * MS, 6_100 * MS)]
    run = _run(spans_=ss, trace={"gaps": gaps, "window_s": 0.1, "busy_s": 0.06})
    assert spans.idle_host_pct(run) == pytest.approx(15.0)
    assert spans.idle_host_pct(run) <= 100.0 * (1 - 0.06 / 0.1)


def test_nothing_is_read_without_the_programs_window():
    run = SimpleNamespace(t_open=1.0, t_close=2.0, trace={"gaps": [], "window_s": 1.0})
    for fn in (spans.host_ms_per_chunk, spans.sched_cpu_pct, spans.idle_host_pct,
               lambda r: spans.queue_wait_ms(r, 50), lambda r: spans.admit_to_first_ms(r, 50)):
        assert fn(run) is None
    empty = _run()
    assert spans.queue_wait_ms(empty, 50) is None
    assert spans.host_ms_per_chunk(empty) is None
    assert spans.idle_host_pct(empty) is None  # no slice


def test_a_cpu_run_with_the_programs_tracer(tiny_root):
    drive, wait, gaps = harness.drive, harness.wait_clients, tracing._union_and_gaps
    _, run, _ = spans.serve("tiny-mistral.decode", 11, 8.0, False, True, root=tiny_root,
                            device="cpu")
    assert (harness.drive, harness.wait_clients, tracing._union_and_gaps) == (drive, wait, gaps)
    sent = [r for r in run.sent if r.sent]
    assert len(run.program["requests"]) >= len(sent) > 0
    assert spans.queue_wait_ms(run, 50) >= 0
    assert spans.host_ms_per_chunk(run) > 0
    assert 0 < spans.sched_cpu_pct(run) <= 101
    assert run.program["dropped"] == {"spans": 0, "requests": 0}
