"""Small port modules on the CPU: the profiling zones, the heartbeat and
the profiled allocator (pie_tpu_torch.utils.profiling; mirrors
tests/test_aux.py), the torch.profiler device trace, and the sync client's
request models (pie_tpu_torch.engine.client) serialising as the JAX
package's do."""

import json
import time

import pytest


def test_profiling_zones(monkeypatch):
    from pie_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "ENABLED", True)
    profiling.reset_zones()
    with profiling.zone("work"):
        time.sleep(0.01)

    @profiling.profiled
    def step():
        return 3

    assert step() == 3
    rep = profiling.zone_report()
    assert rep["work"]["count"] == 1
    assert rep["work"]["mean_ms"] >= 5
    assert rep["test_profiling_zones.<locals>.step"]["count"] == 1
    monkeypatch.setattr(profiling, "ENABLED", False)
    with profiling.zone("off"):
        pass
    assert "off" not in profiling.zone_report()


def test_heartbeat_liveness(tmp_path):
    from pie_tpu_torch.utils.profiling import Heartbeat

    a = Heartbeat(tmp_path, "host-a", interval=0.05, timeout=0.2)
    b = Heartbeat(tmp_path, "host-b", interval=0.05, timeout=0.2)
    a.beat()
    b.beat()
    assert "host-b" in a.peers()
    assert a.dead_peers() == []
    time.sleep(0.3)  # b stops beating
    a.beat()
    assert a.dead_peers() == ["host-b"]
    a.stop()
    b.stop()
    assert not list(tmp_path.glob("*.heartbeat"))


@pytest.mark.parametrize("kind", ["python", "native"])
def test_profiled_allocator_passthrough(monkeypatch, kind):
    from pie_tpu_torch.runtime import NativePageAllocator, PageAllocator
    from pie_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "ENABLED", True)
    profiling.reset_zones()
    cls = PageAllocator if kind == "python" else NativePageAllocator
    a = profiling.ProfiledAllocator(cls(4))
    (pid,) = a.allocate_n(1)
    assert pid >= 0
    assert a.num_free() == 3
    a.free(pid)
    assert a.num_free() == 4
    rep = profiling.zone_report()
    assert rep["PageAllocator.allocate_n"]["count"] == 1
    assert rep["PageAllocator.free"]["count"] == 1


def test_device_trace_records_ops(tmp_path):
    import torch

    from pie_tpu_torch.utils.profiling import device_trace

    with device_trace(str(tmp_path)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    names = {e.key for e in prof.key_averages()}
    assert any("mm" in n for n in names)
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


def test_client_models_serialise_as_jax():
    """GenerationKwargs / GenerationRequest dump to the same JSON as the
    JAX package's, and to_interactions gives the same roles and texts."""
    from pie_tpu.engine import client as jc
    from pie_tpu_torch.engine import client as tc

    body = dict(prompt="hi", system="be brief",
                messages=[{"role": "user", "content": "hello"},
                          {"role": "assistant", "text": "hey"}],
                response_format={"type": "json_object"}, stop=["\n"],
                kwargs=dict(temperature=0.2, top_k=5, logit_bias={3: 1.5},
                            max_completion_tokens=7, custom="x"))
    j, t = jc.GenerationRequest(**body), tc.GenerationRequest(**body)
    assert t.model_dump_json() == j.model_dump_json()
    assert tc.GenerationKwargs().model_dump() == jc.GenerationKwargs().model_dump()
    ji, ti = j.to_interactions(), t.to_interactions()
    assert [(i.role.value, i.text) for i in ti] == [(i.role.value, i.text) for i in ji]
    with pytest.raises(ValueError):
        tc.GenerationRequest().to_interactions()


def test_client_generate_calls_chat():
    """InferenceEngineClient maps a request onto engine.chat as JAX's does."""
    from pie_tpu_torch.engine.client import GenerationRequest, InferenceEngineClient

    calls = []

    class Engine:
        def chat(self, interactions, **kw):
            calls.append((interactions, kw))
            return "answer"

    req = GenerationRequest(prompt="hi", kwargs=dict(temperature=0.5, seed=3,
                                                     max_completion_tokens=9))
    assert InferenceEngineClient(Engine()).generate(req) == "answer"
    (inters, kw), = calls
    assert [i.text for i in inters] == ["hi"]
    assert kw["max_completion_tokens"] == 9 and kw["temperature"] == 0.5
    assert "seed" not in kw and kw["tools"] is None
