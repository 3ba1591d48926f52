"""Small port modules on the CPU: a timing span of the host tracer
(pie_tpu_torch.utils.profiling; the JAX package's zones in
tests/test_aux.py), the heartbeat, and the sync client's request models
(pie_tpu_torch.engine.client) serialising as the JAX package's do."""

import time

import pytest


def test_profiling_zones():
    from pie_tpu_torch.utils import profiling

    profiling.enable()
    try:
        with profiling.span("work"):
            time.sleep(0.01)
        (work,) = profiling.collect()["spans"]
    finally:
        profiling.disable()
    assert work.name == "work"
    assert work.end_ns - work.start_ns >= 5_000_000
    with profiling.span("off"):
        pass
    profiling.enable()
    try:
        assert profiling.collect()["spans"] == []
    finally:
        profiling.disable()


def test_heartbeat_liveness(tmp_path):
    from pie_tpu_torch.parallel.distributed import Heartbeat

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
