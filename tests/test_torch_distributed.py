"""The port's multi-host pieces (pie_tpu_torch/parallel/distributed.py,
mesh.py, router.py) on the CPU. Mirrors tests/test_distributed_2proc.py
(two real processes join a gloo group from the PIE_* variables, build a
mesh over both, all-reduce across them; one host goes silent and the other
detects it through heartbeats and re-queues its request through the
router), which the JAX package marks slow and the port runs in tier-1;
plus the router's placement and failover rules, ``drain`` on the paged
scheduler, and the entry points' refusal to run without a card unless
asked."""

import os
import time

import pytest
import torch

from pie_tpu_torch.parallel import distributed, make_mesh
from pie_tpu_torch.parallel.router import DispatchError, RequestRouter

from torch_dist_workers import launch


def test_two_process_bringup(tmp_path):
    res = launch("two_hosts", 2, {"dir": str(tmp_path / "hb")}, timeout=60)
    for r, out in enumerate(res):
        assert (out["world"], out["rank"]) == (2, r)
        assert "need 4 processes, have 2" in out["too_small"]
        # [0, 1, 2, 3] + [10, 11, 12, 13]
        assert out["sum"] == [10.0, 12.0, 14.0, 16.0]
    host0 = res[0]
    assert host0["first_host"] == "host1"
    assert host0["dead"] == ["host1"]
    assert host0["done"] and host0["result"] == "served:req-on-host1"
    assert (host0["host"], host0["attempts"]) == ("host0", 2)
    assert host0["live"] == ["host0"]


def test_initialize_without_coordinator_does_nothing(monkeypatch):
    monkeypatch.delenv("PIE_COORDINATOR", raising=False)
    assert distributed.initialize(device="cpu") is False


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_entry_points_default_to_the_card():
    """make_mesh and initialize default to cuda and raise without a card
    (initialize before it joins any group)."""
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(tp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize("127.0.0.1:1", 1, 0)


def test_router_places_least_loaded_and_fails_over():
    delivered = []
    router = None

    def dispatch(host, req):
        delivered.append(host)
        if host == "bad":
            raise DispatchError("connection refused")
        router.complete(req, host)

    router = RequestRouter(dispatch)
    for h in ("bad", "good"):
        router.add_host(h)
    router._hosts["good"] = 3  # "bad" is least loaded
    req = router.submit("x")
    assert req.wait(1) and req.result == "good" and req.attempts == 2
    assert delivered == ["bad", "good"]
    assert router.live_hosts() == ["good"] and router.inflight == 0


def test_router_transport_bug_fails_only_the_request():
    def dispatch(host, req):
        raise KeyError("bug")

    router = RequestRouter(dispatch)
    router.add_host("a")
    req = router.submit("x")
    assert req.done and "KeyError" in req.error
    assert router.live_hosts() == ["a"]  # the host is not blamed


def test_router_gives_up_after_max_attempts_and_without_hosts():
    router = RequestRouter(lambda host, req: None, max_attempts=2)
    router.add_host("a")
    router.add_host("b")
    req = router.submit("x")
    router.mark_host_dead(req.host)
    router.mark_host_dead(req.host)
    assert req.done and req.error == "error: no live hosts"
    router.add_host("c")
    seen = []
    req2 = router.submit("y")
    req2.add_done_callback(lambda r: seen.append(r.error))
    router.mark_host_dead("c")
    assert req2.error == "error: no live hosts" and seen == [req2.error]


def test_drain_finishes_running_and_requeues_waiting():
    """drain() stops admitting, runs the lanes in flight to the end and
    hands back the queue (WAITING) for another host."""
    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler, SeqStatus
    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel

    cfg = LlamaConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, vocab_size=128)
    model = LlamaModel(cfg)
    params = model.init_params(seed=0, dtype=torch.float32, device="cpu")
    engine = PagedEngine(model, params, num_lanes=2, num_pages=16, max_pages_per_seq=4,
                         rider_width=8, kv_dtype=torch.float32, device="cpu")
    sched = Scheduler(engine, decode_steps=4)
    seqs = [sched.add_request([1, 2, 3, 4 + i], max_new_tokens=6, temperature=0.0)
            for i in range(3)]
    sched.step()
    assert len(sched.running) == 2 and len(sched.waiting) == 1
    assert distributed.drain(sched, timeout=60)
    assert all(s.status == SeqStatus.COMPLETED for s in seqs[:2])
    assert seqs[2].status == SeqStatus.WAITING and not sched.waiting
    assert not sched.has_work
