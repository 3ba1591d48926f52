"""Cross-process serving over the port's shm IPC transport
(pie_tpu_torch.runtime.ipc) on the CPU. Mirrors tests/test_ipc_python.py: a
channel round trip through the raw ABI in one process; an engine service in
this process streaming to a frontend in a child process that imports
neither torch nor JAX; a cancellation over the ring. Then the standalone
engine process, ``python -m pie_tpu_torch.runtime.engine_main --device
cpu`` on a snapshot: its greedy streams equal an in-process native
scheduler's on the same snapshot, a cancelled request ends "cancelled",
and SIGTERM ends it with exit code 0 and its shm segment unlinked. Channel
names carry the process id and a random suffix, so test processes never
share a segment."""

import ctypes
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from pie_tpu_torch.engine.scheduler import PagedEngine
from pie_tpu_torch.runtime.ipc import IpcChannel, IpcEngineService, IpcFrontend
from pie_tpu_torch.runtime.native_scheduler import NativeScheduler

from test_torch_native_scheduler import TINY, tiny_models

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def channel_name(tag: str) -> str:
    return f"/pie_t_{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def _service(model, params, name):
    eng = PagedEngine(model, params, num_lanes=4, num_pages=32, max_pages_per_seq=8,
                      prefill_chunk=16, kv_dtype=torch.float32, device="cpu")
    return IpcEngineService(NativeScheduler(eng), name, request_slots=32,
                            prompt_capacity=128, response_slots=512)


def _serve(service):
    stop = threading.Event()
    t = threading.Thread(target=service.serve_forever,
                         kwargs=dict(should_stop=stop.is_set), daemon=True)
    t.start()
    return stop, t


def test_ipc_channel_same_process_roundtrip():
    name = channel_name("rt")
    ch = IpcChannel.create(name, 8, 32, 32)
    fe = IpcChannel.attach(name)
    assert fe.submit(42, [1, 2, 3], max_new_tokens=7, temperature=0.5)
    # the engine side, through the raw ABI
    lib = ch._lib
    rid = ctypes.c_uint64()
    prompt = np.zeros(32, np.int32)
    plen = ctypes.c_uint32()
    mnt = ctypes.c_uint32()
    stops = np.zeros(8, np.int32)
    nstop = ctypes.c_uint32()
    f = [ctypes.c_float() for _ in range(6)]
    tk = ctypes.c_int32()
    seed = ctypes.c_uint64()
    cancel = ctypes.c_uint8()
    ok = lib.pie_ipc_next_request(
        ch._h, ctypes.byref(rid), prompt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(plen), ctypes.byref(mnt),
        stops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.byref(nstop),
        ctypes.byref(f[0]), ctypes.byref(f[1]), ctypes.byref(f[2]), ctypes.byref(tk),
        ctypes.byref(f[3]), ctypes.byref(f[4]), ctypes.byref(f[5]), ctypes.byref(seed),
        ctypes.byref(cancel))
    assert ok == 1
    assert rid.value == 42
    assert plen.value == 3 and prompt[:3].tolist() == [1, 2, 3]
    assert mnt.value == 7
    assert abs(f[0].value - 0.5) < 1e-6
    assert lib.pie_ipc_push_response(ch._h, 42, 99, 0, 0) == 0
    assert fe.poll_response() == (42, 99, False, None)
    fe.close()
    ch.close()
    assert not Path("/dev/shm", name.lstrip("/")).exists()  # the creator unlinked it


def test_ipc_engine_service_end_to_end(models):
    """The engine in this process, the frontend in a child process that
    imports neither torch nor JAX."""
    _, _, tm, tp = models
    name = channel_name("e2e")
    service = _service(tm, tp, name)
    req = service.scheduler.add_request([5, 17, 42, 7], max_new_tokens=8,
                                        temperature=0.0)
    service.scheduler.run_to_completion(max_steps=100)
    expected = req.output_ids
    assert len(expected) == 8
    child = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from pie_tpu_torch.runtime.ipc import IpcFrontend
fe = IpcFrontend({name!r})
rid = fe.submit([5, 17, 42, 7], max_new_tokens=8, temperature=0.0)
toks, reason = fe.collect(rid, timeout_s=120)
assert reason == "length", reason
assert "torch" not in sys.modules and "jax" not in sys.modules
print("TOKENS", ",".join(map(str, toks)))
"""
    stop, t = _serve(service)
    try:
        out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                             text=True, timeout=180)
        assert out.returncode == 0, out.stderr[-2000:]
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("TOKENS")][0]
        assert [int(x) for x in line.split(" ", 1)[1].split(",")] == expected
    finally:
        stop.set()
        t.join(timeout=60)
        if not t.is_alive():  # the loop is out of the service before it closes
            service.shutdown()
    assert not t.is_alive()


def test_ipc_cancellation_over_ring(models):
    _, _, tm, tp = models
    name = channel_name("cancel")
    service = _service(tm, tp, name)
    fe = IpcFrontend(name)
    rid = fe.submit([5, 6, 7], max_new_tokens=300, temperature=0.0)
    stop, t = _serve(service)
    try:
        got = []
        for tok in fe.stream(rid, timeout_s=120):
            got.append(tok)
            if len(got) == 3:
                fe.cancel(rid)
        assert fe.last_finish_reason == "cancelled"
        assert 3 <= len(got) < 300
    finally:
        stop.set()
        t.join(timeout=60)
        fe.close()
        if not t.is_alive():
            service.shutdown()
    assert not t.is_alive()
    assert service.scheduler.core.num_free_pages == 32


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny f32 Llama snapshot: HF's init (seed 0), embedding and head at
    unit scale so greedy choices are decisive."""
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**TINY,
                                                                attention_bias=False))
    with torch.no_grad():
        hf.model.embed_tokens.weight.mul_(50.0)
        hf.lm_head.weight.mul_(50.0)
    path = tmp_path_factory.mktemp("engine_snap")
    hf.save_pretrained(path)
    return path


def test_engine_main_subprocess(snapshot):
    """``engine_main --device cpu`` serves three greedy requests, then a
    fourth the frontend in this process cancels after its second token;
    the three streams equal an in-process native scheduler's on the same
    snapshot, and SIGTERM ends the process with code 0, its segment
    unlinked."""
    from pie_tpu_torch.models.loader import load_model

    prompts = [[5, 17, 42, 7], list(range(10, 40)), [9, 3, 3, 7, 1]]
    model, params = load_model(snapshot, device="cpu")
    sched = NativeScheduler(PagedEngine(model, params, num_lanes=4, num_pages=64,
                                        max_pages_per_seq=8, device="cpu"))
    reqs = [sched.add_request(p, max_new_tokens=12, temperature=0.0) for p in prompts]
    sched.run_to_completion(max_steps=200)
    want = [r.output_ids for r in reqs]

    name = channel_name("main")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pie_tpu_torch.runtime.engine_main", "--model-path",
         str(snapshot), "--channel", name, "--device", "cpu", "--num-lanes", "4",
         "--num-pages", "64", "--max-pages-per-seq", "8", "--log-level", "WARNING"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fe = None
    try:
        deadline = time.monotonic() + 120
        while fe is None:
            try:
                fe = IpcFrontend(name)
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"engine did not come up: {proc.stdout.read()}")
                time.sleep(0.1)
        rids = [fe.submit(p, max_new_tokens=12, temperature=0.0) for p in prompts]
        cancelled = fe.submit([5, 6, 7], max_new_tokens=300, temperature=0.0)
        got = [fe.collect(rid, timeout_s=120) for rid in rids]
        assert [g[0] for g in got] == want
        assert [g[1] for g in got] == ["length"] * 3
        toks = []
        for tok in fe.stream(cancelled, timeout_s=120):
            toks.append(tok)
            if len(toks) == 2:
                fe.cancel(cancelled)
        assert fe.last_finish_reason == "cancelled" and len(toks) < 300
    finally:
        if fe is not None:
            fe.close()
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert proc.returncode == 0, out[-2000:]
    assert not Path("/dev/shm", name.lstrip("/")).exists()
