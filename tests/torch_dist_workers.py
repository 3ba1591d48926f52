"""Rank programs of the port's multi-process CPU tests (gloo), and the
launcher that runs them: one spawned process per rank, each joined with
its own deadline, so a hang fails the test in seconds. No JAX here: the
tests compute the JAX references in their own process and compare.

``launch(name, world, payload)`` runs ``name(rank, world, payload)`` on
every rank after ``parallel.distributed.initialize`` (from the PIE_*
variables, on the CPU) and returns the ranks' results in rank order."""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(rank, world, port, name, payload_path, out_dir):
    torch.set_num_threads(1)
    out = Path(out_dir) / f"{rank}.pkl"
    try:
        import torch.distributed as dist

        from pie_tpu_torch.parallel import distributed

        os.environ.update(PIE_COORDINATOR=f"127.0.0.1:{port}",
                          PIE_NUM_PROCESSES=str(world), PIE_PROCESS_ID=str(rank))
        assert distributed.initialize(device="cpu")
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        result = {"ok": globals()[name](rank, world, payload)}
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        result = {"error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(result, f)


def launch(name: str, world: int, payload, timeout: float = 60.0) -> list:
    """Run rank program ``name`` in ``world`` spawned processes; their
    results in rank order. A rank that raises, or any rank still alive at
    the deadline (all are then killed), fails with what it said."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        payload_path = Path(tmp) / "payload.pkl"
        with open(payload_path, "wb") as f:
            pickle.dump(payload, f)
        port = _free_port()
        procs = [ctx.Process(target=_entry,
                             args=(r, world, port, name, str(payload_path), tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results = []
        for r in range(world):
            path = Path(tmp) / f"{r}.pkl"
            if not path.exists():
                raise AssertionError(
                    f"rank {r} of {name} left no result "
                    f"({'hung past the deadline' if r in hung else 'exit ' + str(procs[r].exitcode)})")
            with open(path, "rb") as f:
                res = pickle.load(f)
            if "error" in res:
                raise AssertionError(f"rank {r} of {name} raised:\n{res['error']}")
            results.append(res["ok"])
        if hung:
            raise AssertionError(f"ranks {hung} of {name} hung past the deadline")
        return results


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------


def _counts_delta(before: dict) -> dict:
    from pie_tpu_torch.parallel.tp import collective_counts

    return {k: collective_counts[k] - before[k] for k in before}


def _mesh(payload):
    """The payload's ("dp", "tp") mesh; None for a payload without one
    (the unsharded run, in the calling process)."""
    from pie_tpu_torch.parallel import make_mesh

    if "tp" not in payload:
        return None
    return make_mesh(tp=payload["tp"], dp=payload["dp"], device="cpu")


def _build(payload):
    """(model, params) of the unsharded port model on the CPU: a Llama from
    JAX params (numpy tree), or a Gemma-3 / Qwen2-VL from an HF state dict;
    with ``kv_rep`` its KV heads replicated."""
    from pie_tpu_torch.models.llama import from_jax_params
    from pie_tpu_torch.parallel import replicate_kv_heads

    fam = payload.get("family", "llama")
    if fam == "llama":
        from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel

        model = LlamaModel(LlamaConfig.from_dict(payload["cfg"]))
        params = from_jax_params(payload["params"], "cpu")
    elif fam == "gemma":
        from pie_tpu_torch.models.gemma3 import Gemma3Config, Gemma3Model

        model = Gemma3Model(Gemma3Config.from_dict(payload["cfg"]))
        params = model.from_hf_state_dict(payload["sd"], dtype=torch.float32)
    else:
        from pie_tpu_torch.models.qwen2_vl import Qwen2VLConfig, Qwen2VLModel

        model = Qwen2VLModel(Qwen2VLConfig.from_dict(payload["cfg"]))
        params = model.from_hf_state_dict(payload["sd"], dtype=torch.float32)
    if payload.get("kv_rep", 1) > 1:
        params, cfg = replicate_kv_heads(params, model.config, payload["kv_rep"])
        model = type(model)(cfg)
    return model, params


def core_decode(rank, world, payload):
    """Prefill + decode steps through ``EngineCore`` on this rank's shard
    (greedy, or categorical at the payload's ``temperature``); the tokens
    [B, 1 + steps] and the collectives of one decode step."""
    from pie_tpu_torch.engine.core import EngineCore, PenaltyParams
    from pie_tpu_torch.ops.sampling import SamplingParams
    from pie_tpu_torch.parallel import shard_model, shard_params
    from pie_tpu_torch.parallel.tp import collective_counts

    model, params = _build(payload)
    mesh = _mesh(payload)
    local, sharded = model, params
    if mesh is not None:
        local = shard_model(model, mesh)
        sharded = shard_params(params, mesh, model.config)
    b, steps, t = payload["batch"], payload["steps"], 8
    temperature = payload.get("temperature", 0.0)
    kind = "categorical" if temperature > 0 else "greedy"
    core = EngineCore(local, sharded, batch_size=b, max_seq_len=64,
                      kv_dtype=torch.float32, device="cpu")
    state = core.new_state(seed=0)
    ids = np.broadcast_to(np.arange(1, t + 1, dtype=np.int32)[None], (b, t))
    sampling = SamplingParams.make(b, temperature=temperature, device="cpu")
    penalties = PenaltyParams.make(b, device="cpu")
    bias_ids = torch.full((b, 0), -1, dtype=torch.int32)
    bias_vals = torch.zeros((b, 0), dtype=torch.float32)
    state, tok, _ = core._prefill(
        sharded, state, ids, np.full((b,), t, np.int32), np.zeros((b,), np.int32),
        sampling, penalties, bias_ids, bias_vals, sampler_kind=kind)
    before = dict(collective_counts)
    state, outs = core._decode(
        sharded, state, sampling, penalties, bias_ids, bias_vals,
        torch.tensor([-1], dtype=torch.int32), num_steps=steps, sampler_kind=kind)
    per_step = {k: v / steps for k, v in _counts_delta(before).items()}
    tokens = np.concatenate([tok.numpy()[:, None], outs[0].numpy().T], axis=1)
    return {"tokens": tokens, "per_step": per_step,
            "cache_heads": int(state.cache.k.shape[3]),
            "cache_rows": int(state.cache.k.shape[1])}


def paged(rank, world, payload):
    """The paged scheduler's outputs (greedy, or sampled at the payload's
    ``temperature``) over this rank's shard and pool
    (``PagedEngine(mesh=)``), and the pool's KV heads."""
    from pie_tpu_torch.engine.scheduler import PagedEngine, Scheduler
    from pie_tpu_torch.parallel import shard_params

    model, params = _build(payload)
    if payload.get("quantize"):
        g, bits = payload["quantize"]
        params = model.quantize_params(params, group_size=g, bits=bits)
    mesh = _mesh(payload)
    sharded = params if mesh is None else shard_params(params, mesh, model.config)
    engine = PagedEngine(model, sharded, num_lanes=4, num_pages=32, max_pages_per_seq=4,
                         rider_width=8, kv_dtype=torch.float32, mesh=mesh, device="cpu")
    sched = Scheduler(engine, decode_steps=4)
    seqs = [sched.add_request(p, max_new_tokens=5,
                              temperature=payload.get("temperature", 0.0))
            for p in payload["prompts"]]
    sched.run_to_completion(max_steps=64)
    return {"outputs": [s.output_ids for s in seqs],
            "pool_heads": int(engine.pool.k.shape[2]),
            "graph_keys": sorted(str(k[0]) for k in engine.graphs.keys)}


def collectives(rank, world, payload):
    """All-reduce and all-gather over the mesh's groups, and the graph
    guard: a step captured over a gloo group raises."""
    from pie_tpu_torch.parallel import mesh_ops
    from pie_tpu_torch.parallel.tp import MeshOps

    mesh = _mesh(payload)
    ops = mesh_ops(mesh)
    assert isinstance(ops, MeshOps) and not ops.capturable
    x = torch.full((2, 3), float(rank + 1))
    summed = ops.tp_sum(x.clone())
    gathered = ops.gather_vocab(torch.arange(3, dtype=torch.float32) + 10 * ops.tp_rank)
    rows = ops.gather_rows(torch.tensor([rank], dtype=torch.int32))
    table = torch.arange(4 * ops.tp * 2, dtype=torch.float32).reshape(4 * ops.tp, 2)
    local = table[ops.tp_rank * 4:(ops.tp_rank + 1) * 4]
    ids = torch.tensor([[0, 5, 4 * ops.tp - 1]])
    emb = ops.embed(local, ids)
    from pie_tpu_torch.engine.graphs import StepGraphs

    try:
        StepGraphs(torch.device("cpu"), None, ops)._warm_up_and_capture(
            ("decode",), lambda: (), False)
        guard = None
    except RuntimeError as e:
        guard = str(e)
    return {"tp_rank": ops.tp_rank, "dp_rank": ops.dp_rank, "summed": summed.numpy(),
            "capture_refused": guard,
            "gathered": gathered.numpy(), "rows": rows.numpy(),
            "embed": emb.numpy(), "embed_want": table[ids].numpy(),
            "backend": ops.backend}


def many(rank, world, payload):
    """Several rank programs in one launch: payload [(name, payload), ...]."""
    return [globals()[name](rank, world, sub) for name, sub in payload]


def two_hosts(rank, world, payload):
    """tests/test_distributed_2proc.py's program on the port: a mesh over
    the two processes, a cross-process all-reduce, then heartbeats: host 1
    beats briefly and goes silent (no cleanup: a lost host), host 0
    notices and its router re-queues host 1's request onto itself."""
    import torch.distributed as dist

    from pie_tpu_torch.parallel import make_mesh, mesh_ops
    from pie_tpu_torch.parallel.distributed import Heartbeat
    from pie_tpu_torch.parallel.router import RequestRouter

    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    try:
        make_mesh(tp=4, dp=1, device="cpu")
    except ValueError as e:
        out["too_small"] = str(e)
    mesh = make_mesh(tp=2, dp=1, device="cpu")
    x = torch.arange(4, dtype=torch.float32) + 10 * rank
    out["sum"] = mesh_ops(mesh).tp_sum(x).tolist()
    hbdir = payload["dir"]
    if rank == 1:
        Heartbeat(hbdir, "host1", interval=0.1, timeout=0.6).beat()
        dist.barrier()
        return out
    dist.barrier()  # host 1 has beaten once
    router = None

    def dispatch(host, req):
        if host == "host0":
            router.complete(req, f"served:{req.payload}")
        # host1 never answers: its request waits for the re-queue

    router = RequestRouter(dispatch)
    dead = []
    hb = Heartbeat(hbdir, "host0", interval=0.1, timeout=0.6,
                   on_peer_death=lambda h: (dead.append(h), router.mark_host_dead(h)))
    router.add_host("host0")
    router.add_host("host1")
    router._hosts["host0"] = 5  # load host0 so the request lands on host1
    req = router.submit("req-on-host1")
    out["first_host"] = req.host
    router._hosts["host0"] = 0
    hb.start()
    deadline = time.time() + 15
    while not dead and time.time() < deadline:
        time.sleep(0.05)
    hb.stop()
    out.update(dead=dead, done=req.wait(5), result=req.result, host=req.host,
               attempts=req.attempts, live=router.live_hosts())
    return out


def image_embeds(rank, world, payload):
    """Gemma-3's prompt embeddings with an image (the SigLIP tower and its
    projector, replicated) through this rank's shard (the test holds them
    against JAX's unsharded model)."""
    from pie_tpu_torch.parallel import shard_model, shard_params

    model, params = _build(payload)
    mesh = _mesh(payload)
    local = shard_model(model, mesh)
    sharded = shard_params(params, mesh, model.config)
    ids = torch.tensor([payload["ids"]])
    pixels = torch.from_numpy(payload["pixels"])
    got = local.embed_with_images(sharded, ids, pixels)
    return {"embeds": got.numpy(), "vision_shared": sharded["vision"] is params["vision"]}
