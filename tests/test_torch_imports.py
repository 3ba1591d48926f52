"""The port stands alone: no module of pie_tpu_torch imports JAX or the
JAX package, and its entry points do not move to the CPU on their own."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes at once: two intra-op threads
    each keep them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import pie_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            pie_tpu_torch.__path__, "pie_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "pie_tpu"))
        print(len(names), bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) > 30  # every module was imported


@pytest.mark.parametrize("module", [
    "pie_tpu_torch.runtime.allocator",
    "pie_tpu_torch.cache.paged",
    "pie_tpu_torch.ops.paged_attention",
    "pie_tpu_torch.engine.scheduler",
    "pie_tpu_torch.engine.async_engine",
    "pie_tpu_torch.ops.fused_mlp",
    "pie_tpu_torch.models.loader",
    "pie_tpu_torch.models.gguf",
    "pie_tpu_torch.server.app",
    "pie_tpu_torch.models.gemma3",
    "pie_tpu_torch.models.qwen2_vl",
    "pie_tpu_torch.vision.utils",
    "pie_tpu_torch.runtime.native",
    "pie_tpu_torch.runtime.native_scheduler",
    "pie_tpu_torch.runtime.ipc",
    "pie_tpu_torch.runtime.engine_main",
    "pie_tpu_torch.engine.client",
    "pie_tpu_torch.utils.profiling",
    "pie_tpu_torch.parallel.mesh",
    "pie_tpu_torch.parallel.tp",
    "pie_tpu_torch.parallel.distributed",
    "pie_tpu_torch.parallel.router",
    "pie_tpu_torch.server.frontier",
    "pie_tpu_torch.tools.ppl",
    "pie_tpu_torch.tools.hbm_peak",
])
def test_batching_modules_import_no_jax(module):
    """Each module of the continuous-batching path, and of the checkpoint
    and fused-MLP path, imported alone in a fresh process, brings in
    neither JAX nor the JAX package."""
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "pie_tpu"))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_no_jax_and_fails_without_a_card():
    """chip_smoke.py imports neither JAX nor the JAX package, and where no
    CUDA card is present it exits non-zero without a result line."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "pie_tpu"}, mods
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_cuda():
    """Without a device argument the engine, its core, the app, the
    checkpoint loaders and the random initializers ask for CUDA, and where
    there is none they raise;
    the helpers that allocate state take no default device at all."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from pie_tpu_torch.cache.kv_cache import make_kv_cache
    from pie_tpu_torch.cache.paged import PagedKVPool
    from pie_tpu_torch.engine import InferenceEngine
    from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
    from pie_tpu_torch.engine.core import EngineCore, PenaltyParams
    from pie_tpu_torch.engine.scheduler import PagedEngine
    from pie_tpu_torch.models.llama import LlamaConfig, LlamaModel, from_jax_params
    from pie_tpu_torch.ops.sampling import SamplingParams
    from pie_tpu_torch.server.app import create_app

    model = LlamaModel(LlamaConfig(hidden_size=64, num_hidden_layers=1,
                                   intermediate_size=128, num_attention_heads=4,
                                   num_key_value_heads=2, vocab_size=64))
    params = model.init_params(seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model=model, params=params)
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineCore(model, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedEngine(model, params, num_pages=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedInferenceEngine(model=model, params=params, num_pages=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_quantized_params(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({"norm": params["norm"].numpy()}, "cuda")
    for make in (lambda: make_kv_cache(1, 1, 8, 2, 16),
                 lambda: PagedKVPool.create(1, 4, 2, 16),
                 lambda: SamplingParams.make(1),
                 lambda: PenaltyParams.make(1),
                 lambda: from_jax_params({})):
        with pytest.raises(TypeError, match="device"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_app(engine=InferenceEngine(model=model, params=params,
                                          device="cpu"))
    from pie_tpu_torch.models.gguf import load_gguf_model
    from pie_tpu_torch.models.loader import load_model, load_params

    for load in (load_model, load_params, load_gguf_model):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(ROOT / "no-such-checkpoint")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model_path=str(ROOT / "no-such-checkpoint"))
    from pie_tpu_torch.runtime import engine_main

    with pytest.raises(RuntimeError, match="CUDA"):
        engine_main.main(["--model-path", str(ROOT / "no-such-checkpoint"),
                          "--log-level", "WARNING"])
    from pie_tpu_torch.parallel import distributed, make_mesh
    from pie_tpu_torch.tools import ppl

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(tp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppl.main(["--model-path", str(ROOT / "no-such-checkpoint"),
                  "--data", str(ROOT / "no-such-text")])


def test_frontier_entry_point_runs_alone():
    """``python -m pie_tpu_torch.server.frontier`` (the front tier, which
    drives no device) imports no JAX and refuses to start without hosts."""
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["frontier"]
        try:
            runpy.run_module("pie_tpu_torch.server.frontier", run_name="__main__")
        except SystemExit as e:
            print("exit:", e.code)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "pie_tpu"))
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PIE_HOSTS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "exit: PIE_HOSTS / --hosts required" in out.stdout
