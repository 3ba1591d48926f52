"""What a run and the reference load: no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``pie_tpu`` (compared whole: the port's
``pie_tpu_torch`` begins with the JAX package's name), and the reference
nothing of the port. No file of the benchmark reads ``benchmarks/`` or
``bench.py``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pie_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_root):
    code = (f"from pathlib import Path\nfrom portbench import harness\n"
            f"r = harness.run_cell(Path({str(tiny_root)!r}), 'tiny-mistral.decode', 5, 2.0,"
            f" False, device='cpu')\nassert r['_forbidden'] == []")
    top = _loaded(code)
    assert "pie_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    code = ("import torch\nfrom portbench import weights\n"
            "from portbench.reference.decoder import Decoder, widest_gap\n"
            "cfg = {'model_type': 'mistral', 'hidden_size': 128, 'intermediate_size': 256,"
            " 'num_hidden_layers': 1, 'num_attention_heads': 4, 'num_key_value_heads': 2,"
            " 'vocab_size': 64, 'rms_norm_eps': 1e-5, 'rope_theta': 1e6}\n"
            "d = Decoder(cfg, lambda i: weights.layer_weights(cfg, 1, i, 'cpu'),"
            " lambda: weights.top_weights(cfg, 1, 'cpu'))\n"
            "d.logits([torch.arange(9)], [torch.arange(9)])")
    top = _loaded(code)
    assert not top & (FORBIDDEN | {"pie_tpu_torch"})


def test_the_tower_reference_loads_nothing_of_the_port():
    code = ("import torch\nfrom portbench.reference.vision import Tower\n"
            "v = {'depth': 2, 'hidden_size': 32, 'intermediate_size': 48, 'num_heads': 2,"
            " 'spatial_merge_size': 2, 'window_size': 112, 'patch_size': 14,"
            " 'fullatt_block_indexes': [1]}\n"
            "w = lambda *s: torch.randn(s, dtype=torch.bfloat16)\n"
            "blk = lambda i: {'norm1.weight': w(32), 'norm2.weight': w(32),"
            " 'attn.qkv.weight': w(96, 32), 'attn.qkv.bias': w(96),"
            " 'attn.proj.weight': w(32, 32), 'attn.proj.bias': w(32),"
            " 'mlp.gate_proj.weight': w(48, 32), 'mlp.gate_proj.bias': w(48),"
            " 'mlp.up_proj.weight': w(48, 32), 'mlp.up_proj.bias': w(48),"
            " 'mlp.down_proj.weight': w(32, 48), 'mlp.down_proj.bias': w(32)}\n"
            "top = lambda: {'patch_embed.proj.weight': w(32, 3, 2, 14, 14),"
            " 'merger.ln_q.weight': w(32), 'merger.mlp.0.weight': w(128, 128),"
            " 'merger.mlp.0.bias': w(128), 'merger.mlp.2.weight': w(16, 128),"
            " 'merger.mlp.2.bias': w(16)}\n"
            "f = Tower(v, blk, top).features([(torch.randn(80, 1176), (1, 8, 10))])\n"
            "assert f[0].shape == (20, 16)")
    top = _loaded(code)
    assert not top & (FORBIDDEN | {"pie_tpu_torch"})


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_reads_the_jax_benchmark():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
        text = path.read_text()
        if path.parent.name != "tests":
            assert "benchmarks/" not in text and "bench.py" not in text, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "pie_tpu_torch" not in _imports(path), path
