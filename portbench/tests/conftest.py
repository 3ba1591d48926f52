"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's tree
with tiny configurations and traffic beside the real ones, so that a whole
run fits a CPU in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the widths each tiny configuration takes (head size 32: M-RoPE sections
#: (4, 6, 6) for the Qwen one); every other key is the real file's
TINY = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=2, vocab_size=640)
TINY_ASSUMED = dict(lanes=4, max_pages_per_seq=8, pool_pages=64, prefill_chunk=64,
                    ordinary_token_ids=[0, 600])
TINY_TRAFFIC = {
    "tiny-open": {"loop": "open", "rate_per_s": 6.0,
                  "prompt_tokens": {"dist": "lognormal", "median": 60, "sigma": 0.6,
                                    "min": 20, "max": 150},
                  "output_tokens": {"dist": "uniform", "min": 4, "max": 12}},
    "tiny-closed": {"loop": "closed", "clients": 3,
                    "prompt_tokens": {"dist": "uniform", "min": 40, "max": 90},
                    "output_tokens": {"dist": "uniform", "min": 6, "max": 16}},
}
TINY_CELLS = {"tiny-qwen.chat": ("tiny-qwen", "tiny-open"),
              "tiny-mistral.decode": ("tiny-mistral", "tiny-closed")}


def tiny_config(real: str) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{real}.json").read_text())
    cfg.update(TINY)
    cfg.pop("head_dim", None)
    if "rope_scaling" in cfg:
        cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [4, 6, 6]}
    cfg["assumed"] = dict(cfg["assumed"], **TINY_ASSUMED)
    return cfg


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path: Path) -> Path:
    """A checkout-like directory: the benchmark's files, plus tiny cells."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, real in (("tiny-qwen", "qwen2.5-vl-7b"), ("tiny-mistral", "mistral-7b-v0.3")):
        path = f"portbench/configs/{name}.json"
        (tmp_path / path).write_text(json.dumps(tiny_config(real)))
        bench["configs"].append({"name": name, "source": "tiny", "file": path,
                                 "reduced": [], "why": "CPU test"})
    for name, t in TINY_TRAFFIC.items():
        (tmp_path / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, (conf, traffic) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": conf, "traffic": traffic,
                                   "chips": 1, "why": "CPU test"})
        (tmp_path / "portbench" / "checks" / f"{cell}.json").write_text(json.dumps(
            {"widest_gap_limit": 0.2, "min_tokens_compared": 20, "sample_tokens": 40}))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [c for c in TINY_CELLS]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
