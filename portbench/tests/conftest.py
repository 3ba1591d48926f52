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
#: the tiny tower: 4 blocks (full attention at 1 and 3), hidden 64 in 4
#: heads, the published patch, merge and 112-px window
TINY_VISION = dict(depth=4, hidden_size=64, intermediate_size=96, num_heads=4,
                   out_hidden_size=TINY["hidden_size"], fullatt_block_indexes=[1, 3])
#: the special ids inside the tiny vocabulary, above its ordinary ids
TINY_VISION_IDS = dict(vision_start_token_id=630, vision_end_token_id=631,
                       vision_token_id=632, image_token_id=633, video_token_id=634)
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
    "tiny-image": {"loop": "open", "rate_per_s": 6.0,
                   "prompt_tokens": {"dist": "lognormal", "median": 60, "sigma": 0.6,
                                     "min": 20, "max": 150},
                   "output_tokens": {"dist": "uniform", "min": 4, "max": 12},
                   "inputs": {"images": {"share": 0.5,
                                         "side_px": {"min": 112, "max": 224}}}},
}
TINY_CELLS = {"tiny-qwen.chat": ("tiny-qwen", "tiny-open"),
              "tiny-mistral.decode": ("tiny-mistral", "tiny-closed"),
              "tiny-qwen.image": ("tiny-qwen-vision", "tiny-image")}
#: the tiny cells' check, and what a cell whose requests carry inputs adds
TINY_CHECK = {"widest_gap_limit": 0.2, "min_tokens_compared": 20, "sample_tokens": 40}
TINY_INPUTS_CHECK = {"features_gap_limit": 0.02}
TINY_CONFIGS = {"tiny-qwen": "qwen2.5-vl-7b", "tiny-mistral": "mistral-7b-v0.3",
                "tiny-qwen-vision": "qwen2.5-vl-7b-vision"}


def tiny_config(real: str) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{real}.json").read_text())
    cfg.update(TINY)
    cfg.pop("head_dim", None)
    if "rope_scaling" in cfg:
        cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [4, 6, 6]}
    if "vision_config" in cfg:
        cfg["vision_config"] = dict(cfg["vision_config"], **TINY_VISION)
        cfg.update(TINY_VISION_IDS)
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
    for name, real in TINY_CONFIGS.items():
        path = f"portbench/configs/{name}.json"
        (tmp_path / path).write_text(json.dumps(tiny_config(real)))
        bench["configs"].append({"name": name, "source": "tiny", "file": path,
                                 "reduced": [], "why": "CPU test"})
    for name, t in TINY_TRAFFIC.items():
        (tmp_path / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, (conf, traffic) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": conf, "traffic": traffic,
                                   "chips": 1, "why": "CPU test"})
        spec = dict(TINY_CHECK, **(TINY_INPUTS_CHECK if "inputs" in TINY_TRAFFIC[traffic]
                                   else {}))
        (tmp_path / "portbench" / "checks" / f"{cell}.json").write_text(json.dumps(spec))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [c for c in TINY_CELLS]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
