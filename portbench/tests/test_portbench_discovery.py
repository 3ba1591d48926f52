"""A configuration, a traffic mix, a cell's check and a metric, each added
as files of their own with entries in BENCHMARK.json, are found by name
with no other edit."""

from __future__ import annotations

import json

from conftest import tiny_config
from portbench import harness


def test_added_files_are_found_by_name(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = tiny_config("mistral-7b-v0.3")
    cfg["num_hidden_layers"] = 3
    (tiny_root / "portbench/configs/tiny-mistral-3.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-mistral-3", "source": "tiny",
                             "file": "portbench/configs/tiny-mistral-3.json",
                             "reduced": [], "why": "added"})
    (tiny_root / "portbench/traffic/tiny-short.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 3.0,
         "prompt_tokens": {"dist": "uniform", "min": 40, "max": 48},
         "output_tokens": {"dist": "uniform", "min": 3, "max": 5}}))
    bench["workloads"].append({"name": "tiny-added", "config": "tiny-mistral-3",
                               "traffic": "tiny-short", "chips": 1, "why": "added"})
    (tiny_root / "portbench/checks/tiny-added.json").write_text(json.dumps(
        {"widest_gap_limit": 0.2, "min_tokens_compared": 3, "sample_tokens": 10}))
    (tiny_root / "portbench/metrics/requests_sent.py").write_text(
        "def read(run):\n    return len(run.sent)\n")
    bench["end_to_end"].append({"name": "requests_sent", "unit": "requests",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-added"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = harness.run_cell(tiny_root, "tiny-added", 77, 8.0, False, device="cpu")
    assert res["correct"], res["compared"]
    assert res["metrics"]["requests_sent"]["value"] == res["attempted"] > 0
    assert "setup_s" in res["metrics"]
