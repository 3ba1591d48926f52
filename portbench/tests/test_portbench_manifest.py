"""BENCHMARK.json's own checks: the contract's keys, names and units, every
per-layer metric with its cells and the end-to-end metric it moves, one
chip a cell, and a file for every configuration, traffic mix, check and
metric it names."""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "checks" / f"{w['name']}.json").is_file()
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_per_layer_metric_lists_its_cells_and_what_it_moves():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w]), (m["name"], w)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        names = {m["name"] for m in mine}
        assert "setup_s" in names and len(names) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
