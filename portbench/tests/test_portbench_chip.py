"""On the card only (marked ``cuda``; skipped elsewhere): a run of each
cell is correct, and the control, put in the program's place at the cell's
own size on three seeds, comes out not correct while the program holds.

    python -m pytest portbench/tests/test_portbench_chip.py -q   # on the card
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels have no CPU form")


def _lines(out: str) -> list:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", str(2**33 + 5), "--seconds", "10", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    assert _lines(out)[-1]["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_holds(card, cell):
    """The control served in the program's place and judged by the harness's
    own ``check.compare``: the program's runs are correct, the control's not,
    at the cell's load on three seeds; where the check compares the served
    embeddings, the control's float8 features fail that number too."""
    out = subprocess.run([sys.executable, "portbench/calibrate.py", "--workload", cell,
                          "--seconds", "20", "--control", "--seeds", "31", "32", "33"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    lines = _lines(out)
    assert len(lines) == 3
    assert all(x["program"]["correct"] and not x["control"]["correct"] for x in lines), lines
    spec = json.loads((ROOT / "portbench" / "checks" / f"{cell}.json").read_text())
    if "features_gap_limit" in spec:
        assert all(x["control"]["features_gap"] > spec["features_gap_limit"]
                   for x in lines), lines
