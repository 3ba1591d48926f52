"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip skipped (the CPU's plain path), everything else
as a run does it, for each fault a served cell can have."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import harness

CELL = "tiny-qwen.chat"
#: the cells each fault runs in: text chat, and chat with images
CELLS = [CELL, "tiny-qwen.image"]


def _judge_every_finished_request(root, cell=CELL):
    path = root / "portbench" / "checks" / f"{cell}.json"
    spec = json.loads(path.read_text())
    path.write_text(json.dumps(dict(spec, sample_tokens=10**6)))


def _token_altered(mp):
    """A token altered where it is produced: the sampler's choice plus one."""
    import pie_tpu_torch.engine.scheduler as sched

    sample = sched.sample
    mp.setattr(sched, "sample", lambda logits, *a, **k: (
        sample(logits, *a, **k) + 1) % logits.shape[-1])


def _state_unchanged(mp):
    """Every step returns the KV pool as it found it: no key or value is
    written."""
    import pie_tpu_torch.models.llama as llama
    import pie_tpu_torch.models.qwen2_vl as qwen

    for mod in (llama, qwen):
        mp.setattr(mod, "scatter_tokens", lambda *a, **k: None)


def _half_the_batch_left_out(mp):
    """The second half of the decode lanes left out of the step: they take
    the first half's logits."""
    import pie_tpu_torch.models.qwen2_vl as qwen

    fwd = qwen.Qwen2VLModel.paged_forward

    def half(self, *a, **k):
        logits, pool = fwd(self, *a, **k)
        if logits is not None and logits.shape[1] == 1:
            b = logits.shape[0] // 2
            logits = torch.cat([logits[:b], logits[:logits.shape[0] - b]])
        return logits, pool

    mp.setattr(qwen.Qwen2VLModel, "paged_forward", half)


def test_the_sound_program_is_correct(tiny_root):
    _judge_every_finished_request(tiny_root)
    res = harness.run_cell(tiny_root, CELL, 4242, 10.0, False, device="cpu")
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("judge_all", [True, False],
                         ids=["every-finished-request", "the-cells-own-sample"])
@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_the_batch_left_out])
def test_a_broken_program_is_not_correct(tiny_root, monkeypatch, fault, judge_all, cell):
    if judge_all:
        _judge_every_finished_request(tiny_root, cell)
    fault(monkeypatch)
    res = harness.run_cell(tiny_root, cell, 4242, 10.0, False, device="cpu")
    assert not res["correct"], res["compared"]
    assert res["compared"]["widest_gap"]["value"] > res["compared"]["widest_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(tiny_root, cell):
    """The float8 control serves the sampled requests and the harness's own
    ``check.compare`` judges it, at the cell's own sample."""
    from portbench import calibrate, check

    spec = json.loads((tiny_root / "portbench" / "checks" / f"{cell}.json").read_text())
    _, run, _ = harness.serve(tiny_root, cell, 4242, 10.0, False, device="cpu")
    cpu = torch.device("cpu")
    assert calibrate.judged(check.compare(run, run.cfg, spec, 4242, cpu))["correct"]
    control = calibrate.control_run(run, spec, 4242, cpu)
    assert not calibrate.judged(check.compare(control, run.cfg, spec, 4242, cpu))["correct"]
