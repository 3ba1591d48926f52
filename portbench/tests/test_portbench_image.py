"""Qwen2.5-VL's kit at a tiny size on the CPU: the plain tower against the
port's ``Qwen2VisionTower``, the reference's image M-RoPE streams against
the port's ``image_positions``, and the image path broken underneath.

Each fault makes a whole run of the tiny image cell come out not correct:
the tower's features zeroed, the window permutation left undone, full
attention in every block (each seen by the served embeddings' gap to the
plain tower, ``features_gap``), and image prompts given text positions
(seen by the logits' widest gap)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import tiny_config
from portbench import harness, kit
from portbench.reference.decoder import mrope_index
from portbench.reference.vision import Tower

CELL = "tiny-qwen.image"
CFG = tiny_config("qwen2.5-vl-7b-vision")
QWEN = kit.load("portbench/kits/qwen2_5_vl.py")


def _port_tower(cfg, seed):
    from pie_tpu_torch.models.qwen2_vl import Qwen2VisionTower

    tower = Qwen2VisionTower(cfg["vision_config"])
    return tower, tower.from_hf_state_dict(QWEN.state_dict(cfg, seed, "cpu"))


def _pixels(grids, seed):
    n = sum(t * h * w for t, h, w in grids)
    return torch.randn((n, QWEN.patch_dim(CFG["vision_config"])),
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("grids", [[(1, 10, 14)], [(1, 16, 16)], [(1, 8, 8)],
                                   [(1, 10, 14), (1, 18, 6)]],
                         ids=["ragged-10x14", "whole-windows-16x16", "one-window",
                              "two-images"])
def test_the_plain_tower_matches_the_ports(grids):
    """Window and full blocks over ragged and whole grids, two images in one
    call: the port's dense masks over its window order against the plain
    window-by-window tower in the processor's order."""
    tower, vp = _port_tower(CFG, 3)
    px = _pixels(grids, 4)
    got = tower.forward(vp, px, np.array(grids))
    ref = Tower(CFG["vision_config"], lambda i: QWEN.tower_block(CFG, 3, i, "cpu"),
                lambda: QWEN.tower_top(CFG, 3, "cpu"))
    at, want = 0, []
    for t, h, w in grids:
        want.append((px[at:at + t * h * w], (t, h, w)))
        at += t * h * w
    want = torch.cat(ref.features(want))
    err = float((got - want).abs().max() / want.abs().max())
    # float32 on both sides: only the order of the sums differs
    assert err < 1e-4, err


def test_the_tower_windows_tile_the_grid():
    t = Tower(CFG["vision_config"], None, None)
    wins = t.windows((1, 10, 14))  # 5 x 7 units in 4 x 4-unit windows
    assert sorted(len(w) for w in wins) == sorted(4 * n for n in (16, 12, 4, 3))
    assert sorted(i for w in wins for i in w) == list(range(140))


@pytest.mark.parametrize("grids,cut", [([(1, 10, 14)], 7), ([(1, 16, 16)], 1),
                                       ([(1, 8, 12), (1, 14, 6)], 30)])
def test_image_positions_match_the_ports(grids, cut):
    """The reference's streams and decode offset against the port's
    ``image_positions``, served tokens after the prompt included."""
    from pie_tpu_torch.models.loader import build_model
    from pie_tpu_torch.models.qwen2_vl import image_positions

    model = build_model({k: v for k, v in CFG.items() if k != "assumed"})
    text = list(range(5, 45))
    prompt, at = [], 0
    for (t, h, w) in grids:
        n = t * h * w // 4
        prompt += text[at:at + cut] + [CFG["vision_start_token_id"]] + [CFG["image_token_id"]] * n \
            + [CFG["vision_end_token_id"]]
        at += cut
    prompt += text[at:]
    p3, delta = image_positions(model, [prompt], np.array(grids), len(prompt))
    served = [7, 8, 9, 10]
    ref = mrope_index(prompt + served, CFG["image_token_id"], CFG["vision_start_token_id"],
                      grids, 2)
    assert np.array_equal(ref[:, :len(prompt)].numpy(), p3[:, 0])
    slots = np.arange(len(prompt), len(prompt) + len(served))
    assert np.array_equal(ref[:, len(prompt):].numpy(), np.stack([slots - delta] * 3))


# -- whole runs with the timed path broken ---------------------------------------


def _judge_every_finished_request(root):
    path = root / "portbench" / "checks" / f"{CELL}.json"
    spec = json.loads(path.read_text())
    path.write_text(json.dumps(dict(spec, sample_tokens=10**6)))


def _tower(mp, wrap):
    from pie_tpu_torch.models.qwen2_vl import Qwen2VisionTower

    fwd = Qwen2VisionTower.forward
    mp.setattr(Qwen2VisionTower, "forward",
               lambda self, vp, px, grid: wrap(self, fwd, vp, px, grid))


def _features_zeroed(mp):
    """The tower's features zeroed where they are produced."""
    _tower(mp, lambda self, fwd, vp, px, grid: torch.zeros_like(fwd(self, vp, px, grid)))


def _window_order_left(mp):
    """The merged features left in window order: the permutation that
    gathered the merge units by window is not undone."""
    def wrap(self, fwd, vp, px, grid):
        order = self._window_order(np.asarray(grid))[0]
        return fwd(self, vp, px, grid)[torch.from_numpy(order)]

    _tower(mp, wrap)


def _full_attention_everywhere(mp):
    """Every block attends over the whole image: no window."""
    def wrap(self, fwd, vp, px, grid):
        self.fullatt_block_indexes = list(range(self.depth))
        return fwd(self, vp, px, grid)

    _tower(mp, wrap)


def _text_positions(mp):
    """An image prompt's M-RoPE streams given as text positions (one
    position a token on all three streams, no decode offset)."""
    import pie_tpu_torch.models.qwen2_vl as qwen

    def text(model, ids, grid, length):
        t = np.asarray(ids).shape[1]
        return np.broadcast_to(np.arange(t, dtype=np.int32), (3, 1, t)).copy(), 0

    mp.setattr(qwen, "image_positions", text)


def test_the_sound_program_is_correct(tiny_root):
    _judge_every_finished_request(tiny_root)
    res = harness.run_cell(tiny_root, CELL, 4242, 10.0, False, device="cpu")
    assert res["correct"], res["compared"]
    assert res["diagnostics"]["judged_with_inputs"] > 0
    assert res["compared"]["features_gap"]["value"] > 0


@pytest.mark.parametrize("fault,seen_by", [
    (_features_zeroed, "features_gap"), (_window_order_left, "features_gap"),
    (_full_attention_everywhere, "features_gap"), (_text_positions, "widest_gap")])
def test_a_broken_image_path_is_not_correct(tiny_root, monkeypatch, fault, seen_by):
    _judge_every_finished_request(tiny_root)
    fault(monkeypatch)
    res = harness.run_cell(tiny_root, CELL, 4242, 10.0, False, device="cpu")
    assert not res["correct"], res["compared"]
    assert res["compared"][seen_by]["value"] > res["compared"][seen_by]["limit"]
