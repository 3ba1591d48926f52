"""K4's launch plan (``mlp_plan`` in pie_tpu_torch/ops/fused_mlp.py) at the
widths of the Llama-3.2-1B and Llama-3-8B decode blocks, every row count,
format and several card sizes, and the checks the K4 wrapper makes before
it touches the card. Pure Python: the kernel itself is held against its
plain version on the card (tests/test_torch_kernels.py)."""

import pytest
import torch

from pie_tpu_torch.ops import fused_mlp as tf
from pie_tpu_torch.ops import quant as tq
from pie_tpu_torch.ops import quant_matmul_cuda as qmc

# name: (d_attn, d, di)
WIDTHS = {"1B": (2048, 2048, 8192), "8B": (4096, 4096, 14336)}
SMS = (1, 16, 66, 132, 264)
FORMATS = [(bits, g, f32) for bits in (4, 8) for g in (32, 64, 128) for f32 in (False, True)]


def _check_phase(phase, blocks, di):
    # whole stages of 128 rows, each split a non-empty run, together every
    # stage exactly once
    assert phase.stages * tf.STAGE_K == phase.k
    seen = [s for sp in range(phase.splits) for s in phase.split_stages(sp)]
    assert seen == list(range(phase.stages))
    assert all(len(phase.split_stages(sp)) > 0 for sp in range(phase.splits))
    assert len(phase.split_stages(0)) == phase.stages_per_split
    # a split phase gives a block at most one task (the owner of a tile
    # waits for its other splits, which must not wait behind it)
    if phase.splits > 1:
        assert phase.tasks <= blocks
    # the tiles cover the output features exactly once
    feats = [f for t in range(phase.tiles) for f in phase.tile_features(t, di)]
    assert sorted(feats) == list(range(phase.n))


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f"int{f[0]}-g{f[1]}{'-f32' if f[2] else ''}")
@pytest.mark.parametrize("width", list(WIDTHS))
def test_plan_covers_every_stage_once(width, fmt):
    d_attn, d, di = WIDTHS[width]
    bits, g, f32 = fmt
    for m in range(1, tf.MAX_M + 1):
        for sms in SMS:
            plan = tf.mlp_plan(m, d_attn, d, di, bits, g, f32, sms=sms)
            assert plan.blocks == sms * tf.BLOCKS_PER_SM
            assert [p.name for p in plan.phases] == ["wo", "wgu", "wd"]
            assert [(p.k, p.n) for p in plan.phases] == [(d_attn, d), (d, 2 * di), (di, d)]
            for phase in plan.phases:
                _check_phase(phase, plan.blocks, di)
            assert plan.grid_barriers == 2
            assert plan.ring_stages == tf.ring_stages(bits, g, f32) >= 2


def test_wgu_tiles_pair_g_with_u():
    """wgu tile j holds the g features [64j, 64j + 64) and the u features
    [di + 64j, di + 64j + 64), so the block that finishes it writes
    act[:, 64j:64j + 64]."""
    d_attn, d, di = WIDTHS["1B"]
    wgu = tf.mlp_plan(8, d_attn, d, di, 4, 64).phases[1]
    assert wgu.tiles == di // 64
    for j in (0, 1, 77, wgu.tiles - 1):
        feats = wgu.tile_features(j, di)
        assert feats[:64] == list(range(64 * j, 64 * j + 64))
        assert feats[64:] == list(range(di + 64 * j, di + 64 * j + 64))


def test_plan_at_the_1b_widths_on_an_h100():
    """264 resident blocks: wo 16 tiles x 16 splits of 1 stage, wgu 128 x 2
    of 8, wd 16 x 16 of 4: every block but 8 streams 13 stages."""
    plan = tf.mlp_plan(8, 2048, 2048, 8192, 4, 64)
    assert plan.blocks == 264 and plan.ring_stages == 8
    assert [(p.tiles, p.splits, p.stages_per_split) for p in plan.phases] == [
        (16, 16, 1), (128, 2, 8), (16, 16, 4)]
    per_block = [sum(len(p.split_stages(t // p.tiles)) for p in plan.phases
                     for t in range(b, p.tasks, plan.blocks)) for b in range(plan.blocks)]
    assert per_block.count(13) == 256 and max(per_block) == 13
    # the plan does not depend on M (the stages are the same bytes)
    assert tf.mlp_plan(1, 2048, 2048, 8192, 4, 64).phases == plan.phases


def test_plan_follows_the_card_sm_count():
    d_attn, d, di = WIDTHS["1B"]
    splits = [sum(p.splits for p in tf.mlp_plan(8, d_attn, d, di, 4, 64, sms=s).phases)
              for s in SMS]
    assert splits == sorted(splits) and splits[0] == 3 and splits[-1] > splits[2]
    # a tile count that covers the grid is not split
    assert all(p.splits == 1 for p in tf.mlp_plan(8, d_attn, d, di, 4, 64, sms=1).phases)
    assert tf.mlp_plan(8, d_attn, d, di, 4, 64, blocks_per_sm=1).blocks == 132


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_workspace_follows_the_plan(width, m):
    """f32 partials [tiles, splits, M, 128] of each split phase, the rows'
    sums of squares per wo tile (padded to 16 bytes), h2 and act in bf16."""
    d_attn, d, di = WIDTHS[width]
    for sms in SMS:
        plan = tf.mlp_plan(m, d_attn, d, di, 4, 64, sms=sms)
        parts = sum(p.tiles * p.splits * m * 128 * 4 for p in plan.phases if p.splits > 1)
        ss = -(-(d // 128) * m * 4 // 16) * 16
        assert plan.workspace_bytes == parts + ss + 2 * m * d + 2 * m * di
        assert plan.counters == 4 + d // 128 + di // 64 + d // 128


def test_ring_stages_fit_the_ring():
    """K4's ring per block (csrc/gemv_tile.cuh): 128-row stages of x boxes,
    words, scale and bias rows and x sums, each rounded up to 1 KB, as many
    as 100 KB hold, at most 8."""
    assert tf.ring_stages(4, 64) == 8 and tf.ring_stages(8, 64) == 5
    assert tf.ring_stages(8, 32, True) == 4 and tf.ring_stages(4, 32) == 7
    for bits, g, f32 in FORMATS:
        stage = (2 * 8 * 128 + 128 * bits // 32 * 128 * 4
                 + 2 * (128 // g) * 128 * (4 if f32 else 2) + 4 * 8 * 4)
        stage = -(-stage // 1024) * 1024
        assert tf.ring_stages(bits, g, f32) == min(100 * 1024 // stage, 8)


@pytest.mark.parametrize("m,d_attn,d,di,bits,g", [
    (0, 2048, 2048, 8192, 4, 64),     # no rows
    (9, 2048, 2048, 8192, 4, 64),     # more than one n8 tile
    (8, 2048, 2048, 8192, 2, 64),     # a bit width K4 does not take
    (8, 2048, 2048, 8192, 4, 16),     # a group size K4 does not take
    (8, 2048, 2000, 8192, 4, 64),     # d not whole tiles
    (8, 2048, 2048, 8000, 4, 64),     # di not whole tiles
    (8, 2000, 2048, 8192, 4, 64),     # d_attn not whole stages
    (8, 8192, 8192, 8192, 4, 64),     # an ln2 row wider than K4 keeps
])
def test_plan_rejects_what_k4_does_not_take(m, d_attn, d, di, bits, g):
    with pytest.raises(ValueError):
        tf.mlp_plan(m, d_attn, d, di, bits, g)


def test_k4_wrapper_checks_before_the_card():
    """The K4 wrapper refuses what the plan refuses and CPU tensors before
    it launches anything, and counts no launch."""
    qmc.reset_counts()

    def trio(d, di, layers=2):
        q = lambda k, n: tq.quantize(torch.zeros(layers, k, n), 64, 4)
        return q(d, d), q(d, 2 * di), q(di, d)

    wide = trio(4608, 512, layers=1)  # d 4608 > MAX_D
    x = torch.zeros(1, 4608).bfloat16()
    with pytest.raises(ValueError, match="d <= 4096"):
        tf.fused_mlp_cuda(x, x, torch.ones(1, 4608).bfloat16(), 0, *wide)
    small = trio(512, 512)
    x = torch.zeros(2, 512).bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_mlp_cuda(x, x, torch.ones(2, 512).bfloat16(), 1, *small)
    assert qmc.launch_counts["K4"] == 0
