"""K1's launch plan (``gemv_plan`` in pie_tpu_torch/ops/quant_matmul_cuda.py)
at the shapes the Llama-3-8B and Llama-3.2-1B decode steps give it, and the
checks the K1 wrapper makes before it touches the card. Pure Python: the
kernel itself is held against its plain version on the card
(tests/test_torch_kernels.py)."""

import pytest
import torch

from pie_tpu_torch.ops import quant as tq
from pie_tpu_torch.ops import quant_matmul_cuda as qmc

# name: (K, N, rope head dim of the fused QKV projection or 0); the decode
# steps run every projection through K1 (8B), or wqkv and the tied head (1B)
SHAPES = {
    "8B wqkv": (4096, (32 + 2 * 8) * 128, 128),
    "8B wo": (4096, 4096, 0),
    "8B wgu": (4096, 2 * 14336, 0),
    "8B wd": (14336, 4096, 0),
    "8B lm_head": (4096, 128256, 0),
    "1B wqkv": (2048, (32 + 2 * 8) * 64, 64),
    "1B lm_head": (2048, 128256, 0),
}
ROWS = (1, 2, 8, 9, 16, 17, 32)


def _check_plan(plan, m, n, k, g, rope_dim, sms=qmc.H100_SMS):
    tn, tk = qmc.GEMV_TILE_N, qmc.GEMV_STAGE_K
    # whole feature tiles cover the output exactly once
    assert (plan.n_tiles - 1) * tn < n <= plan.n_tiles * tn
    # the K ranges are whole stages (each whole groups) covering K exactly
    assert plan.stages * tk == k
    bounds = [min(i * plan.stages_per_split, plan.stages) * tk
              for i in range(plan.splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(b % g == 0 and b % tk == 0 for b in bounds)
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    # a grid that does not cover the SMs is split, in one wave of
    # GEMV_BLOCKS_PER_SM blocks per SM, and about fills that wave unless K
    # has no more stages to split
    slots = qmc.GEMV_BLOCKS_PER_SM * sms
    if plan.n_tiles >= sms:
        assert plan.splits == 1
    else:
        assert plan.blocks <= max(slots, plan.n_tiles)
        assert plan.blocks >= min(slots, plan.n_tiles * plan.stages) * 0.6
    # a rope head and its partners dh/2 further on lie in one tile
    if rope_dim:
        assert tn % rope_dim == 0 and n % rope_dim == 0
    # the f32 workspace holds one [M, N] partial per K range
    assert plan.workspace_elems == (plan.splits * m * n if plan.splits > 1 else 0)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_at_main_path_shapes(shape, m):
    k, n, rope_dim = SHAPES[shape]
    for g in (32, 64, 128):
        plan = qmc.gemv_plan(m, n, k, g, rope_dim)
        _check_plan(plan, m, n, k, g, rope_dim)


def test_plan_splits_narrow_n_and_not_the_head():
    """The 8B wo has 4096 / 128 = 32 feature tiles on 132 SMs: K splits
    into one wave of two blocks per SM; the 8B wgu's 224 tiles and the
    head's 1,002 already cover every SM."""
    wo = qmc.gemv_plan(8, 4096, 4096, 64)
    assert wo.n_tiles == 32 and wo.splits == 8 and wo.blocks == 256
    for n in (28672, 128256):
        plan = qmc.gemv_plan(8, n, 4096, 64)
        assert plan.splits == 1 and plan.workspace_elems == 0
    # the plan does not depend on M (the stages are the same bytes)
    assert qmc.gemv_plan(1, 4096, 4096, 64).splits == wo.splits
    assert qmc.gemv_plan(32, 4096, 4096, 64).splits == wo.splits


def test_plan_follows_the_card_sm_count():
    assert qmc.gemv_plan(8, 4096, 4096, 64, sms=1).splits == 1
    h100 = qmc.gemv_plan(8, 4096, 4096, 64)
    assert qmc.gemv_plan(8, 4096, 4096, 64, sms=16).splits < h100.splits
    assert qmc.gemv_plan(8, 4096, 4096, 64, sms=1024).splits > h100.splits


@pytest.mark.parametrize("m,n,k,g,rope_dim", [
    (0, 4096, 4096, 64, 0),     # no rows
    (33, 4096, 4096, 64, 0),    # the prefill branch (K2)
    (8, 100, 4096, 64, 0),      # N not a multiple of 8 (TMA's 16-byte rows)
    (8, 4, 4096, 64, 0),
    (8, 4096, 4096, 16, 0),     # a group size K1 does not take
    (8, 4096, 4096, 256, 0),
    (8, 4096, 4000, 64, 0),     # K not padded to whole stages
    (8, 1024, 4096, 64, 256),   # a head wider than the 128-feature tile
    (8, 768, 4096, 64, 48),     # dh not a multiple of 32
    (8, 6208, 4096, 64, 128),   # N not a multiple of the head
])
def test_plan_rejects_what_k1_does_not_take(m, n, k, g, rope_dim):
    with pytest.raises(ValueError):
        qmc.gemv_plan(m, n, k, g, rope_dim)


def test_k1_wrapper_rejects_bad_n_and_cpu_tensors():
    """The K1 wrapper checks the shape before the device, and never takes a
    CPU tensor (the CPU path is quant_matmul_ref, reached only through
    quantized_matmul)."""
    qmc.reset_counts()
    narrow = tq.quantize(torch.randn(512, 100), 64, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        qmc.quant_gemv(torch.randn(8, 512).bfloat16(), narrow)
    qt = tq.quantize(torch.randn(512, 128), 64, 4)
    with pytest.raises(ValueError, match="CUDA"):
        qmc.quant_gemv(torch.randn(8, 512).bfloat16(), qt)
    with pytest.raises(ValueError, match="CUDA"):
        qmc.gemv_ln_rows(torch.randn(8, 512).bfloat16(), qt,
                         ln_w=torch.ones(512).bfloat16(), ln_eps=1e-5)
    assert qmc.launch_counts["K1"] == qmc.launch_counts["K1 ln"] == 0
    # quantized_matmul sends the same CPU call to the plain version
    y = tq.quantized_matmul(torch.randn(8, 512).bfloat16(), narrow)
    assert y.shape == (8, 100) and qmc.launch_counts["K1"] == 0
