"""K2's launch plan (``gemm_plan`` in pie_tpu_torch/ops/quant_matmul_cuda.py)
at the shapes the Llama-3-8B and Llama-3.2-1B prefill and mixed steps give
it, and the checks the K2 wrapper makes before it touches the card. Pure
Python: the kernel itself is held against its plain version on the card
(tests/test_torch_kernels.py)."""

import pytest
import torch

from pie_tpu_torch.ops import quant as tq
from pie_tpu_torch.ops import quant_matmul_cuda as qmc

# name: (K, N, rope head dim of the fused QKV projection or 0)
SHAPES = {
    "8B wqkv": (4096, (32 + 2 * 8) * 128, 128),
    "8B wo": (4096, 4096, 0),
    "8B wgu": (4096, 2 * 14336, 0),
    "8B wd": (14336, 4096, 0),
    "8B lm_head": (4096, 128256, 0),
    "1B wqkv": (2048, (32 + 2 * 8) * 64, 64),
    "1B wo": (2048, 2048, 0),
    "1B wgu": (2048, 2 * 8192, 0),
    "1B wd": (8192, 2048, 0),
    "1B lm_head": (2048, 128256, 0),
}
ROWS = (33, 40, 64, 128, 256, 512, 2048)


def _check_plan(plan, m, n, k, g, rope_dim, sms=qmc.H100_SMS):
    tm, tn, tk = qmc.GEMM_TILE_M, qmc.GEMM_TILE_N, qmc.GEMM_TILE_K
    # whole output tiles cover the output exactly once
    assert (plan.m_tiles - 1) * tm < m <= plan.m_tiles * tm
    assert (plan.n_tiles - 1) * tn < n <= plan.n_tiles * tn
    # the K ranges fall on group boundaries and cover the padded K exactly
    assert plan.steps * tk == k
    bounds = [min(i * plan.steps_per_split, plan.steps) * tk for i in range(plan.splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(b % g == 0 for b in bounds)
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    # a card at most half filled by the output tiles takes more blocks from
    # a K split (where K has room for one), in one wave; a fuller one none
    units = k // max(tk, g)
    if 2 * plan.tiles <= sms and units > 1:
        assert plan.splits > 1 and plan.blocks <= sms
    else:
        assert plan.splits == 1
    assert plan.splits <= qmc.GEMM_MAX_SPLITS
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
        plan = qmc.gemm_plan(m, n, k, g, rope_dim)
        _check_plan(plan, m, n, k, g, rope_dim)


def test_plan_splits_small_m_and_not_large_m():
    """At M = 40 the 8B wo has one row of 4096 / 128 = 32 output tiles on
    132 SMs: K splits to fill the card in one wave; at M = 512 the 8B wgu
    has hundreds of tiles and does not split."""
    small = qmc.gemm_plan(40, 4096, 4096, 64)
    assert small.tiles == 4096 // qmc.GEMM_TILE_N
    assert small.splits > 1 and 0.9 * 132 <= small.blocks <= 132
    big = qmc.gemm_plan(512, 28672, 4096, 64)
    assert big.tiles == -(-512 // qmc.GEMM_TILE_M) * 28672 // qmc.GEMM_TILE_N > 132
    assert big.splits == 1 and big.workspace_elems == 0


def test_plan_follows_the_card_sm_count():
    assert qmc.gemm_plan(40, 6144, 4096, 64, sms=1).splits == 1
    h100 = qmc.gemm_plan(40, 4096, 4096, 64)
    assert qmc.gemm_plan(40, 4096, 4096, 64, sms=1024).splits > h100.splits > 1


@pytest.mark.parametrize("n,rope_dim", [(100, 0), (6148, 0), (4, 0), (1024, 256), (768, 48)])
def test_plan_rejects_what_k2_does_not_take(n, rope_dim):
    """N must be a multiple of 8 (TMA's 16-byte rows of bf16 scales); a rope
    head must divide the 128-column tile."""
    with pytest.raises(ValueError):
        qmc.gemm_plan(64, n, 1024, 64, rope_dim)


def test_k2_wrapper_rejects_bad_n_and_cpu_tensors():
    """The K2 wrapper checks the shape before the device, and never takes a
    CPU tensor (the CPU path is quant_matmul_ref, reached only through
    quantized_matmul)."""
    qmc.reset_counts()
    narrow = tq.quantize(torch.randn(512, 100), 64, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        qmc.quant_gemm(torch.randn(64, 512).bfloat16(), narrow)
    qt = tq.quantize(torch.randn(512, 128), 64, 4)
    with pytest.raises(ValueError, match="CUDA"):
        qmc.quant_gemm(torch.randn(64, 512).bfloat16(), qt)
    assert qmc.launch_counts["K2"] == 0
    # quantized_matmul sends the same CPU call to the plain version
    y = tq.quantized_matmul(torch.randn(64, 512).bfloat16(), narrow)
    assert y.shape == (64, 100) and qmc.launch_counts["K2"] == 0
