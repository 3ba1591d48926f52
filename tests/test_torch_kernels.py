"""The hand-written CUDA kernels K1 (decode GEMV) and K2 (prefill GEMM)
against their plain PyTorch version, on a CUDA card. Imports no JAX, so it
runs on the card's machine: python -m pytest tests/test_torch_kernels.py.
Elsewhere every test skips: the kernels have no CPU mode."""

import pytest
import torch

from pie_tpu_torch.ops import quant as tq
from pie_tpu_torch.ops import quant_matmul_cuda as qmc
from pie_tpu_torch.ops.rope import rope_qkv_cs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _norm_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("m", [1, 32, 200])
@pytest.mark.parametrize("bits,group_size", [(4, 64), (4, 32), (4, 128), (8, 64)])
def test_kernel_matches_plain(cuda, m, bits, group_size):
    hq, hkv, dh, k = 8, 2, 128, 1024
    n = (hq + 2 * hkv) * dh
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = (torch.randn((2, k, n), generator=gen, device=cuda) * 0.05).bfloat16()
    qt = tq.quantize(w, group_size, bits)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    kw = {}
    if m <= qmc.DECODE_MAX_M:
        lnw = (1 + 0.1 * torch.randn((2, k), generator=gen, device=cuda)).to(torch.bfloat16)
        pos = torch.arange(m, device=cuda, dtype=torch.int32) * 5
        inv = torch.rand(dh // 2, generator=gen, device=cuda)
        kw = dict(ln_w=lnw, ln_eps=1e-5, rope_dim=dh,
                  rope_cs=rope_qkv_cs(pos, inv, hq, hkv, dh))
    qmc.reset_counts()
    got = tq.quantized_matmul(x, qt, layer=1, **kw)
    torch.cuda.synchronize()
    assert qmc.launch_counts["K1" if m <= 32 else "K2"] == 1
    want = qmc.quant_matmul_ref(x, qt, layer=1, **kw)
    assert _norm_err(got, want) < 0.025


def test_kernel_rejects_what_it_does_not_take(cuda):
    qt = tq.quantize(torch.randn((512, 256), device=cuda).bfloat16(), 64, 4)
    with pytest.raises(ValueError):  # f32 activations
        qmc.quant_gemv(torch.randn((1, 512), device=cuda), qt)
    with pytest.raises(ValueError):  # CPU weights
        qmc.quant_gemv(torch.randn((1, 512), device=cuda).bfloat16(), qt.to("cpu"))
    with pytest.raises(ValueError):  # prologue on the prefill branch
        qmc.quant_matmul_cuda(torch.randn((64, 512), device=cuda).bfloat16(), qt,
                              ln_w=torch.ones(512, device=cuda).bfloat16())
