"""How K2 (``pie_tpu_torch/csrc/quant_gemm.cu``, the prefill dequant GEMM)
turns group-wise affine codes into its bf16 weights, emulated on the CPU
and held against the plain version's ``dequantize``.

K2 itself runs only on a card (``tests/test_torch_kernels.py``). Its
weights are decided by its rounding, and that is what is emulated here:

- K2 now: the codes or'ed into the mantissa of f32 1.0 (``1 + q/2^bits``,
  exact), one f32 fma with ``2^bits*s`` and ``b - 2^bits*s``, then bf16:
  one rounding of the exact ``q*s + b``;
- K2 before (its INT4 / bf16-scale path): ``(128 + q)`` as bf16, one
  bf16x2 fma with ``s`` and ``-128 s`` (``bf16(q*s)``), a second with 1.0
  and ``b``: ``bf16(bf16(q*s) + b)``, two roundings.

With bf16 scales the single rounding equals the plain version's weights
bit for bit; the double rounding does not, on realistic groups.
"""

import pytest
import torch

from pie_tpu_torch.ops.quant import dequantize, quantize, unpack_codes


def groups(bits, seed=0):
    """Codes [K, N], and each element's bf16 scale and bias, of random
    weights quantized by the port's quantizer (g = 64)."""
    gen = torch.Generator().manual_seed(seed)
    w = (torch.randn((1024, 512), generator=gen) * 0.05).bfloat16()
    qt = quantize(w, 64, bits)
    q = unpack_codes(qt.packed, bits)[:1024]
    s = qt.scales.repeat_interleave(64, dim=0)[:1024]
    b = qt.biases.repeat_interleave(64, dim=0)[:1024]
    assert s.dtype == b.dtype == torch.bfloat16
    return qt, q, s, b


def k2_single(q, s, b, bits):
    """K2's arithmetic: 1 + q/2^bits from the mantissa bits, the f32 fma
    (one rounding of the exact value, done here in f64, where the exact
    value fits), then bf16."""
    one_plus = ((q.to(torch.int32) << (23 - bits)) | 0x3F800000).view(torch.float32)
    sp = s.float() * float(1 << bits)
    be = b.float() - sp
    exact = one_plus.double() * sp.double() + be.double()
    return exact.float().bfloat16()


def k2_double(q, s, b):
    """The INT4 / bf16-scale arithmetic K2 had: bf16(q*s), then bf16(+ b)."""
    qs = (q.double() * s.double()).float().bfloat16()
    return (qs.double() + b.double()).float().bfloat16()


@pytest.mark.parametrize("bits", [4, 8])
def test_single_rounding_equals_the_plain_weights(bits):
    """K2's weights, bit for bit the plain version's bf16(q*s + b)."""
    qt, q, s, b = groups(bits, seed=bits)
    plain = dequantize(qt, torch.bfloat16)
    got = k2_single(q, s, b, bits)
    assert torch.equal(got.view(torch.int16), plain.view(torch.int16))


def test_double_rounding_moves_int4_weights():
    """The fault the single rounding removes: rounded twice, many INT4
    weights (47 % of these) differ from the plain version's."""
    qt, q, s, b = groups(4)
    plain = dequantize(qt, torch.bfloat16)
    twice = k2_double(q, s, b)
    differ = int((twice.view(torch.int16) != plain.view(torch.int16)).sum())
    assert differ > 0
    # each rounding moves a value by at most half a bf16 step, 2^-8 of what it
    # rounds: twice, of q*s (which may be larger than the weight: b is about
    # -7.5 s) and of the weight; the plain version, of the weight
    qs = q.double() * s.double()
    bound = 2.0 ** -8 * (qs.abs() + 2 * plain.double().abs())
    assert bool(((twice.double() - plain.double()).abs() <= bound).all())


if __name__ == "__main__":
    qt, q, s, b = groups(4)
    plain = dequantize(qt, torch.bfloat16)
    n = q.numel()
    d = int((k2_double(q, s, b).view(torch.int16) != plain.view(torch.int16)).sum())
    e = int((k2_single(q, s, b, 4).view(torch.int16) != plain.view(torch.int16)).sum())
    print(f"INT4 g64 bf16 scales, {n} weights: double rounding differs at {d} "
          f"({100 * d / n:.2f} %), single rounding at {e}")
