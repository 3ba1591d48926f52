"""Compute ops: quantization, the CUDA quantized-matmul kernels, attention,
RoPE, sampling."""

from pie_tpu_torch.ops.quant import (
    QuantizedTensor,
    dequantize,
    quantize,
    quantized_matmul,
)
