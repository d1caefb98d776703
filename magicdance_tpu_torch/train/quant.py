"""Which frozen leaves training stores in int8.

Counterpart of `magicdance_tpu.train.quant`: `OptimConfig.frozen_dtype =
"int8"` stores each eligible frozen leaf (a float tensor of >= 2 dims and
>= 4096 elements; norm scales, biases and small tensors keep their fp32
storage) as int8 values with one fp32 scale per output channel. This module
holds that policy; the storage format, and its dequantization at use in the
layers, is `models/quant.py`. JAX's other names are re-exported from there.
"""

from __future__ import annotations

import torch

from magicdance_tpu_torch.models.quant import dequantize, has_quantized, quantize

__all__ = ["MIN_ELEMENTS", "dequantize", "has_quantized", "quantize", "should_quantize"]

MIN_ELEMENTS = 4096


def should_quantize(p: torch.Tensor) -> bool:
    """JAX `_should_quantize`: a float leaf of >= 2 dims and >= 4096 elements."""
    return p.dim() >= 2 and p.numel() >= MIN_ELEMENTS and p.dtype in (torch.float32,
                                                                      torch.bfloat16)
