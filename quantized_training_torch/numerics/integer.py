"""Arbitrary-width integer fake quantization (intN / uintN): round half to
even, then saturate to the format's range; values stay float (reference:
numerics/integer.py, fake_quantize.py:43-52)."""

import torch

from .bitutils import clamp_keep_zero_sign

__all__ = ["quantize_to_int", "int_range"]


def int_range(nbits: int, signed: bool = True):
    """(quant_min, quant_max) of an intN / uintN format."""
    if signed:
        return -(2 ** (nbits - 1)), 2 ** (nbits - 1) - 1
    return 0, 2 ** nbits - 1


def quantize_to_int(x: torch.Tensor, nbits: int,
                    signed: bool = True) -> torch.Tensor:
    """Round half to even and saturate, in float32 (exact for bf16 inputs);
    the result is returned in ``x.dtype``."""
    qmin, qmax = int_range(nbits, signed)
    xf = x.to(torch.float32)
    return clamp_keep_zero_sign(torch.round(xf), qmin, qmax).to(x.dtype)
