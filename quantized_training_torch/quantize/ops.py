"""Functional quantized-tensor ops (reference: quantize/ops.py,
decomposed.py:166-419): block-expanded scales, quantize / dequantize with a
direct quantizer, and the microscaling qparams."""

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ..numerics import normalize_axes, reshape_to_blocks, shared_exponents
from ..numerics.bitutils import bits_f32

__all__ = ["expand_scale", "quantize", "dequantize", "calculate_mx_qparam"]


def expand_scale(
    scale: torch.Tensor, shape: Sequence[int], block_size: int
) -> torch.Tensor:
    """Broadcast per-block scales back to the full tensor shape.

    Matches the reference ``expand`` (decomposed.py:127-140): unsqueeze
    leading dims, repeat each mismatching dim by ``block_size``, then crop
    any padding overhang.
    """
    shape = tuple(shape)
    while scale.dim() < len(shape):
        scale = scale.unsqueeze(0)
    for dim in range(len(shape)):
        if scale.shape[dim] != shape[dim]:
            scale = torch.repeat_interleave(scale, block_size, dim=dim)
    if tuple(scale.shape) != shape:
        scale = scale[tuple(slice(0, s) for s in shape)]
    return scale


def quantize(x: torch.Tensor, scale: torch.Tensor,
             zero_point: Optional[torch.Tensor] = None,
             block_size: Optional[int] = None, qfn=None) -> torch.Tensor:
    """``qfn(x / scale + zero_point)`` with block-expanded qparams."""
    if qfn is None:
        raise ValueError("qfn must be provided for quantization")
    if block_size is not None:
        scale = expand_scale(scale, x.shape, block_size)
        if zero_point is not None:
            zero_point = expand_scale(zero_point, x.shape, block_size)
    x = x / scale if zero_point is None else x / scale + zero_point
    return qfn(x)


def dequantize(x: torch.Tensor, scale: torch.Tensor,
               zero_point: Optional[torch.Tensor] = None,
               block_size: Optional[int] = None,
               input_codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(decode(x) - zero_point) * scale``."""
    if input_codebook is not None:
        x = input_codebook[x.long()].to(x.dtype)
    if block_size is not None:
        scale = expand_scale(scale, x.shape, block_size)
        if zero_point is not None:
            zero_point = expand_scale(zero_point, x.shape, block_size)
    return x * scale if zero_point is None else (x - zero_point) * scale


def calculate_mx_qparam(
    x: torch.Tensor,
    axes: Union[int, Tuple[int, ...]],
    block_size: int,
    quant_max: float,
    force_scale_power_of_two: bool = False,
    scale_qfn=None,
) -> torch.Tensor:
    """Per-block scales for microscaling: blockwise amax / quant_max
    (optionally rounded through ``scale_qfn``), or power-of-two shared
    exponents offset by floor(log2(quant_max)) (reference:
    decomposed.py:366-419)."""
    if block_size <= 0:
        raise ValueError(f"block_size={block_size}")
    axes = normalize_axes(axes, x.dim())
    blocked, baxes, _, _ = reshape_to_blocks(x, axes, block_size)
    shared_axes = tuple(a + 1 for a in baxes)

    if force_scale_power_of_two:
        shared_exp = shared_exponents(blocked, method="max", axes=shared_axes,
                                      ebits=0)
        shared_exp = shared_exp - math.floor(math.log2(quant_max))
        for axis in reversed(baxes):
            shared_exp = shared_exp.squeeze(axis + 1)
        bits = torch.clamp(shared_exp.to(torch.int32) + 127, 0, 255) << 23
        scale = bits_f32(bits).to(x.dtype)
    else:
        amax = torch.amax(blocked.abs(), dim=shared_axes)
        scale = amax / quant_max
        if scale_qfn is not None:
            scale = scale_qfn(scale)
    return torch.where(scale > 0.0, scale, torch.ones_like(scale))
