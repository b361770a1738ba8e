"""Functional fake quantization.

This slice carries the group-wise affine scheme, which the w4a16 weight
storage realizes exactly (reference: fake_quantize.py:150-180).  Direct
rounding, delayed scaling, microscaling and outlier masking come with the
fake-quant port and raise here.
"""

from typing import Optional, Tuple

import torch

from ..numerics import (clamp_keep_zero_sign, materialize_rounding,
                        normalize_axes, reshape_to_blocks)
from ..qspec import QScheme, QuantizationSpec
from .ops import expand_scale

__all__ = ["fake_quantize", "straight_through"]


class _StraightThrough(torch.autograd.Function):
    """Value transform with an identity gradient: the reference's fake-quant
    autograd Functions return grad_output unchanged for the input
    (fake_quantize.py:131-133)."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def straight_through(fn):
    """Wrap a value transform with a straight-through gradient."""
    return lambda x: _StraightThrough.apply(x, fn)


def _group_affine_qparams(x: torch.Tensor, spec: QuantizationSpec):
    """Blockwise affine qparams (reference: fake_quantize.py:150-180)."""
    if spec.scale_dtype:
        raise NotImplementedError(
            "quantized qparam scales come with the numerics port")
    axes = normalize_axes(spec.ch_axis, x.dim())
    blocked, baxes, _, _ = reshape_to_blocks(x, axes, spec.block_size)
    shared_axes = tuple(a + 1 for a in baxes)
    mn = torch.amin(blocked, dim=shared_axes)
    mx = torch.amax(blocked, dim=shared_axes)
    sf = (mx - mn) / (spec.quant_max - spec.quant_min)
    sf = torch.where(sf > 0.0, sf, torch.ones_like(sf))
    zp = -mn / sf + spec.quant_min
    return sf, zp


def _group_affine_value(x: torch.Tensor, spec: QuantizationSpec):
    sf, zp = _group_affine_qparams(x, spec)
    sfe = expand_scale(sf, x.shape, spec.block_size)
    zpe = expand_scale(zp, x.shape, spec.block_size)
    q = clamp_keep_zero_sign(
        torch.round(materialize_rounding(x / sfe + zpe)),
        spec.quant_min, spec.quant_max,
    )
    return (q - zpe) * sfe, (sf, zp)


def fake_quantize(
    x: torch.Tensor,
    spec: Optional[QuantizationSpec],
    state=None,
    *,
    observe: bool = True,
    quantize: bool = True,
) -> Tuple[torch.Tensor, None]:
    """Fake-quantize ``x`` per ``spec``; returns ``(y, state)``.

    Straight-through gradient on the value path.  Only ``spec=None`` and the
    stateless group-wise affine scheme are ported in this slice.
    """
    if spec is None:
        return x, state
    if spec.qscheme != QScheme.GROUP_WISE_AFFINE or spec.outlier_threshold:
        raise NotImplementedError(
            f"{spec}: only group_wise_affine is ported; the other schemes "
            "come with slice 2 (ROADMAP A3)")
    if not quantize:
        return x, state
    value = straight_through(lambda t: _group_affine_value(t, spec)[0])
    return value(x), state
