"""Functional fake quantization with explicit observer state.

``fake_quantize(x, spec, state) -> (y, state')`` covers the reference's
schemes (reference: quantize/fake_quant.py, fake_quantize.py:98-435):
direct rounding, per-tensor and per-channel delayed scaling with an amax
history, microscaling, group-wise affine (optionally with rounded qparams),
and outlier masking.  :class:`FakeQuantState` carries the amax history ring,
the scale and the step count as tensors of a fixed shape.  The value path
has a straight-through gradient.

Direct rounding goes through ``numerics.quantize_fn``: the plain rounding
on CPU tensors, the rounding kernel on CUDA tensors.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ..numerics import normalize_axes, quantize_fn, reshape_to_blocks
from ..numerics.bitutils import clamp_keep_zero_sign, materialize_rounding
from ..qspec import QScheme, QuantizationSpec
from .ops import calculate_mx_qparam, expand_scale

__all__ = ["FakeQuantState", "init_state", "fake_quantize",
           "straight_through", "scale_shape_for"]


class FakeQuantState(NamedTuple):
    """Observer state of the delayed-scaling schemes.

    amax_history: (amax_history_len, *scale_shape) float32 ring buffer.
    scale:        (*scale_shape,) float32, always valid (starts at 1).
    step:         int32 scalar, observer updates so far.
    """

    amax_history: torch.Tensor
    scale: torch.Tensor
    step: torch.Tensor


def scale_shape_for(spec: QuantizationSpec, x_shape: Tuple[int, ...]):
    """Shape of the scale tensor of a spec applied to an input shape."""
    if spec.qscheme == QScheme.PER_CHANNEL_SYMMETRIC:
        ch_axis = spec.ch_axis if isinstance(spec.ch_axis, int) else -1
        ch_axis = ch_axis + len(x_shape) if ch_axis < 0 else ch_axis
        return tuple(x_shape[i] if i == ch_axis else 1
                     for i in range(len(x_shape)))
    return ()


def init_state(spec: QuantizationSpec, x_shape: Tuple[int, ...] = (),
               device=None) -> Optional[FakeQuantState]:
    """Fresh observer state; None for the stateless schemes."""
    if spec.qscheme in (QScheme.MICROSCALING, QScheme.GROUP_WISE_AFFINE):
        return None
    ahl = spec.amax_history_len or 16
    sshape = scale_shape_for(spec, x_shape)
    return FakeQuantState(
        amax_history=torch.zeros((ahl,) + sshape, dtype=torch.float32,
                                 device=device),
        scale=torch.ones(sshape, dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))


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


def _direct_round_fn(spec: QuantizationSpec):
    qfn = quantize_fn(spec.dtype)
    return lambda t: qfn(materialize_rounding(t))


def _observe_amax(x: torch.Tensor, state: FakeQuantState,
                  spec: QuantizationSpec) -> FakeQuantState:
    """Delayed scaling: the scale from the amax *history*, then the current
    amax pushed (reference: fake_quantize.py:217-242)."""
    if spec.qscheme == QScheme.PER_CHANNEL_SYMMETRIC:
        ch_axis = spec.ch_axis if isinstance(spec.ch_axis, int) else -1
        ch_axis = ch_axis + x.dim() if ch_axis < 0 else ch_axis
        dims = tuple(i for i in range(x.dim()) if i != ch_axis)
        amax_cur = torch.amax(x.abs(), dim=dims, keepdim=True)
    else:
        amax_cur = x.abs().max()
    amax_cur = amax_cur.to(torch.float32)

    amax = torch.amax(state.amax_history, dim=0)
    history = state.amax_history
    if history.shape[0] > 1:
        history = torch.roll(history, -1, dims=0)
    history = history.clone()
    history[0] = amax_cur

    sf = amax / spec.quant_max
    sf = torch.where(amax > 0.0, sf, state.scale)
    sf = torch.where(torch.isfinite(amax), sf, state.scale)
    if spec.force_scale_power_of_two:
        sf = torch.exp2(torch.ceil(torch.log2(sf)))
    return FakeQuantState(amax_history=history, scale=sf,
                          step=state.step + 1)


def _apply_scale_quant(x, scale, spec: QuantizationSpec):
    """qfn(x / scale) * scale in the input dtype."""
    qfn = quantize_fn(spec.dtype)
    scale = scale.to(x.dtype)
    return qfn(materialize_rounding(x / scale)) * scale


def _mx_value(x, spec: QuantizationSpec):
    qfn = quantize_fn(spec.dtype)
    scale_qfn = quantize_fn(spec.scale_dtype) if spec.scale_dtype else None
    axes = tuple(normalize_axes(spec.ch_axis, x.dim()))
    scale = calculate_mx_qparam(x, axes, spec.block_size, spec.quant_max,
                                spec.force_scale_power_of_two, scale_qfn)
    se = expand_scale(scale, x.shape, spec.block_size)
    return qfn(materialize_rounding(x / se)) * se, scale


def _group_affine_qparams(x: torch.Tensor, spec: QuantizationSpec):
    """Blockwise affine qparams (reference: fake_quantize.py:150-180); with
    ``scale_dtype`` the scale and zero point are rounded to that format."""
    axes = normalize_axes(spec.ch_axis, x.dim())
    blocked, baxes, _, _ = reshape_to_blocks(x, axes, spec.block_size)
    shared_axes = tuple(a + 1 for a in baxes)
    mn = torch.amin(blocked, dim=shared_axes)
    mx = torch.amax(blocked, dim=shared_axes)
    sf = (mx - mn) / (spec.quant_max - spec.quant_min)
    sf = torch.where(sf > 0.0, sf, torch.ones_like(sf))
    zp = -mn / sf + spec.quant_min
    if spec.scale_dtype:
        scale_qfn = quantize_fn(spec.scale_dtype)
        sf, zp = scale_qfn(sf), scale_qfn(zp)
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
    state: Optional[FakeQuantState] = None,
    *,
    observe: bool = True,
    quantize: bool = True,
) -> Tuple[torch.Tensor, Optional[FakeQuantState]]:
    """Fake-quantize ``x`` per ``spec``; returns ``(y, state')``.

    ``observe``/``quantize`` are the reference's observer_enabled /
    fake_quant_enabled switches.  A delayed-scaling spec given no state
    starts from :func:`init_state`.
    """
    if spec is None:
        return x, state

    if spec.qscheme is None:
        # direct rounding, no observer and no scale (the paper's forward
        # posit8 / E4M3 mode)
        if not quantize:
            return x, state
        return straight_through(_direct_round_fn(spec))(x), state

    # outlier masking: quantize only |x| < threshold, restore the outliers
    # (reference: fake_quantize.py:352-359, 400-402)
    if spec.outlier_threshold is not None:
        mask = x.abs() < spec.outlier_threshold
        x_in = torch.where(mask, x, torch.zeros_like(x))
    else:
        mask = None
        x_in = x

    if spec.qscheme == QScheme.MICROSCALING:
        value = straight_through(lambda t: _mx_value(t, spec)[0])
        y = value(x_in) if quantize else x_in
        new_state = state
    elif spec.qscheme == QScheme.GROUP_WISE_AFFINE:
        value = straight_through(lambda t: _group_affine_value(t, spec)[0])
        y = value(x_in) if quantize else x_in
        new_state = state
    else:
        if state is None:
            state = init_state(spec, tuple(x_in.shape), x_in.device)
        new_state = (_observe_amax(x_in.detach(), state, spec) if observe
                     else state)
        if quantize:
            scale = new_state.scale
            y = straight_through(
                lambda t: _apply_scale_quant(t, scale, spec))(x_in)
        else:
            y = x_in

    if mask is not None:
        y = torch.where(mask, y, x)
    return y, new_state
