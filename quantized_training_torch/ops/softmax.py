"""Posit-approximated softmax with the reference's custom backward
(reference: ops/softmax.py, modules/softmax.py:19-51).

exp and 1/sum are rounded through posit16_1, the function of the
reference's gold LUT files; the backward's reciprocal term uses the
hardware's approximate derivative 2^(-2*floor(log2 sum) - 1).  The roundings
go through ``numerics.quantize_fn_positive``: plain code on the CPU, the
rounding kernel on CUDA.
"""

import torch

from ..numerics import quantize_fn_positive

__all__ = ["posit_softmax"]


def _posit16(x: torch.Tensor) -> torch.Tensor:
    return quantize_fn_positive("posit16_1")(x.contiguous())


class _PositSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, use_posit_exp, use_posit_reciprocal):
        xf = x.to(torch.float32)
        shifted = xf - torch.amax(xf, dim=-1, keepdim=True)
        exp_x = _posit16(torch.exp(shifted)) if use_posit_exp \
            else torch.exp(shifted)
        exp_sum = torch.sum(exp_x, dim=-1, keepdim=True)
        if use_posit_reciprocal:
            out = exp_x * _posit16(1.0 / exp_sum)
            ctx.save_for_backward(out, exp_x, exp_sum)
        else:
            out = exp_x / exp_sum
            ctx.save_for_backward(out)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        gf = g.to(torch.float32)
        if len(ctx.saved_tensors) == 1:
            # the exact softmax Jacobian (reference: softmax.py:41-44)
            (out,) = ctx.saved_tensors
            grad = out * gf
            grad = grad - out * torch.sum(grad, dim=-1, keepdim=True)
        else:
            # d(1/s)/ds ~ -2^(-2*floor(log2 s) - 1) (reference:
            # softmax.py:46-49)
            out, exp_x, exp_sum = ctx.saved_tensors
            grad = out * gf
            sum_grad = torch.sum(exp_x * gf, dim=-1, keepdim=True)
            deriv = torch.exp2(torch.floor(torch.log2(exp_sum)) * -2.0 - 1.0)
            grad = grad - deriv * exp_x * sum_grad
        return grad.to(g.dtype), None, None


def posit_softmax(x: torch.Tensor, use_posit_exp: bool = True,
                  use_posit_reciprocal: bool = False) -> torch.Tensor:
    """Softmax over the last axis with posit16-rounded exp / reciprocal;
    the max is subtracted outside the approximation."""
    return _PositSoftmax.apply(x, use_posit_exp, use_posit_reciprocal)
