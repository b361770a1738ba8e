"""Fused quantize-matmul (``csrc/quantized_matmul.cu``): y = x_qfn(x) @ w
with x's rounding done in the kernel's operand load (reference:
ops/pallas/quantized_matmul.py).

The model path does not call it (its GEMM inputs are rounded by the
elementwise kernel, then multiplied), as in the reference package; it is
the fused form that ``chip_smoke.py`` holds against that pair.  The
gradient is straight-through: dx = g @ w_q^T, dw = x_q^T @ g.
"""

import ctypes
from typing import Optional

import torch

from . import _cuda
from ..numerics import QuantFn

__all__ = ["quantized_matmul", "quantized_matmul_plain"]


def _plain_round(fn, x):
    if fn is None:
        return x
    return fn.plain(x) if isinstance(fn, QuantFn) else fn(x)


def quantized_matmul_plain(x: torch.Tensor, w: torch.Tensor, x_qfn=None,
                           out_dtype=None) -> torch.Tensor:
    """The plain version: ``x_qfn(x)`` (its plain PyTorch rounding, on any
    device), then the f32-accumulated product rounded to ``out_dtype``."""
    xq = _plain_round(x_qfn, x)
    y = torch.matmul(xq.to(torch.float32), w.to(torch.float32))
    return y.to(out_dtype or x.dtype)


def _lib():
    lib = _cuda.load("quantized_matmul")
    if lib.quantized_matmul.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.quantized_matmul.argtypes = [vp, vp, vp, ci, ci, ci,
                                         _cuda.QtFormat, vp]
        lib.quantized_matmul.restype = ci
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor, x_qfn) -> torch.Tensor:
    if x_qfn is not None and (not isinstance(x_qfn, QuantFn)
                              or x_qfn.fmt is None):
        raise ValueError("quantized_matmul kernel: x_qfn must be a "
                         f"quantize_fn callable with a kernel format, got "
                         f"{x_qfn!r}")
    M, K = x.shape
    N = w.shape[1]
    problems = []
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        problems.append("x and w must be bf16")
    if w.shape[0] != K or K % 8 or N % 8:
        problems.append(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                        "(K and N multiples of 8)")
    if any(not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16
           for t in (x, w)):
        problems.append("x and w must be contiguous, 16-byte aligned and on "
                        "one device")
    if problems:
        raise ValueError("quantized_matmul kernel: " + "; ".join(problems))
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.quantized_matmul(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K,
        _cuda.qt_format(x_qfn.fmt if x_qfn is not None else None),
        _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "quantized_matmul")
    quantized_matmul.launches += 1
    return y


class _QuantizedMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, x_qfn, out_dtype):
        ctx.x_qfn = x_qfn
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return quantized_matmul_plain(x, w, x_qfn, out_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"quantized_matmul: no kernel for {x.device}")
        if out_dtype not in (None, torch.bfloat16):
            raise ValueError("quantized_matmul kernel: bf16 output only")
        return _launch(x, w, x_qfn)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xq = x if ctx.x_qfn is None else ctx.x_qfn(x)
        gf = g.to(torch.float32)
        dx = torch.matmul(gf, w.to(torch.float32).T).to(x.dtype)
        dw = torch.matmul(xq.to(torch.float32).T, gf).to(w.dtype)
        return dx, dw, None, None


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, *, x_qfn=None,
                     w_qfn=None, out_dtype=None) -> torch.Tensor:
    """y = x_qfn(x) @ w_qfn(w), x (M, K), w (K, N).

    CPU tensors take :func:`quantized_matmul_plain`; CUDA tensors launch
    the kernel (bf16 x and w, K and N multiples of 8, bf16 out) with x's
    rounding inside it, and anything it does not take raises.  ``w_qfn``
    rounds the weights first (a straight-through rounding; serving folds
    it offline)."""
    if w_qfn is not None:
        from ..quantize.fake_quant import straight_through
        w = straight_through(w_qfn)(w)
    return _QuantizedMatmul.apply(x, w, x_qfn, out_dtype)


quantized_matmul.launches = 0
