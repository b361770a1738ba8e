"""Elementwise direct rounding (``csrc/quantize_elemwise.cu``).

The wrapper of the rounding kernel that every direct-rounding site reaches
on CUDA through ``numerics.quantize_fn``: any contiguous bf16 or f32 tensor,
the same dtype out, in every format (posit, fp8, fpN, int, the NormalFloat
codebooks, the native bf16 and f16 casts).  Its plain version is the
numerics code itself (``QuantFn.plain``), taken only for CPU tensors.
"""

import ctypes

import torch

from . import _cuda

__all__ = ["quantize_elemwise", "quantize_elemwise_plain"]


def quantize_elemwise_plain(x: torch.Tensor, qfn) -> torch.Tensor:
    """The plain version: the PyTorch rounding of ``qfn`` (a
    ``numerics.QuantFn``) on any device."""
    return qfn.plain(x)


def _lib():
    lib = _cuda.load("quantize_elemwise")
    if lib.quantize_elemwise.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.quantize_elemwise.argtypes = [vp, vp, ctypes.c_longlong, ci,
                                          _cuda.QtFormat, vp]
        lib.quantize_elemwise.restype = ci
    return lib


def quantize_elemwise(x: torch.Tensor, fmt) -> torch.Tensor:
    """Round every element of the CUDA tensor ``x`` to ``fmt`` (a
    ``numerics.RoundFormat``) with the kernel; anything it does not take
    raises."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_elemwise kernel: tensor on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantize_elemwise kernel: dtype {x.dtype} (bf16 "
                         "or f32)")
    if not x.is_contiguous():
        raise ValueError("quantize_elemwise kernel: x must be contiguous")
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.quantize_elemwise(
        x.data_ptr(), out.data_ptr(), x.numel(),
        int(x.dtype == torch.bfloat16),
        _cuda.qt_format(fmt, bf16=x.dtype == torch.bfloat16),
        _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "quantize_elemwise")
    quantize_elemwise.launches += 1
    if fmt.kind == "nf":
        quantize_elemwise.nf_launches += 1
    elif fmt.kind == "cast":
        quantize_elemwise.cast_launches += 1
    return out


quantize_elemwise.launches = 0        # every form
quantize_elemwise.nf_launches = 0     # the NormalFloat-codebook form
quantize_elemwise.cast_launches = 0   # the native bf16 / f16 cast form
