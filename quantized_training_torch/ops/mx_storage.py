"""MX-int8 weight storage: weights live in device memory as int8 codes plus
one bf16 scale per 64-row block of the contraction dim, and the GEMM
dequantizes them on the fly (``csrc/mx_storage_matmul.cu``).

``pack_mx_weights`` is the offline step: blockwise amax scales along K (the
reference's weight ax=-1 in its (out, in) layout is axis 0 of the (in, out)
kernels), codes = round(w / scale).  Dequant is ``bf16(code * scale)``: the
f32 product of an int8 code and a bf16 scale is exact, rounded once, so
the dequantized weight reproduces the ``int8,qs=microscaling,bs=...``
fake-quant with the scale stored in bf16.
"""

import ctypes
from collections import Counter
from typing import Tuple

import torch

from ..numerics import quantize_fn
from ..quantize.ops import calculate_mx_qparam, expand_scale
from . import _cuda
from ._decode_gemm import decode_args

__all__ = ["pack_mx_weights", "mx_dequant", "mx_matmul", "mx_matmul_plain"]


def pack_mx_weights(w: torch.Tensor, nbits: int = 8, block_size: int = 64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offline: (K, N) weights -> int8 codes (K, N) + bf16 scales
    (K/block_size, N)."""
    quant_max = float(2 ** (nbits - 1) - 1)
    scale = calculate_mx_qparam(w, (0,), block_size, quant_max)
    qfn = quantize_fn(f"int{nbits}")
    codes = qfn(w.to(torch.float32)
                / expand_scale(scale, w.shape, block_size).to(torch.float32))
    return codes.to(torch.int8), scale.to(torch.bfloat16)


def mx_dequant(codes: torch.Tensor, scales: torch.Tensor, block_size: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """The dequantized (K, N) weight: code * scale in f32, rounded once."""
    return (codes.to(torch.float32)
            * expand_scale(scales.to(torch.float32), codes.shape,
                           block_size)).to(dtype)


def mx_matmul_plain(x, codes, scales, *, block_size=64):
    """The plain version: dequantize to x's dtype, f32-accumulated product,
    result in x's dtype."""
    w = mx_dequant(codes, scales, block_size, x.dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def _lib():
    lib = _cuda.load("mx_storage_matmul")
    if lib.mx_storage_matmul.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mx_storage_matmul.argtypes = [vp, vp, vp, vp, vp, ci, vp, ci, ci,
                                          ci, ci, ci, ci, vp]
        lib.mx_storage_matmul.restype = ci
        lib.mx_storage_matmul_decode_plan.argtypes = [
            ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.mx_storage_matmul_decode_plan.restype = None
    return lib


def mx_matmul(x, codes, scales, *, block_size=64):
    """y = x @ (codes * expand(scales)); x (M, K), codes (K, N) int8,
    scales (K/block_size, N) bf16.

    CPU tensors take :func:`mx_matmul_plain`; CUDA tensors launch
    ``csrc/mx_storage_matmul.cu`` (bf16 x and output), and anything the
    kernel does not take raises.  M <= 8 with a block size that is a
    multiple of 8 runs the decode form (``mma.sync``, K split over blocks,
    ``_decode_gemm``); any other M or block size the ``wgmma`` form
    (``byte_storage_gemm.cuh:gemm_tc``).  Each launch is also tallied by
    its (M, K, N) in ``mx_matmul.shape_launches``.
    """
    if x.device.type == "cpu":
        return mx_matmul_plain(x, codes, scales, block_size=block_size)
    if x.device.type != "cuda":
        raise ValueError(f"mx_matmul: no kernel for device {x.device}")
    M, K = x.shape
    problems = []
    if x.dtype != torch.bfloat16:
        problems.append(f"x {x.dtype} (needs bf16)")
    if codes.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        problems.append("codes int8 and scales bf16 expected")
    N = codes.shape[1] if codes.dim() == 2 else -1
    if codes.dim() != 2 or codes.shape[0] != K or K % block_size \
            or tuple(scales.shape) != (K // block_size, N):
        problems.append(f"shapes x {tuple(x.shape)} codes "
                        f"{tuple(codes.shape)} scales {tuple(scales.shape)} "
                        f"block {block_size}")
    if K % 8:
        problems.append(f"K={K} (a multiple of 8)")
    if any(not t.is_contiguous() or t.device != x.device
           for t in (x, codes, scales)):
        problems.append("tensors must be contiguous and on one device")
    if x.data_ptr() % 16:
        problems.append("x must be 16-byte aligned")
    if problems:
        raise ValueError("mx_matmul kernel: " + "; ".join(problems))
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    stream = _cuda.stream_ptr(x.device)
    part, floats, count, ints, sms = decode_args(
        lib.mx_storage_matmul_decode_plan, x.device, stream, M, K, N,
        block_size)
    err = lib.mx_storage_matmul(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), y.data_ptr(),
        part, floats, count, ints, M, K, N, block_size, sms, stream)
    _cuda.check(lib, err, "mx_storage_matmul")
    mx_matmul.launches += 1
    mx_matmul.shape_launches[(M, K, N)] += 1
    return y


mx_matmul.launches = 0
mx_matmul.shape_launches = Counter()
