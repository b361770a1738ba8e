"""Posit8 weight storage: weights live in device memory as int8 posit codes
(one byte per weight) and the GEMM decodes them on the fly
(``csrc/posit_storage_matmul.cu``).

``pack_posit_weights`` is the offline step (encode, exact: decode(encode)
is the posit rounding of the weight); ``posit_matmul`` computes
``x @ decode_posit(codes)``.  Every posit8 value is exact in bf16, so the
decoded weight is the posit value itself.
"""

import ctypes
from collections import Counter

import torch

from ..numerics.posit import decode_posit, encode_posit
from . import _cuda
from ._decode_gemm import decode_args

__all__ = ["pack_posit_weights", "posit_decode_table", "posit_matmul",
           "posit_matmul_plain"]


def pack_posit_weights(w: torch.Tensor, nbits: int = 8,
                       es: int = 1) -> torch.Tensor:
    """Offline: round ``w`` to posit(nbits, es) and return the int8 codes."""
    if nbits > 8:
        raise ValueError("packed posit storage takes nbits <= 8")
    return encode_posit(w, nbits, es).to(torch.int8)


def posit_decode_table(nbits=8, es=1, device="cpu") -> torch.Tensor:
    """decode_posit of every nbits-bit code, indexed by the code's low
    nbits bits (the kernel builds the same table on the card)."""
    return decode_posit(torch.arange(1 << nbits, dtype=torch.int32,
                                     device=device), nbits, es)


def posit_matmul_plain(x, codes, *, nbits=8, es=1):
    """The plain version: decode (a lookup in the decode table, the same
    values as decode_posit elementwise) to x's dtype, f32-accumulated
    product, result in x's dtype."""
    table = posit_decode_table(nbits, es, codes.device)
    w = table[codes.to(torch.int64) & ((1 << nbits) - 1)].to(x.dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def _lib():
    lib = _cuda.load("posit_storage_matmul")
    if lib.posit_storage_matmul.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.posit_storage_matmul.argtypes = [vp, vp, vp, vp, ci, vp, ci, ci,
                                             ci, ci, ci, ci, ci, vp]
        lib.posit_storage_matmul.restype = ci
        lib.posit_storage_matmul_decode_plan.argtypes = [
            ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.posit_storage_matmul_decode_plan.restype = None
    return lib


def posit_matmul(x, codes, *, nbits=8, es=1):
    """y = x @ decode_posit(codes); x (M, K), codes (K, N) int8.

    CPU tensors take :func:`posit_matmul_plain`; CUDA tensors launch
    ``csrc/posit_storage_matmul.cu`` (bf16 x and output, posit8 with es
    0-2), and anything the kernel does not take raises.  M <= 8 runs the
    decode form (``mma.sync``, K split over blocks, ``_decode_gemm``), a
    larger M the ``wgmma`` form (``byte_storage_gemm.cuh:gemm_tc``).  Each
    launch is also tallied by its (M, K, N) in
    ``posit_matmul.shape_launches``.
    """
    if x.device.type == "cpu":
        return posit_matmul_plain(x, codes, nbits=nbits, es=es)
    if x.device.type != "cuda":
        raise ValueError(f"posit_matmul: no kernel for device {x.device}")
    M, K = x.shape
    problems = []
    if nbits != 8 or es not in (0, 1, 2):
        problems.append(f"posit{nbits}_{es} (the kernel decodes posit8, es "
                        "0-2)")
    if x.dtype != torch.bfloat16:
        problems.append(f"x {x.dtype} (needs bf16)")
    if codes.dtype != torch.int8 or codes.dim() != 2 or codes.shape[0] != K:
        problems.append(f"codes {codes.dtype} {tuple(codes.shape)} (int8, "
                        f"K={K} rows)")
    if K % 8:
        problems.append(f"K={K} (a multiple of 8)")
    if any(not t.is_contiguous() or t.device != x.device for t in (x, codes)):
        problems.append("tensors must be contiguous and on one device")
    if x.data_ptr() % 16:
        problems.append("x must be 16-byte aligned")
    if problems:
        raise ValueError("posit_matmul kernel: " + "; ".join(problems))
    N = codes.shape[1]
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    stream = _cuda.stream_ptr(x.device)
    part, floats, count, ints, sms = decode_args(
        lib.posit_storage_matmul_decode_plan, x.device, stream, M, K, N, es)
    err = lib.posit_storage_matmul(
        x.data_ptr(), codes.data_ptr(), y.data_ptr(), part, floats, count,
        ints, M, K, N, nbits, es, sms, stream)
    _cuda.check(lib, err, "posit_storage_matmul")
    posit_matmul.launches += 1
    posit_matmul.shape_launches[(M, K, N)] += 1
    return y


posit_matmul.launches = 0
posit_matmul.shape_launches = Counter()
