"""Group-affine quantized weight storage (W4A16): weights live in device
memory as bit-packed 4-bit codes + per-group scale/zero-point, and the GEMM
dequantizes them on the fly (``csrc/affine_w4_matmul.cu``).

Layout: *int32 words, consecutive along K*.  Word ``r`` of column ``n``
holds the codes of original rows ``r*8 + p`` (p = 0..7) in bit field p,
each stored *centered* (c - 8) as a 4-bit two's-complement field, so that a
shift-left / arithmetic-shift-right pair sign-extends it.  ``sf``/``zp`` are
(K/group, N) float32; words never straddle groups (``group`` must be a
multiple of 8).  The dequantized values reproduce the
``uint4,qs=group_wise_affine,bs=G,ax=0`` fake-quant bit for bit
(reference: fake_quantize.py:150-180).
"""

import ctypes
from typing import Tuple

import torch

from ..numerics import clamp_keep_zero_sign, materialize_rounding
from ..qspec import QuantizationSpec
from ..quantize.fake_quant import _group_affine_qparams
from ..quantize.ops import expand_scale
from . import _cuda

__all__ = ["affine_spec", "pack_affine_weights", "plane_pack",
           "affine_matmul", "affine_matmul_plain"]


def affine_spec(nbits: int, group_size: int) -> QuantizationSpec:
    """The fake-quant spec this storage format realizes exactly."""
    return QuantizationSpec.from_str(
        f"uint{nbits},qs=group_wise_affine,bs={group_size},ax=0")


def pack_affine_weights(
    w: torch.Tensor, nbits: int = 4, group_size: int = 128
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Offline: (K, N) weights -> ``(packed, sf, zp)``.

    ``packed`` is int32 (K/per, N), per = 32 // nbits; ``sf``/``zp`` are
    float32 (K/group_size, N).  Quantization runs in float32, so the
    dequantized codes reproduce ``fake_quantize(w.float(), affine_spec(...))``
    bit for bit.
    """
    w = w.to(torch.float32)
    K, N = w.shape
    per = 32 // nbits
    if group_size % per or K % group_size:
        raise ValueError(
            f"need group_size % (32/nbits)=={per} == 0 and K % group_size "
            f"== 0 (words must not straddle groups); got K={K}, "
            f"group_size={group_size}, nbits={nbits}")
    spec = affine_spec(nbits, group_size)
    sf, zp = _group_affine_qparams(w, spec)           # (K/G, N)
    sfe = expand_scale(sf, w.shape, group_size)
    zpe = expand_scale(zp, w.shape, group_size)
    codes = clamp_keep_zero_sign(
        torch.round(materialize_rounding(w / sfe + zpe)),
        spec.quant_min, spec.quant_max,
    ).to(torch.int32)                                  # (K, N) in [0, 2^nbits)
    return plane_pack(codes, sf, zp, nbits, group_size)


def plane_pack(
    codes: torch.Tensor, sf: torch.Tensor, zp: torch.Tensor,
    nbits: int, group_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack (K, N) integer codes in [0, 2^nbits) + group qparams into the
    storage layout."""
    K, N = codes.shape
    per = 32 // nbits
    if group_size % per or K % group_size:
        raise ValueError(
            f"need group_size % {per} == 0 and K % group_size == 0; got "
            f"K={K}, group_size={group_size}, nbits={nbits}")
    kp = K // per
    mask = (1 << nbits) - 1
    mid = 1 << (nbits - 1)
    fields = ((codes.to(torch.int32) - mid) & mask).reshape(kp, per, N)
    packed = torch.zeros((kp, N), dtype=torch.int32, device=codes.device)
    for p in range(per):
        packed |= fields[:, p] << (nbits * p)
    return packed, sf.to(torch.float32), zp.to(torch.float32)


def _dequant_planes(packed, sf, zp, nbits, group_size):
    """Full dequant: (K/per, N) int32 words -> (K, N) float32, bit for bit
    the ``affine_spec`` fake-quant of the packed weights ((c - zp) * sf)."""
    per = 32 // nbits
    kp, N = packed.shape
    mid = 1 << (nbits - 1)
    cs = [(packed << (32 - nbits * (p + 1))) >> (32 - nbits)
          for p in range(per)]                        # sign-extended centered
    c = torch.stack(cs, dim=1).reshape(kp * per, N).to(torch.float32) + mid
    sfe = expand_scale(sf, c.shape, group_size)
    zpe = expand_scale(zp, c.shape, group_size)
    return (c - zpe) * sfe


def affine_matmul_plain(x, packed, sf, zp, *, nbits=4, group_size=128):
    """The plain version: dequantize to x's dtype, f32-accumulated product,
    result in x's dtype."""
    w = _dequant_planes(packed, sf, zp, nbits, group_size).to(x.dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return y.to(x.dtype)


def _lib():
    lib = _cuda.load("affine_w4_matmul")
    if lib.affine_w4_matmul.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.affine_w4_matmul.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                         vp]
        lib.affine_w4_matmul.restype = ci
    return lib


def affine_matmul(x, packed, sf, zp, *, nbits=4, group_size=128):
    """y = x @ dequant(packed); x (M, K), packed (K/8, N) int32, qparams
    (K/group_size, N) float32.

    CPU tensors take :func:`affine_matmul_plain`; CUDA tensors launch
    ``csrc/affine_w4_matmul.cu`` (bf16 x and output, nbits=4), and anything
    the kernel does not take raises.
    """
    if x.device.type == "cpu":
        return affine_matmul_plain(x, packed, sf, zp, nbits=nbits,
                                   group_size=group_size)
    M, K = x.shape
    kp, N = packed.shape
    if x.device.type != "cuda":
        raise ValueError(f"affine_matmul: no kernel for device {x.device}")
    problems = []
    if nbits != 4:
        problems.append(f"nbits={nbits} (the kernel is w4)")
    if x.dtype != torch.bfloat16:
        problems.append(f"x {x.dtype} (needs bf16)")
    if packed.dtype != torch.int32 or sf.dtype != torch.float32 \
            or zp.dtype != torch.float32:
        problems.append("codes int32 and qparams float32 expected")
    if kp * 8 != K or group_size % 8 or K % group_size \
            or tuple(sf.shape) != (K // group_size, N) \
            or tuple(zp.shape) != (K // group_size, N):
        problems.append(f"shapes x {tuple(x.shape)} codes "
                        f"{tuple(packed.shape)} sf {tuple(sf.shape)} "
                        f"group {group_size}")
    tensors = (x, packed, sf, zp)
    if any(not t.is_contiguous() or t.device != x.device for t in tensors):
        problems.append("tensors must be contiguous and on one device")
    if x.data_ptr() % 16:
        problems.append("x must be 16-byte aligned")
    if problems:
        raise ValueError("affine_matmul kernel: " + "; ".join(problems))
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.affine_w4_matmul(
        x.data_ptr(), packed.data_ptr(), sf.data_ptr(), zp.data_ptr(),
        y.data_ptr(), M, K, N, group_size, _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "affine_w4_matmul")
    affine_matmul.launches += 1
    return y


affine_matmul.launches = 0
