"""Group-affine quantized weight storage (W4A16, W2A16): weights live in
device memory as bit-packed 4- or 2-bit codes + per-group scale/zero-point,
and the GEMM dequantizes them on the fly (``csrc/affine_w4_matmul.cu``).

Layout: *int32 words, consecutive along K*.  Word ``r`` of column ``n``
holds the codes of original rows ``r*per + p`` (per = 32/nbits, p =
0..per-1) in bit field p, each stored *centered* (c - 2^(nbits-1)) as an
nbits-wide two's-complement field, so that a shift-left /
arithmetic-shift-right pair sign-extends it.  ``sf``/``zp`` are
(K/group, N) float32; words never straddle groups (``group`` must be a
multiple of per).  The dequantized values reproduce the
``uint{nbits},qs=group_wise_affine,bs=G,ax=0`` fake-quant bit for bit
(reference: fake_quantize.py:150-180).

``w2x4`` stores the w2 codes in the w4 word layout
(:func:`expand_w2_words_to_w4`, zero points shifted by +6), so the nbits=4
GEMM computes the same products.  :func:`dequant_planes` is the streaming
dequant to plane-major bf16 (``csrc/affine_dequant.cu``), with the matching
activation permutation :func:`_plane_major_x`.
"""

import ctypes
from collections import Counter
from typing import Tuple

import torch

from ..numerics import clamp_keep_zero_sign, materialize_rounding
from ..qspec import QuantizationSpec
from ..quantize.fake_quant import _group_affine_qparams
from ..quantize.ops import expand_scale
from . import _cuda
from ._decode_gemm import decode_args, decode_plan

__all__ = ["affine_spec", "pack_affine_weights", "plane_pack",
           "expand_w2_words_to_w4", "affine_matmul", "affine_matmul_plain",
           "dequant_planes", "dequant_planes_plain"]


def expand_w2_words_to_w4(packed2: torch.Tensor) -> torch.Tensor:
    """(K/16, N) int32 w2 words -> (K/8, N) int32 w4 words holding the same
    centered w2 code values in 4-bit two's-complement fields: rows p < 8 of
    w2 word r land in w4 word 2r field p, rows p >= 8 in word 2r+1 field
    p-8.  Consumed by the nbits=4 GEMM with zero points pre-shifted by +6:
    (zp + 6 - 8) * sf == (zp - 2) * sf."""
    kp2, N = packed2.shape
    even = torch.zeros((kp2, N), dtype=torch.int32, device=packed2.device)
    odd = torch.zeros_like(even)
    for p in range(8):
        c_lo = (packed2 << (32 - 2 * (p + 1))) >> 30       # rows p
        c_hi = (packed2 << (32 - 2 * (p + 9))) >> 30       # rows p + 8
        even |= (c_lo & 0xF) << (4 * p)
        odd |= (c_hi & 0xF) << (4 * p)
    return torch.stack([even, odd], dim=1).reshape(kp2 * 2, N)


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
        lib.affine_w4_matmul.argtypes = [vp, vp, vp, vp, vp, vp, ci, vp, ci,
                                         ci, ci, ci, ci, ci, ci, vp]
        lib.affine_w4_matmul.restype = ci
        lib.affine_w4_matmul_decode_plan.argtypes = [
            ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.affine_w4_matmul_decode_plan.restype = None
    return lib


def affine_matmul(x, packed, sf, zp, *, nbits=4, group_size=128):
    """y = x @ dequant(packed); x (M, K), packed (K/per, N) int32 (per =
    32/nbits), qparams (K/group_size, N) float32.

    CPU tensors take :func:`affine_matmul_plain`; CUDA tensors launch
    ``csrc/affine_w4_matmul.cu`` (bf16 x and output, nbits 4 or 2), and
    anything the kernel does not take raises.  The library's decode plan
    (``affine_w4_matmul_decode_plan``, asked through ``_decode_gemm``)
    picks the form: M <= 8 at a group that is a multiple of 16 runs the
    decode form (``mma.sync``, K split over blocks); every other call the
    ``wgmma`` form (``w4_gemm_tc``), also counted in
    ``affine_matmul.prefill_launches`` (every M > 8, the prefill, and M
    <= 8 at a group such as w4's 8).  Each launch is also tallied by its
    (M, K, N) in ``affine_matmul.shape_launches``.
    """
    if x.device.type == "cpu":
        return affine_matmul_plain(x, packed, sf, zp, nbits=nbits,
                                   group_size=group_size)
    M, K = x.shape
    kp, N = packed.shape
    if x.device.type != "cuda":
        raise ValueError(f"affine_matmul: no kernel for device {x.device}")
    problems = []
    if nbits not in (4, 2):
        problems.append(f"nbits={nbits} (the kernel takes 4 or 2)")
    per = 32 // nbits if nbits in (4, 2) else 8
    if x.dtype != torch.bfloat16:
        problems.append(f"x {x.dtype} (needs bf16)")
    if packed.dtype != torch.int32 or sf.dtype != torch.float32 \
            or zp.dtype != torch.float32:
        problems.append("codes int32 and qparams float32 expected")
    if kp * per != K or group_size % per or K % group_size \
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
    stream = _cuda.stream_ptr(x.device)
    plan_fn = lib.affine_w4_matmul_decode_plan
    splits = decode_plan(plan_fn, x.device, M, K, N, group_size)[0]
    part, floats, count, ints, sms = decode_args(plan_fn, x.device, stream,
                                                 M, K, N, group_size)
    err = lib.affine_w4_matmul(
        x.data_ptr(), packed.data_ptr(), sf.data_ptr(), zp.data_ptr(),
        y.data_ptr(), part, floats, count, ints, M, K, N, group_size, nbits,
        sms, stream)
    _cuda.check(lib, err, "affine_w4_matmul")
    affine_matmul.launches += 1
    if not splits:
        affine_matmul.prefill_launches += 1
    affine_matmul.shape_launches[(M, K, N)] += 1
    return y


affine_matmul.launches = 0
affine_matmul.prefill_launches = 0
affine_matmul.shape_launches = Counter()


# ---------------------------------------------------------------------------
# Streaming dequant to plane-major bf16 (kernel 6)
# ---------------------------------------------------------------------------

def _plane_major_x(x: torch.Tensor, kp: int, per: int) -> torch.Tensor:
    """Permute activation columns to match :func:`dequant_planes`' row
    order: column p*kp + r multiplies original row r*per + p."""
    M = x.shape[0]
    return x.reshape(M, kp, per).transpose(1, 2).reshape(M, kp * per)


def dequant_planes_plain(packed, sf, zp, nbits, group_size,
                         out_dtype=torch.bfloat16):
    """The plain version: :func:`_dequant_planes` rounded once to
    ``out_dtype``, rows permuted to plane-major order (row p*kp + r is
    original row r*per + p)."""
    per = 32 // nbits
    kp, N = packed.shape
    w = _dequant_planes(packed, sf, zp, nbits, group_size).to(out_dtype)
    return w.reshape(kp, per, N).transpose(0, 1).reshape(kp * per, N)


def _dequant_lib():
    lib = _cuda.load("affine_dequant")
    if lib.affine_dequant_planes.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.affine_dequant_planes.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                              vp]
        lib.affine_dequant_planes.restype = ci
    return lib


def dequant_planes(packed, sf, zp, nbits, group_size):
    """Packed words (K/per, N) -> (K, N) bf16 in plane-major row order:
    output row ``p * (K/per) + r`` is original row ``r * per + p``, bit for
    bit :func:`_dequant_planes` rounded to bf16.  ``_plane_major_x(x)
    @ dequant_planes(...)`` is the original product up to the order of the
    f32 sums.  Off the model path: the GEMM takes any K itself.

    CPU tensors take :func:`dequant_planes_plain`; CUDA tensors launch
    ``csrc/affine_dequant.cu``, and anything it does not take raises.
    """
    if packed.device.type == "cpu":
        return dequant_planes_plain(packed, sf, zp, nbits, group_size)
    if packed.device.type != "cuda":
        raise ValueError(f"dequant_planes: no kernel for device "
                         f"{packed.device}")
    kp, N = packed.shape
    problems = []
    if nbits not in (4, 2):
        problems.append(f"nbits={nbits} (4 or 2)")
    per = 32 // nbits if nbits in (4, 2) else 8
    K = kp * per
    if packed.dtype != torch.int32 or sf.dtype != torch.float32 \
            or zp.dtype != torch.float32:
        problems.append("codes int32 and qparams float32 expected")
    if group_size % per or K % group_size \
            or tuple(sf.shape) != (K // group_size, N) \
            or tuple(zp.shape) != (K // group_size, N):
        problems.append(f"shapes codes {tuple(packed.shape)} sf "
                        f"{tuple(sf.shape)} group {group_size}")
    if any(not t.is_contiguous() or t.device != packed.device
           for t in (packed, sf, zp)):
        problems.append("tensors must be contiguous and on one device")
    if problems:
        raise ValueError("dequant_planes kernel: " + "; ".join(problems))
    out = torch.empty((K, N), dtype=torch.bfloat16, device=packed.device)
    lib = _dequant_lib()
    err = lib.affine_dequant_planes(
        packed.data_ptr(), sf.data_ptr(), zp.data_ptr(), out.data_ptr(), K,
        N, group_size, nbits, _cuda.stream_ptr(packed.device))
    _cuda.check(lib, err, "affine_dequant_planes")
    dequant_planes.launches += 1
    return out


dequant_planes.launches = 0
