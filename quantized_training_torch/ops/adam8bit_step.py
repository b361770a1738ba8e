"""The fused 8-bit Adam moment update (``csrc/adam8bit_step.cu``;
reference: ops/pallas/adam8bit_step.py), for unpacked and for
int32-word-packed moments.

Unpacked layout: the leaf flattened and zero-padded to (nb, 256) blocks of
256 elements, m as int8 codes (nb, 256), v as uint8 codes of sqrt(v)
(nb, 256), one f32 scale per row (nb,).  The update is the reference's CPU
path of an unpacked leaf (training/optim8bit.py:258-265); the kernel is
held bit for bit to :func:`fused_adam8bit_update_plain`.

Packed layout (bit-compatible with the reference): moments are (nb, 256)
blocks of 256 elements, nb a multiple of the 512-row tile.  Within tile t,
the int32 word at (t*128 + r, l) holds the codes of rows t*512 + p*128 + r
(p = 0..3) in byte field p: signed int8 fields for m, uint8 fields of
sqrt(v) for v.  Scales, one f32 per row, are tiled lane-wide: tile t's 512
scales fill rows t*8 .. t*8+1 of an (nb/64, 256) array, rows t*8+2 ..
t*8+7 are zero.

The update itself is the reference's CPU path of a packed leaf
(training/optim8bit.py:203-217): m = b1*(mc*ms) + (1-b1)*g, v = b2*(root*
root) + (1-b2)*(g*g) with root = vc*vs, u = (m/bc1) / (sqrt(v/bc2) + eps),
then each row of m requantized by absmax/127 and of sqrt(v) by max/255, with
true divisions and round half to even.  The kernel is held bit for bit to
:func:`fused_adam8bit_update_packed_plain`.
"""

import ctypes
from collections import Counter

import numpy as np
import torch

from . import _cuda

__all__ = ["BLOCK", "TILE_ROWS", "packable_rows", "pack_moment_rows",
           "unpack_moment_rows", "pack_scale_rows", "unpack_scale_rows",
           "adam_constants", "div_rn", "sqrt_rn",
           "fused_adam8bit_update", "fused_adam8bit_update_plain",
           "fused_adam8bit_update_packed",
           "fused_adam8bit_update_packed_plain", "fast_path_check"]

BLOCK = 256        # quantization block (elements per row)
TILE_ROWS = 512    # rows per packed tile
_PLANES = 4
_PR = TILE_ROWS // _PLANES   # word rows per tile
_SR = 8                      # scale rows per tile (2 used, 6 zero)


def packable_rows(nb: int) -> bool:
    return nb % TILE_ROWS == 0


def pack_scale_rows(scale: torch.Tensor) -> torch.Tensor:
    """(nb,) per-row f32 scales -> the (nb/64, 256) tiled layout."""
    nb = scale.shape[0]
    if not packable_rows(nb):
        raise ValueError(f"pack_scale_rows: {nb} rows, not a multiple of "
                         f"{TILE_ROWS}")
    nt = nb // TILE_ROWS
    s = scale.reshape(nt, 2, BLOCK)
    pad = torch.zeros((nt, _SR - 2, BLOCK), dtype=s.dtype, device=s.device)
    return torch.cat([s, pad], dim=1).reshape(nt * _SR, BLOCK)


def unpack_scale_rows(tiled: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_scale_rows` -> (nb,) f32."""
    nt = tiled.shape[0] // _SR
    return tiled.reshape(nt, _SR, BLOCK)[:, :2].reshape(-1)


def pack_moment_rows(codes: torch.Tensor) -> torch.Tensor:
    """(nb, 256) integer codes (int8 or uint8 range) -> (nb/4, 256) int32
    words: field p of word (t*128 + r, l) is code (t*512 + p*128 + r, l)
    & 0xFF."""
    nb, blk = codes.shape
    if blk != BLOCK or not packable_rows(nb):
        raise ValueError(f"pack_moment_rows: codes {tuple(codes.shape)}")
    c = codes.to(torch.int32) & 0xFF
    tiles = c.reshape(nb // TILE_ROWS, _PLANES, _PR, BLOCK)
    shifts = (torch.arange(_PLANES, dtype=torch.int32, device=c.device)
              * 8).reshape(1, _PLANES, 1, 1)
    return torch.sum(tiles << shifts, dim=1, dtype=torch.int32).reshape(
        nb // _PLANES, BLOCK)


def unpack_moment_rows(words: torch.Tensor, signed: bool) -> torch.Tensor:
    """Inverse of :func:`pack_moment_rows`: int32 codes, sign-extended
    (``signed``) or zero-extended."""
    nw, blk = words.shape
    w = words.reshape(nw // _PR, 1, _PR, blk)
    sh = (torch.arange(_PLANES, dtype=torch.int32, device=words.device)
          * 8).reshape(1, _PLANES, 1, 1)
    if signed:
        planes = (w << (24 - sh)) >> 24
    else:
        planes = (w >> sh) & 0xFF
    return planes.reshape(nw * _PLANES, blk)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of f32 ``x``.  torch's CPU sqrt
    is not (its vectorized loop is off by an ulp on some inputs, and which
    elements it takes depends on the thread split); the f64 root rounded
    once to f32 is, since 53 >= 2 * 24 + 2 bits."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def div_rn(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, correctly rounded: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, so the divisor goes in as a tensor."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def adam_constants(b1: float, b2: float, eps: float):
    """(b1, 1 - b1, b2, 1 - b2, eps) as the f32 values the reference
    multiplies by: each Python expression rounded to f32 once."""
    return tuple(float(np.float32(x))
                 for x in (b1, 1.0 - b1, b2, 1.0 - b2, eps))


def fused_adam8bit_update_plain(g2d, m_codes, m_scale, v_codes, v_scale,
                                bc1: float, bc2: float, *, b1: float,
                                b2: float, eps: float):
    """Kernel 13's plain version: dequantize, update, requantize, on any
    device, in blocks of ``g2d.shape[1]`` elements (the kernel's 256, or
    any other block size of the optimizer).  Returns (update, m_codes,
    m_scale, v_codes, v_scale)."""
    from ..training.optim8bit import (_dequantize_signed, _dequantize_sqrt,
                                      _quantize_signed, _quantize_sqrt)
    b1f, omb1, b2f, omb2, epsf = adam_constants(b1, b2, eps)
    m = b1f * _dequantize_signed(m_codes, m_scale, g2d.shape) + omb1 * g2d
    v = b2f * _dequantize_sqrt(v_codes, v_scale, g2d.shape) + omb2 * g2d * g2d
    upd = div_rn(m, bc1) / (sqrt_rn(div_rn(v, bc2)) + epsf)
    mc, ms = _quantize_signed(m, g2d.shape[1])
    vc, vs = _quantize_sqrt(v, g2d.shape[1])
    return upd, mc, ms, vc, vs


def fused_adam8bit_update_packed_plain(g2d, m_words, m_scale, v_words,
                                       v_scale, bc1: float, bc2: float, *,
                                       b1: float, b2: float, eps: float):
    """The plain version: unpack, update, requantize, repack, on any
    device.  Returns (update, m_words, m_scale, v_words, v_scale)."""
    from ..training.optim8bit import _quantize_signed, _quantize_sqrt
    b1f, omb1, b2f, omb2, epsf = adam_constants(b1, b2, eps)
    mc = unpack_moment_rows(m_words, signed=True)
    vc = unpack_moment_rows(v_words, signed=False)
    msf = unpack_scale_rows(m_scale)
    vsf = unpack_scale_rows(v_scale)
    m = b1f * (mc.to(torch.float32) * msf[:, None]) + omb1 * g2d
    root = vc.to(torch.float32) * vsf[:, None]
    v = b2f * (root * root) + omb2 * (g2d * g2d)
    upd = div_rn(m, bc1) / (sqrt_rn(div_rn(v, bc2)) + epsf)
    mcq, ms = _quantize_signed(m, BLOCK)
    vcq, vs = _quantize_sqrt(v, BLOCK)
    return (upd, pack_moment_rows(mcq), pack_scale_rows(ms),
            pack_moment_rows(vcq), pack_scale_rows(vs))


def _lib():
    lib = _cuda.load("adam8bit_step")
    if lib.adam8bit_packed.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.adam8bit_packed, lib.adam8bit_unpacked):
            fn.argtypes = [vp] * 10 + [ci] + [cf] * 7 + [vp]
        lib.adam8bit_fast_path_check.argtypes = [ctypes.c_ulonglong, vp, vp]
        for fn in (lib.adam8bit_packed, lib.adam8bit_unpacked,
                   lib.adam8bit_fast_path_check):
            fn.restype = ci
    return lib


def fast_path_check(device, pairs: int = 1 << 32):
    """Kernel 14's branch-free square root and division against the
    intrinsics it stands in for, on the card: (every float in [2^-100,
    2^100] through the root, ``pairs`` random pairs in [2^-60, 2^60] and
    every divisor mantissa in [1, 2) with 64 dividends each through the
    division) -> the three counts of results whose bits differ."""
    lib = _lib()
    bad = torch.zeros(3, dtype=torch.int64, device=device)
    err = lib.adam8bit_fast_path_check(pairs, bad.data_ptr(),
                                       _cuda.stream_ptr(bad.device))
    _cuda.check(lib, err, "adam8bit_fast_path_check")
    return [int(v) for v in bad.cpu()]


def _outputs(name, g2d, state, want):
    """Check the operands against ``want`` ((tensor, dtype, shape) each)
    and allocate the kernel's outputs, (update, *state) alike."""
    if g2d.dim() != 2 or any(
            t.dtype != dt or tuple(t.shape) != sh or not t.is_contiguous()
            or t.device != g2d.device or t.data_ptr() % 16
            for t, dt, sh in want):
        raise ValueError(
            f"{name} kernel: want contiguous, 16-byte aligned tensors on one "
            "device of " + ", ".join(f"{dt} {sh}" for _, dt, sh in want)
            + "; got " + ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device}"
                                   for t, _, _ in want))
    return (torch.empty_like(g2d),) + tuple(torch.empty_like(t)
                                            for t in state)


def fused_adam8bit_update(g2d, m_codes, m_scale, v_codes, v_scale,
                          bc1: float, bc2: float, *, b1: float, b2: float,
                          eps: float):
    """Kernel 13 (``_kernel``): one 8-bit Adam step of an unpacked leaf.
    g2d (nb, 256) f32 (the leaf flattened, zero-padded), m codes (nb, 256)
    int8, v codes (nb, 256) uint8, scales (nb,) f32; ``bc1``/``bc2`` are the
    f32 bias corrections.  Returns new tensors (update, m_codes, m_scale,
    v_codes, v_scale).  CPU tensors take
    :func:`fused_adam8bit_update_plain`."""
    state = (m_codes, m_scale, v_codes, v_scale)
    kw = dict(b1=b1, b2=b2, eps=eps)
    if g2d.device.type == "cpu":
        return fused_adam8bit_update_plain(g2d, *state, bc1, bc2, **kw)
    nb = g2d.shape[0]
    outs = _outputs("fused_adam8bit_update", g2d, state, [
        (g2d, torch.float32, (nb, BLOCK)), (m_codes, torch.int8, (nb, BLOCK)),
        (m_scale, torch.float32, (nb,)), (v_codes, torch.uint8, (nb, BLOCK)),
        (v_scale, torch.float32, (nb,))])
    lib = _lib()
    err = lib.adam8bit_unpacked(
        g2d.data_ptr(), *(t.data_ptr() for t in state),
        *(t.data_ptr() for t in outs), nb, *adam_constants(b1, b2, eps),
        float(bc1), float(bc2), _cuda.stream_ptr(g2d.device))
    _cuda.check(lib, err, "adam8bit_unpacked")
    fused_adam8bit_update.launches += 1
    return outs


fused_adam8bit_update.launches = 0


def fused_adam8bit_update_packed(g2d, m_words, m_scale, v_words, v_scale,
                                 bc1: float, bc2: float, *, b1: float,
                                 b2: float, eps: float):
    """Kernel 14 (``_packed_kernel``): one 8-bit Adam step of a packed
    leaf.  g2d (nb, 256) f32 with nb % 512 == 0, words (nb/4, 256) int32,
    scales (nb/64, 256) f32; ``bc1``/``bc2`` are the f32 bias corrections.
    Returns new tensors (update, m_words, m_scale, v_words, v_scale).  CPU
    tensors take :func:`fused_adam8bit_update_packed_plain`.  Launches are
    also tallied by nb in ``fused_adam8bit_update_packed.shape_launches``."""
    state = (m_words, m_scale, v_words, v_scale)
    kw = dict(b1=b1, b2=b2, eps=eps)
    if g2d.device.type == "cpu":
        return fused_adam8bit_update_packed_plain(g2d, *state, bc1, bc2, **kw)
    nb = g2d.shape[0]
    if not packable_rows(nb):
        raise ValueError(f"fused_adam8bit_update_packed kernel: nb={nb}, not "
                         f"a multiple of {TILE_ROWS}")
    outs = _outputs("fused_adam8bit_update_packed", g2d, state, [
        (g2d, torch.float32, (nb, BLOCK)),
        (m_words, torch.int32, (nb // 4, BLOCK)),
        (m_scale, torch.float32, (nb // 64, BLOCK)),
        (v_words, torch.int32, (nb // 4, BLOCK)),
        (v_scale, torch.float32, (nb // 64, BLOCK))])
    lib = _lib()
    err = lib.adam8bit_packed(
        g2d.data_ptr(), *(t.data_ptr() for t in state),
        *(t.data_ptr() for t in outs), nb, *adam_constants(b1, b2, eps),
        float(bc1), float(bc2), _cuda.stream_ptr(g2d.device))
    _cuda.check(lib, err, "adam8bit_packed")
    fused_adam8bit_update_packed.launches += 1
    fused_adam8bit_update_packed.shape_launches[nb] += 1
    return outs


fused_adam8bit_update_packed.launches = 0
fused_adam8bit_update_packed.shape_launches = Counter()   # by nb
