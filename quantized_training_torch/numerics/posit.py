"""Bit-exact posit(nbits, es) rounding of float tensors.

The same numerics as the reference package's posit quantizers (reference:
numerics/posit.py): the float32 bit pattern is split into regime, exponent
and fraction, truncated to the posit precision of its regime and rounded to
nearest even.  Results are returned in the input dtype ("fake
quantization": float values that are exactly posits).

:func:`quantize_to_posit_fast` is the production form and the one the CUDA
kernels run (``csrc/qt_round.cuh``).  The reference also keeps positive,
unit-interval and multiplication forms, written for its vector unit's speed;
they are bit-identical to the fast form on their domains, so the port has
only the fast form and the field-by-field one (:func:`quantize_to_posit`,
which also yields the posit codes).
"""

import math

import torch

from .bitutils import (F32_EXP_MASK, F32_FRAC_MASK, bits_f32, f32_bits,
                       keep_high_bits_mask, lshr, mask_from_shift, shl)

__all__ = ["quantize_to_posit", "quantize_to_posit_fast", "decode_posit",
           "encode_posit", "posit_max_value"]

_SIGN_BIT = -2147483648


def posit_max_value(nbits: int, es: int) -> float:
    """Largest posit magnitude: useed**(nbits-2)."""
    return float((2 ** (2 ** es)) ** (nbits - 2))


def _zero_threshold(nbits: int, es: int) -> float:
    """Below this magnitude the nearest-even posit is zero."""
    return math.pow(2.0, math.floor(-(nbits - 1) * (1 << es) + 2 ** (es - 1)))


def quantize_to_posit(x: torch.Tensor, nbits: int = 8, es: int = 1,
                      round_to_even: bool = True,
                      return_pbits: bool = False):
    """Round ``x`` to the nearest posit(nbits, es), written the way the
    reference framework writes it (fields, guard and sticky bits).  With
    ``return_pbits`` also return the signed raw posit bits (int32)."""
    xf = x.to(torch.float32)
    raw_bits = f32_bits(xf)
    scale = ((raw_bits & F32_EXP_MASK) >> 23) - 127
    fraction = raw_bits & F32_FRAC_MASK
    positive_scale = scale >= 0

    max_scale = (nbits - 2) * (1 << es)
    regime_dominated = (positive_scale & (scale > max_scale)) | (
        ~positive_scale & (scale < -max_scale))

    run = torch.where(positive_scale, 1 + (scale >> es), -(scale >> es))
    regime = torch.where(positive_scale, mask_from_shift(run + 1, 30) - 1,
                         torch.zeros_like(run)) ^ 1
    exponent = torch.remainder(scale, 1 << es)
    pt_bits = shl(regime, 23 + es, 31) | shl(exponent, 23, 31) | fraction

    total_len = 2 + run + es + 23
    lb_mask = mask_from_shift(total_len - nbits)
    gb_mask = lb_mask >> 1
    sb_mask = gb_mask - 1

    lb = (pt_bits & lb_mask) != 0
    gb = (pt_bits & gb_mask) != 0
    sb = (pt_bits & sb_mask) != 0
    rb = ((lb & gb) | (gb & sb)) & ~regime_dominated

    ne_mask = torch.clamp(2 + run + es - nbits, 0, es)
    scale_t = scale & keep_high_bits_mask(ne_mask, es if es > 0 else 31)
    scale_t = torch.clamp(scale_t, -max_scale, max_scale)

    nf_mask = torch.clamp(total_len - nbits, 0, 23)
    fraction_t = fraction & keep_high_bits_mask(nf_mask, 23)

    out_bits = ((scale_t + 127) << 23) | fraction_t
    out_bits = torch.where(rb, out_bits + mask_from_shift(nf_mask + ne_mask),
                           out_bits)
    out = bits_f32(out_bits) * torch.sign(xf)

    if round_to_even:
        out = torch.where(xf.abs() < _zero_threshold(nbits, es), 0.0, out)
    out = torch.where(xf == 0.0, 0.0, out)
    out = torch.where(torch.isfinite(xf), out, float("nan"))
    out = out.to(x.dtype)

    if return_pbits:
        pbits = pt_bits >> torch.clamp(total_len - nbits, 0, 31)
        pbits = pbits & ((1 << (nbits - 1)) - 1)
        pbits = torch.where(rb, pbits + 1, pbits)
        sign = torch.sign(xf)
        sign = torch.where(torch.isnan(sign), 0.0, sign).to(torch.int32)
        return out, pbits * sign
    return out


def quantize_to_posit_fast(x: torch.Tensor, nbits: int = 8,
                           es: int = 1) -> torch.Tensor:
    """Production posit rounding: one variable shift builds the rounding
    quantum, integer round to nearest even on the magnitude's float32 bits,
    the sign bit re-attached; non-finite lanes become NaN."""
    max_scale = (nbits - 2) * (1 << es)
    maxpos, minpos = 2.0 ** max_scale, 2.0 ** -max_scale

    xf0 = x.to(torch.float32)
    sign_bit = f32_bits(xf0) & _SIGN_BIT
    bits = f32_bits(torch.clamp(xf0.abs(), minpos, maxpos))
    e = (bits >> 23) - 127

    run = torch.where(e >= 0, 1 + (e >> es), -(e >> es))
    s2 = torch.clamp(run + es + 25 - nbits, 0, 23 + es)
    q = torch.bitwise_left_shift(torch.ones_like(bits), s2)
    q_mask = q - 1
    r = (127 << 23) & q_mask
    m = bits - r
    lsb = torch.where(s2 >= 23 + es, (e < 0).to(torch.int32),
                      (((bits - (127 << 23)) & q) != 0).to(torch.int32))
    rounded = (m + (q >> 1) - 1 + lsb) & ~q_mask
    out = torch.clamp(bits_f32(rounded + r), max=maxpos)
    out = bits_f32(f32_bits(out) | sign_bit)
    out = torch.where(xf0.abs() < _zero_threshold(nbits, es), 0.0, out)
    out = torch.where(torch.isfinite(xf0), out, float("nan"))
    return out.to(x.dtype)


def _clz(u: torch.Tensor) -> torch.Tensor:
    """Count of leading zeros of non-negative int32 values (32 for 0)."""
    _, exp = torch.frexp(u.to(torch.float64))
    return torch.where(u == 0, 32, 32 - exp.to(torch.int32))


def decode_posit(codes: torch.Tensor, nbits: int = 8,
                 es: int = 1) -> torch.Tensor:
    """Decode two's-complement posit codes to float32; 0 -> 0 and the NaR
    pattern -> NaN."""
    c = codes.to(torch.int32)
    width_mask = (1 << nbits) - 1
    c = c & width_mask
    nar = 1 << (nbits - 1)

    sign = c >= nar
    mag = torch.where(sign, (nar * 2 - c) & width_mask, c)
    u = torch.bitwise_left_shift(mag, 32 - nbits) & 0x7FFFFFFF

    top_one = (u & 0x40000000) != 0
    ones_run = _clz(~u & 0x7FFFFFFF) - 1
    zeros_run = _clz(u | 1) - 1
    run = torch.where(top_one, ones_run, zeros_run)
    scale_regime = torch.where(top_one, (run - 1) << es, -run << es)

    tail = torch.bitwise_left_shift(u, run + 2)
    exp = lshr(tail, 32 - es) & ((1 << es) - 1) if es > 0 else 0
    scale = scale_regime + exp
    frac23 = (torch.bitwise_left_shift(tail, es) >> 9) & 0x7FFFFF

    out = bits_f32(((scale + 127) << 23) | frac23)
    out = torch.where(sign, -out, out)
    out = torch.where(mag == 0, 0.0, out)
    return torch.where(c == nar, float("nan"), out)


def encode_posit(x: torch.Tensor, nbits: int = 8,
                 es: int = 1) -> torch.Tensor:
    """Quantize and return the signed posit codes (int32).  The bits are
    read from the already-rounded values, which are never regime-dominated;
    NaN maps to NaR."""
    vals = quantize_to_posit(x, nbits, es, round_to_even=True)
    _, pbits = quantize_to_posit(vals, nbits, es, round_to_even=False,
                                 return_pbits=True)
    nar = -(1 << (nbits - 1))
    return torch.where(torch.isnan(vals.to(torch.float32)), nar, pbits)
