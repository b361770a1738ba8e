"""Bit-exact FP8 (E4M3 / E5M2) and generic fpN_eXmY quantizers.

The same numerics as the reference package (reference: numerics/fp8.py).
The FP8 forms round the float32 bit pattern with guard/sticky round to
nearest even and saturate to the format's max normal.  The generic form
scales the mantissa into the integer range, rounds there and scales back,
with every operation in the *input* dtype, so that bf16 inputs reproduce
the reference's bf16 lookup tables bit for bit.  ``torch.float8_*`` casts
are not used: their saturation and subnormal rules differ.
"""

import math
import re
from typing import Optional, Tuple

import torch

from .bitutils import (F32_EXP_MASK, F32_FRAC_MASK, bits_f32,
                       clamp_keep_zero_sign, f32_bits, is_true_zero,
                       keep_high_bits_mask, low_bits_mask, mask_from_shift,
                       signum_nonzero)

__all__ = ["quantize_to_fp8_e4m3", "quantize_to_fp8_e5m2",
           "quantize_elemwise", "quantize_to_fp", "parse_fp_dtype",
           "fp_max_norm"]


def _quantize_fp8(x: torch.Tensor, mbits: int, fp8_max: float,
                  fp8_min: float) -> torch.Tensor:
    """Shared E4M3/E5M2 form: truncate + round to nearest even on the
    float32 bits, saturate."""
    xf = x.to(torch.float32)
    raw_bits = f32_bits(xf)
    exp = ((raw_bits & F32_EXP_MASK) >> 23) - 127
    fraction = (raw_bits & F32_FRAC_MASK) | 0x800000

    min_exp = math.floor(math.log2(fp8_min))
    nf_shift = 23 - mbits + torch.clamp(min_exp - exp, min=0)

    lb = (fraction & mask_from_shift(nf_shift)) != 0
    gb = (fraction & mask_from_shift(nf_shift - 1)) != 0
    sb = (fraction & low_bits_mask(nf_shift - 1)) != 0
    rb = (lb & gb) | (gb & sb)

    nf_clamped = torch.clamp(nf_shift, max=23)
    out_bits = raw_bits & keep_high_bits_mask(nf_clamped, 23)
    out_bits = torch.where(rb, out_bits + mask_from_shift(nf_clamped, 23),
                           out_bits)

    out = torch.clamp(bits_f32(out_bits), -fp8_max, fp8_max)
    out = torch.where(xf.abs() <= fp8_min * (2.0 ** -(mbits + 1)), 0.0, out)
    out = torch.where(xf == 0.0, 0.0, out)
    out = torch.where(torch.isfinite(xf), out, float("nan"))
    return out.to(x.dtype)


def quantize_to_fp8_e4m3(x: torch.Tensor, mbits: int = 3,
                         fp8_max: float = 448.0,
                         fp8_min: float = 2.0 ** -6) -> torch.Tensor:
    """NVIDIA-style FP8 E4M3 (max 448, min normal 2^-6)."""
    return _quantize_fp8(x, mbits, fp8_max, fp8_min)


def quantize_to_fp8_e5m2(x: torch.Tensor, mbits: int = 2,
                         fp8_max: float = 57344.0,
                         fp8_min: float = 2.0 ** -14) -> torch.Tensor:
    """IEEE-style FP8 E5M2 (max 57344, min normal 2^-14)."""
    return _quantize_fp8(x, mbits, fp8_max, fp8_min)


def _round_mantissa(a: torch.Tensor, mode: str,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round a mantissa scaled into the integer range, in ``a.dtype``.
    ``dither`` is floor(|a| + U[0,1)) with the uniform noise given by the
    caller (the reference draws it from a PRNG key)."""
    sgn = signum_nonzero(a)
    if mode == "dither":
        if noise is None:
            raise ValueError("round_mode='dither' needs a noise tensor")
        return sgn * torch.floor(a.abs() + noise.to(a.dtype))
    if mode == "floor":
        return sgn * torch.floor(a.abs())
    if mode == "nearest":
        return sgn * torch.floor(a.abs() + 0.5)
    if mode == "even":
        abs_a = a.abs()
        is_odd_up = (torch.remainder(abs_a - 0.5, 2.0) == 0.0).to(a.dtype)
        return sgn * (torch.floor(abs_a + 0.5) - is_odd_up)
    raise ValueError(f"Unrecognized round method {mode}")


def _pow2(e: torch.Tensor, dtype) -> torch.Tensor:
    """Exact 2**e for integer-valued e in [-126, 128] (float32 bits)."""
    bits = torch.clamp(e.to(torch.int32) + 127, 0, 255) << 23
    return bits_f32(bits).to(dtype)


def _floor_log2(a: torch.Tensor) -> torch.Tensor:
    """floor(log2|a|) as the reference computes it: log2 in float32, the
    result rounded to ``a.dtype``, then floored.  For bf16 inputs just below
    a large power of two the rounding lifts the exponent by one; the
    exhaustive tests pin that."""
    lg = torch.log2(a.abs().to(torch.float32))
    return torch.floor(lg.to(a.dtype).to(torch.float32)).to(a.dtype)


def quantize_elemwise(a: torch.Tensor, bits: int, exp_bits: int,
                      max_norm: float, round_mode: str = "nearest",
                      saturate_normals: bool = False,
                      allow_denorm: bool = True,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize to a float format with ``exp_bits`` exponent and ``bits``
    mantissa bits (sign and implicit one included), every operation in
    ``a.dtype``."""
    out = a
    if not allow_denorm and exp_bits > 0:
        min_norm = 2.0 ** (2 - 2 ** (exp_bits - 1))
        out = (a.abs() >= min_norm).to(a.dtype) * a

    if exp_bits != 0:
        private_exp = _floor_log2(torch.where(a == 0, torch.ones_like(a), a))
        min_exp = -(2 ** (exp_bits - 1)) + 2
        private_exp = torch.clamp(private_exp, min=min_exp)
        pow2_exp = _pow2(private_exp, a.dtype)
        out = out / pow2_exp * (2.0 ** (bits - 2))
    else:
        pow2_exp = None
        out = out * (2.0 ** (bits - 2))

    out = _round_mantissa(out, round_mode, noise)

    if pow2_exp is None:
        out = out / (2.0 ** (bits - 2))
    else:
        out = out / (2.0 ** (bits - 2)) * pow2_exp

    if saturate_normals or exp_bits == 0:
        out = clamp_keep_zero_sign(out, -max_norm, max_norm)
    else:
        out = torch.where(out.abs() > max_norm, torch.sign(out) * math.inf,
                          out)

    out = torch.where(is_true_zero(a), torch.zeros_like(out), out)
    out = torch.where(torch.isposinf(a), math.inf, out)
    out = torch.where(torch.isneginf(a), -math.inf, out)
    out = torch.where(torch.isnan(a), math.nan, out)
    return out.to(a.dtype)


_FP_RE = re.compile(r"fp(\d+)_e(\d+)m(\d+)")


def parse_fp_dtype(dtype: str) -> Tuple[int, int, int]:
    """``fpN_eXmY`` -> (nbits, ebits, mbits); nbits == ebits + mbits is an
    unsigned (scale) format."""
    match = _FP_RE.fullmatch(dtype)
    if match is None:
        raise ValueError(f"String {dtype!r} does not match fpN_eXmY")
    nbits, ebits, mbits = map(int, match.groups())
    if nbits not in (ebits + mbits, ebits + mbits + 1):
        raise ValueError(f"Inconsistent fp dtype spec: {dtype}")
    return nbits, ebits, mbits


def fp_max_norm(dtype: str) -> float:
    """Largest magnitude of an fpN_eXmY format (formats with fewer than 5
    exponent bits reclaim the special values; fp8_e4m3 is NVIDIA's 448)."""
    _, ebits, mbits = parse_fp_dtype(dtype)
    mbits = mbits + 2
    emax = 2 ** (ebits - 1) - 1 if ebits > 4 else 2 ** (ebits - 1)
    if dtype == "fp8_e4m3":
        return 2.0 ** emax * 1.75
    return 2.0 ** emax * float(2 ** (mbits - 1) - 1) / 2 ** (mbits - 2)


def quantize_to_fp(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """Round to an ``fpN_eXmY`` format, round to even, saturating."""
    nbits, ebits, mbits = parse_fp_dtype(dtype)
    if nbits == ebits + mbits:
        x = x.abs()
    return quantize_elemwise(x, mbits + 2, ebits, fp_max_norm(dtype),
                             round_mode="even", saturate_normals=True)
