"""Bit-level helpers shared by the numerics code.

Every low-precision format here (posit, FP8, fpN_eXmY) is defined by exact
bit manipulation of the IEEE-754 float32 image of the input.  Shift counts
that depend on the data are clamped into range, as in the reference
(reference: numerics/bitutils.py), so a lane whose true count is out of
range computes a defined value that later masks discard.  torch's ``>>`` on
int32 is arithmetic; a logical right shift is written as an arithmetic one
followed by a mask (:func:`lshr`).
"""

import torch

__all__ = ["F32_EXP_MASK", "F32_FRAC_MASK", "F32_EXP_BIAS",
           "materialize_rounding", "f32_bits", "bits_f32", "shl", "shr",
           "lshr", "mask_from_shift", "low_bits_mask", "keep_high_bits_mask",
           "signum_nonzero", "is_true_zero", "clamp_keep_zero_sign"]

F32_EXP_MASK = 0x7F800000
F32_FRAC_MASK = 0x007FFFFF
F32_EXP_BIAS = 127


def materialize_rounding(x: torch.Tensor) -> torch.Tensor:
    """Identity in eager PyTorch.

    Its counterpart exists because a fusing compiler may elide an
    f32->bf16->f32 convert chain inside a fused region, so a value that is
    nominally bf16 reaches a quantizer unrounded.  Eager PyTorch runs every
    op on its own and writes its result in the tensor's dtype, so the
    rounding has already happened; the call is kept so that the code reads
    like the reference at each quantizer boundary.
    """
    return x


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """The float32 image of ``x`` as int32 bits."""
    return x.to(torch.float32).view(torch.int32)


def bits_f32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits viewed as float32."""
    return bits.to(torch.int32).view(torch.float32)


def _clamp_count(count, max_count):
    if isinstance(count, int):
        return min(max(count, 0), max_count)
    return torch.clamp(count, 0, max_count)


def shl(x, count, max_count=31):
    """Left shift with the count clamped to [0, max_count]."""
    return torch.bitwise_left_shift(x, _clamp_count(count, max_count))


def shr(x, count, max_count=31):
    """Arithmetic right shift with the count clamped to [0, max_count]."""
    return torch.bitwise_right_shift(x, _clamp_count(count, max_count))


def lshr(x: torch.Tensor, count: int) -> torch.Tensor:
    """Logical right shift of int32 by a constant ``count`` in [1, 31]."""
    return (x >> count) & ((1 << (32 - count)) - 1)


def mask_from_shift(count, max_count=31):
    """``1 << count`` with a clamped count."""
    return shl(torch.ones_like(count), count, max_count)


def low_bits_mask(count, max_count=31):
    """``(1 << count) - 1`` with a clamped count."""
    return mask_from_shift(count, max_count) - 1


def keep_high_bits_mask(count, max_count=31):
    """``-1 << count``: clears the low ``count`` bits."""
    return shl(torch.full_like(count, -1), count, max_count)


def signum_nonzero(x: torch.Tensor) -> torch.Tensor:
    """+-1 by the sign bit (never 0), so a negative value that rounds to zero
    keeps its -0 through a multiplication."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(torch.signbit(x), -one, one)


def is_true_zero(x: torch.Tensor) -> torch.Tensor:
    """Exact +-0 test on the bit pattern (subnormals are not zero)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return (x.view(torch.int16) & 0x7FFF) == 0
    return (f32_bits(x) & 0x7FFFFFFF) == 0


def clamp_keep_zero_sign(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """torch.clamp semantics spelled with ``where``: lanes already inside
    [lo, hi] are untouched, so a -0 with lo <= 0 keeps its sign bit."""
    lo_t = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.where(x < lo_t, lo_t, torch.where(x > hi_t, hi_t, x))
