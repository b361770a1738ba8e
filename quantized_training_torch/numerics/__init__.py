"""Low-precision numerics.  This slice carries the block and bit helpers the
group-affine weight storage needs; the quantizers come with the numerics
port."""

from .bitutils import clamp_keep_zero_sign, materialize_rounding
from .mx import normalize_axes, reshape_to_blocks

__all__ = ["clamp_keep_zero_sign", "materialize_rounding", "normalize_axes",
           "reshape_to_blocks"]
