"""Low-precision numerics: bit-exact posit, FP8 / fpN, int and NF rounding
on the float32 image of the input, the MX block helpers, and the dtype
dispatch (``quantize_fn``) that sends CUDA tensors to the rounding kernel.
"""

from .bitutils import clamp_keep_zero_sign, materialize_rounding
from .fp8 import (fp_max_norm, parse_fp_dtype, quantize_elemwise,
                  quantize_to_fp, quantize_to_fp8_e4m3, quantize_to_fp8_e5m2)
from .integer import int_range, quantize_to_int
from .lut import (QuantFn, RoundFormat, apply_lut, bf16_universe,
                  dequantize_nf, get_quantization_map, lut_indices,
                  quantize_fn, quantize_fn_positive, quantize_fn_unit)
from .mx import (normalize_axes, reshape_to_blocks, shared_exponents,
                 undo_reshape_to_blocks)
from .normal_float import create_normal_map, nf_codebook, quantize_to_nf
from .posit import (decode_posit, encode_posit, posit_max_value,
                    quantize_to_posit, quantize_to_posit_fast)

__all__ = [
    "QuantFn", "RoundFormat", "apply_lut", "bf16_universe",
    "clamp_keep_zero_sign", "create_normal_map", "decode_posit",
    "dequantize_nf", "encode_posit", "fp_max_norm", "get_quantization_map",
    "int_range", "lut_indices", "materialize_rounding", "nf_codebook",
    "normalize_axes", "parse_fp_dtype", "posit_max_value", "quantize_elemwise",
    "quantize_fn", "quantize_fn_positive", "quantize_fn_unit",
    "quantize_to_fp", "quantize_to_fp8_e4m3", "quantize_to_fp8_e5m2",
    "quantize_to_int", "quantize_to_nf", "quantize_to_posit",
    "quantize_to_posit_fast",
    "reshape_to_blocks", "shared_exponents", "undo_reshape_to_blocks",
]
