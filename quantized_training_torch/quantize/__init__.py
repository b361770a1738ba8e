from .config import (FUSION_LADDER, OpCategory, QConfig, QuantConfig,
                     parse_op_categories)
from .fake_quant import FakeQuantState, fake_quantize, init_state
from .fold import fold_quantized_weights, strip_weight_specs
from .gptq import (accumulate_gptq, build_storage_gptq, collect_hessians,
                   gptq_quantize, hessian_from_inputs)
from .ops import (calculate_mx_qparam, conv2d_mx, dequantize, expand_scale,
                  filter_outlier, linear_mx, matmul_mx, outlier_matmul,
                  quantize, quantize_mx, to_csr)
from .presets import QUANTIZATION_CONFIGS, build_preset
from .smooth import (awq_search_llama, calibrate_llama_amax, smooth_llama,
                     smoothing_scales)
from .storage import build_storage

__all__ = ["FUSION_LADDER", "OpCategory", "QConfig", "QuantConfig",
           "QUANTIZATION_CONFIGS", "FakeQuantState", "accumulate_gptq",
           "awq_search_llama", "build_preset", "build_storage",
           "build_storage_gptq", "calculate_mx_qparam",
           "calibrate_llama_amax", "collect_hessians", "conv2d_mx",
           "dequantize", "expand_scale", "fake_quantize", "filter_outlier",
           "fold_quantized_weights", "gptq_quantize", "hessian_from_inputs",
           "init_state", "linear_mx", "matmul_mx", "outlier_matmul",
           "parse_op_categories", "quantize", "quantize_mx", "smooth_llama",
           "smoothing_scales", "strip_weight_specs", "to_csr"]
