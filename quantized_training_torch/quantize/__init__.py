from .config import (FUSION_LADDER, OpCategory, QConfig, QuantConfig,
                     parse_op_categories)
from .fake_quant import FakeQuantState, fake_quantize, init_state
from .fold import fold_quantized_weights, strip_weight_specs
from .ops import calculate_mx_qparam, expand_scale
from .presets import QUANTIZATION_CONFIGS, build_preset
from .storage import build_storage

__all__ = ["FUSION_LADDER", "OpCategory", "QConfig", "QuantConfig",
           "QUANTIZATION_CONFIGS", "FakeQuantState", "build_preset",
           "build_storage", "calculate_mx_qparam", "expand_scale",
           "fake_quantize", "fold_quantized_weights", "init_state",
           "parse_op_categories", "strip_weight_specs"]
