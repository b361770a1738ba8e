from .config import (FUSION_LADDER, OpCategory, QConfig, QuantConfig,
                     parse_op_categories)
from .fake_quant import fake_quantize
from .ops import expand_scale
from .storage import build_storage

__all__ = ["FUSION_LADDER", "OpCategory", "QConfig", "QuantConfig",
           "parse_op_categories", "fake_quantize", "expand_scale",
           "build_storage"]
