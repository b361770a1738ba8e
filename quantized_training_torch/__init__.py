"""quantized_training_torch: the PyTorch / CUDA port of quantized_training_tpu.

This package imports torch and never jax.  Its hot paths run hand-written
CUDA kernels for Hopper (``csrc/``, built with nvcc at first use into
``_build/``); every kernel has a plain PyTorch version that CPU tensors
take.  The entry points run on CUDA unless the caller asks for the CPU.

Ported so far: the LLaMA serving path -- w4a16 packed weight storage, the
int4 per-token-symmetric two-tier KV cache, flash prefill, fused int4
decode attention, ``generate`` and the continuous batching engine; and the
quantized forward of the fusion ladder -- bit-exact posit / FP8 / fpN / int
/ NF numerics, ``fake_quantize`` with every scheme, live quantization sites,
offline weight folding, flash attention with rounded probabilities and
output, the elementwise rounding and fused quantize-matmul kernels.
"""

from .convert import params_from_jax, random_params
from .models.llama import LlamaConfig, LlamaForCausalLM, fuse_qkv_params
from .qspec import QScheme, QuantizationSpec
from .numerics import quantize_fn
from .quantize import (FUSION_LADDER, OpCategory, QConfig, QuantConfig,
                       build_storage, fake_quantize, fold_quantized_weights,
                       strip_weight_specs)
from .serving.engine import ContinuousBatchingEngine, SamplingParams
from .serving.generate import generate
from .serving.kv_cache import KVCacheConfig

__all__ = [
    "ContinuousBatchingEngine", "FUSION_LADDER", "KVCacheConfig",
    "LlamaConfig", "LlamaForCausalLM", "OpCategory", "QConfig", "QScheme",
    "QuantConfig", "QuantizationSpec", "SamplingParams", "build_storage",
    "fake_quantize", "fold_quantized_weights", "fuse_qkv_params", "generate",
    "params_from_jax", "quantize_fn", "random_params", "strip_weight_specs",
]
