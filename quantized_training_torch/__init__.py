"""quantized_training_torch: the PyTorch / CUDA port of quantized_training_tpu.

This package imports torch and never jax.  Its hot paths run hand-written
CUDA kernels for Hopper (``csrc/``, built with nvcc at first use into
``_build/``); every kernel has a plain PyTorch version that CPU tensors
take.  The entry points run on CUDA unless the caller asks for the CPU.

Ported so far: the LLaMA serving path -- w4a16 packed weight storage, the
int4 per-token-symmetric two-tier KV cache, flash prefill, fused int4
decode attention, ``generate`` and the continuous batching engine.
"""

from .convert import params_from_jax, random_params
from .models.llama import LlamaConfig, LlamaForCausalLM, fuse_qkv_params
from .qspec import QScheme, QuantizationSpec
from .quantize import OpCategory, QConfig, QuantConfig, build_storage
from .serving.engine import ContinuousBatchingEngine, SamplingParams
from .serving.generate import generate
from .serving.kv_cache import KVCacheConfig

__all__ = [
    "ContinuousBatchingEngine", "KVCacheConfig", "LlamaConfig",
    "LlamaForCausalLM", "OpCategory", "QConfig", "QScheme", "QuantConfig",
    "QuantizationSpec", "SamplingParams", "build_storage", "fuse_qkv_params",
    "generate", "params_from_jax", "random_params",
]
