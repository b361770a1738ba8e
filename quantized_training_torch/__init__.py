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
output, the elementwise rounding and fused quantize-matmul kernels; and the
posit8 QAT train step -- the flash backward with its error taps, the train
step, losses and checkpoints, and 8-bit Adam with its fused packed kernel
(``training/``); and BERT fine-tuning -- the BERT family with LoRA
adapters, HF checkpoint conversion, the reference's command-line qspec
flags, and 8-bit Adam's unpacked kernel; and Phi-3 serving -- its
checkpoint conversion and the GQA forms (up to 8 query heads per kv head)
of both quantized-cache decode kernels; and speculative decoding over the
full-precision ring and the two-tier caches, with the GPTQ and
SmoothQuant/AWQ calibration that produces the served weights
(``quantize/gptq.py``, ``quantize/smooth.py``).
"""

from .cli import add_qspec_args, quant_config_from_args
from .convert import (adam8bit_state_from_jax, bert_random_params,
                      params_from_jax, random_params)
from .models import (BertConfig, BertForMaskedLM, BertForQuestionAnswering,
                     BertForSequenceClassification, BertModel, convert_bert,
                     convert_phi3)
from .models.llama import LlamaConfig, LlamaForCausalLM, fuse_qkv_params
from .qspec import QScheme, QuantizationSpec
from .numerics import quantize_fn
from .quantize import (FUSION_LADDER, OpCategory, QConfig, QuantConfig,
                       build_storage, fake_quantize, fold_quantized_weights,
                       strip_weight_specs)
from .serving.engine import ContinuousBatchingEngine, SamplingParams
from .serving.generate import generate
from .serving.kv_cache import KVCacheConfig
from .serving.speculative import speculative_generate

__all__ = [
    "BertConfig", "BertForMaskedLM", "BertForQuestionAnswering",
    "BertForSequenceClassification", "BertModel",
    "ContinuousBatchingEngine", "FUSION_LADDER", "KVCacheConfig",
    "adam8bit_state_from_jax", "add_qspec_args", "bert_random_params",
    "convert_bert", "convert_phi3", "quant_config_from_args",
    "LlamaConfig", "LlamaForCausalLM", "OpCategory", "QConfig", "QScheme",
    "QuantConfig", "QuantizationSpec", "SamplingParams", "build_storage",
    "fake_quantize", "fold_quantized_weights", "fuse_qkv_params", "generate",
    "params_from_jax", "quantize_fn", "random_params", "speculative_generate",
    "strip_weight_specs",
]
