"""LLM serving: the two-tier (quantized) KV cache, generation, speculative
decoding and the continuous batching engine."""

from .engine import ContinuousBatchingEngine, SamplingParams
from .generate import fast_argmax, generate
from .kv_cache import (FullPrecisionCache, KVCacheConfig, QuantizedKVCache,
                       append_to_cache, cache_kv, init_cache, pack_codes,
                       prefill_cache, residual_causal_mask, unpack_codes)
from .speculative import speculative_generate

__all__ = ["ContinuousBatchingEngine", "FullPrecisionCache", "KVCacheConfig",
           "QuantizedKVCache", "SamplingParams", "append_to_cache",
           "cache_kv", "fast_argmax", "generate", "init_cache", "pack_codes",
           "prefill_cache", "residual_causal_mask", "speculative_generate",
           "unpack_codes"]
