"""Autoregressive generation: prefill + a host loop of decode steps over the
quantized KV cache (reference: llm_utils.py:43-112 and the KIVI-cache
generate at llm_utils.py:501-596).

Prefill runs the model over the prompt and quantizes its K/V into the main
tier; each decode step appends one token to the bf16 residual ring.
Sampling supports greedy, temperature, top-k and top-p (nucleus), drawing
from an explicit ``torch.Generator``.
"""

from typing import Optional

import torch

__all__ = ["generate", "fast_argmax", "sample_batch"]


def fast_argmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """First index of the maximum (max + masked index-min); a row holding
    NaN returns its first NaN."""
    m = logits.amax(dim=dim, keepdim=True)
    shape = [1] * logits.dim()
    shape[dim] = logits.shape[dim]
    idx = torch.arange(logits.shape[dim], device=logits.device).reshape(shape)
    hit = (logits == m) | torch.isnan(logits)
    big = torch.iinfo(torch.int64).max
    return torch.where(hit, idx, big).amin(dim=dim)


def _categorical(logits: torch.Tensor, generator) -> torch.Tensor:
    """One draw per row from softmax(logits) (-inf entries never drawn)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sample(logits, generator, temperature: float, top_k: Optional[int],
            top_p: Optional[float] = None) -> torch.Tensor:
    """Greedy (temperature 0) / temperature / top-k / top-p sampling; the
    filters compose HF-style: top-k first, then nucleus within the
    survivors."""
    if temperature == 0.0:
        return fast_argmax(logits, dim=-1)
    logits = logits / temperature
    neg_inf = torch.full_like(logits, float("-inf"))
    if top_k is not None:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff, neg_inf, logits)
    if top_p is not None and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose cumulative mass *before* them is < top_p, so the
        # most probable token always survives
        keep = (cum - probs) < top_p
        kth = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                          ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < kth, neg_inf, logits)
    return _categorical(logits, generator)


def sample_batch(logits, generator, temperature, top_k, top_p,
                 max_top_k: int = 64) -> torch.Tensor:
    """Per-row sampling for the batched engine (per-request params).

    ``temperature`` (B,) f32, 0 selects greedy for that row; ``top_k`` (B,)
    int, 0 disables; ``top_p`` (B,) f32, 1.0 disables.  Non-greedy rows
    sample within the top-``max_top_k`` candidates (top-k prunes first,
    nucleus within the survivors).
    """
    B, V = logits.shape
    K = min(max_top_k, V)
    vals, idx = torch.topk(logits.to(torch.float32), K, dim=-1)
    t = torch.clamp_min(temperature[:, None].to(torch.float32), 1e-6)
    v = vals / t
    rank = torch.arange(K, device=logits.device)[None, :]
    keff = torch.where(top_k > 0, torch.clamp_max(top_k, K), K)[:, None]
    neg_inf = torch.full_like(v, float("-inf"))
    v = torch.where(rank < keff, v, neg_inf)
    probs = torch.softmax(v, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = ((cum - probs) < top_p[:, None]) & (rank < keff)
    v = torch.where(keep, v, neg_inf)
    choice = _categorical(v, generator)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    greedy = fast_argmax(logits, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


@torch.no_grad()
def generate(model, input_ids: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations for ``input_ids`` (B, S);
    returns (B, S + max_new_tokens) on the model's device (CUDA unless the
    model was built on the CPU).

    The prompt is quantized into the cache's main tier with its true length
    S, new tokens go to the residual ring; one host dispatch per token.
    """
    device = model.device
    input_ids = input_ids.to(device)
    B, S = input_ids.shape
    kcfg = model.config.kv_cache
    if kcfg is None:
        raise NotImplementedError(
            "generate needs a quantized KV cache config; the full-precision "
            "cache is not ported yet")
    if max_new_tokens > kcfg.max_decode:
        raise ValueError(f"max_new_tokens={max_new_tokens} exceeds the "
                         f"residual ring (max_decode={kcfg.max_decode})")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    logits, caches = model(input_ids, use_cache=True, prompt_len=S,
                           last_logit_only=True)
    tokens = [_sample(logits[:, -1], generator, temperature, top_k, top_p)]
    for step in range(max_new_tokens - 1):
        logits, caches = model(tokens[-1][:, None], use_cache=True,
                               caches=caches, cache_index=S + step)
        tokens.append(_sample(logits[:, -1], generator, temperature, top_k,
                              top_p))
    gen = torch.stack(tokens, dim=1).to(input_ids.dtype)
    if eos_token_id is not None:
        # everything after the first EOS of a row becomes EOS
        is_eos = gen == eos_token_id
        seen = torch.cumsum(is_eos.to(torch.int32), dim=1)
        keep = (seen - is_eos.to(torch.int32)) == 0
        gen = torch.where(keep, gen, torch.full_like(gen, eos_token_id))
    return torch.cat([input_ids, gen], dim=1)
