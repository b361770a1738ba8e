"""Two-tier quantized KV cache: a quantized main tier filled at prefill plus
a bf16 residual ring for decode tokens (reference: llm_utils.py:295-499,
the KIVI attention at llm_utils.py:115-243).

This slice ports the **per-token symmetric** int4 main tier
(``KVCacheConfig.int_sym``): one f32 scale per (batch, kv head, token) for
K and V, codes stored token-planar packed in int32 words (see
:func:`pack_tokens_planar`).  The KIVI group-affine tiers and the
full-precision cache come later and raise.

Storage layout is head-major, (B, KV, T, D); model code speaks
(B, S, KV, D) and the wrappers transpose at the boundary.  Lengths are
int32 tensors: 0-d for a cache whose rows move in lockstep (``generate``),
(B,) per slot for continuous batching.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ..qspec import QuantizationSpec

__all__ = ["KVCacheConfig", "QuantizedKVCache", "init_cache", "prefill_cache",
           "append_to_cache", "append_per_slot", "cache_kv", "per_slot_mask",
           "pack_tokens_planar", "unpack_tokens_planar"]

MASK_VALUE = float(torch.finfo(torch.bfloat16).min)


class KVCacheConfig(NamedTuple):
    """Static cache geometry + main-tier format.

    ``sym_bits`` 4 selects the per-token symmetric int4 main tier (with
    ``pack=True``: token-planar int32 words).  ``k_spec``/``v_spec`` (the
    KIVI group-affine tiers) are kept for the config's shape and are not
    ported yet.
    """

    max_prefill: int
    max_decode: int
    k_spec: Optional[QuantizationSpec] = None
    v_spec: Optional[QuantizationSpec] = None
    pack: bool = False
    sym_bits: Optional[int] = None

    @staticmethod
    def int_sym(max_prefill: int, max_decode: int, bits: int = 4):
        """Per-token symmetric two-tier cache (int4 in this slice)."""
        if bits not in (4, 8):
            raise ValueError(f"int_sym bits must be 4 or 8, got {bits}")
        return KVCacheConfig(max_prefill, max_decode, None, None,
                             pack=(bits == 4), sym_bits=bits)


def _check_ported(cfg: KVCacheConfig) -> None:
    if cfg.sym_bits != 4 or cfg.k_spec is not None or cfg.v_spec is not None:
        raise NotImplementedError(
            "only the int4 per-token symmetric cache (KVCacheConfig.int_sym("
            "..., bits=4)) is ported; the int8, KIVI and full-precision "
            "caches come later (ROADMAP A8)")


class QuantizedKVCache(NamedTuple):
    """Per-layer cache state."""

    k_codes: torch.Tensor    # (B, KV, P//8, D) int32, token-planar int4
    k_scale: torch.Tensor    # (B, KV, 1, P) f32
    v_codes: torch.Tensor
    v_scale: torch.Tensor
    k_res: torch.Tensor      # (B, KV, R, D) residual, bf16
    v_res: torch.Tensor
    main_len: torch.Tensor   # int32: valid tokens in the quantized tier
    res_len: torch.Tensor    # int32: valid tokens in the residual ring


def _to_cache_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, S, KV, D) model layout -> (B, KV, S, D) cache layout."""
    return x.transpose(1, 2)


def _to_model_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, KV, S, D) cache layout -> (B, S, KV, D) model layout."""
    return x.transpose(1, 2)


def _quantize_sym_per_token(x: torch.Tensor, bits: int):
    """(B, KV, T, D) -> (codes, scale).  Scale is (B, KV, 1, T) f32, one
    scalar per token; codes are token-planar packed int32 words
    (B, KV, T//8, D) holding 4-bit two's-complement codes (the +8 offset
    makes pack_tokens_planar store the signed code's raw field, so a
    shl/asr unpack sign-extends straight to the code)."""
    assert bits == 4, bits
    qmax = 7
    xf = x.to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(dim=-1), 1e-30)        # (B, KV, T)
    sf = amax / qmax
    codes = torch.clamp(torch.round(xf / sf[..., None]), -qmax, qmax)
    codes = pack_tokens_planar(codes.to(torch.int32) + 8, 4)
    return codes, sf[:, :, None, :].contiguous()


def _dequantize_sym_per_token(codes, scale, bits: int, dtype):
    assert bits == 4, bits
    c = unpack_tokens_planar(codes, 4).to(torch.int32) - 8
    sf_t = scale.to(torch.float32)[:, :, 0, :, None]             # (B,KV,T,1)
    return (c.to(torch.float32) * sf_t).to(dtype)


def init_cache(cfg: KVCacheConfig, batch: int, kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, *, device) -> QuantizedKVCache:
    """An empty cache with 0-d lengths."""
    _check_ported(cfg)
    P, R = cfg.max_prefill, cfg.max_decode
    if P % 8:
        raise ValueError(f"max_prefill={P} must be a multiple of 8 (eight "
                         "int4 tokens share a word)")
    cshape = (batch, kv_heads, P // 8, head_dim)
    sshape = (batch, kv_heads, 1, P)
    rshape = (batch, kv_heads, R, head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return QuantizedKVCache(
        torch.zeros(cshape, **i32),
        torch.ones(sshape, dtype=torch.float32, device=device),
        torch.zeros(cshape, **i32),
        torch.ones(sshape, dtype=torch.float32, device=device),
        k_res=torch.zeros(rshape, dtype=dtype, device=device),
        v_res=torch.zeros(rshape, dtype=dtype, device=device),
        main_len=torch.zeros((), **i32),
        res_len=torch.zeros((), **i32),
    )


def prefill_cache(cache: QuantizedKVCache, cfg: KVCacheConfig,
                  k: torch.Tensor, v: torch.Tensor,
                  length=None) -> QuantizedKVCache:
    """Quantize the prefill K/V (B, S, KV, D) into the main tier.

    Shorter prefills pad with zeros to ``max_prefill``; ``length`` (int or
    0-d tensor, default S) also zeroes K/V at positions >= length, so a
    padded fixed-shape prefill stores the same cache content as a
    true-length one.  The residual ring is emptied (``res_len`` 0).
    """
    _check_ported(cfg)
    B, S, KV, D = k.shape
    P = cfg.max_prefill
    if S > P:
        raise ValueError(f"prefill of {S} tokens exceeds max_prefill={P}")
    k = _to_cache_layout(k)                      # (B, KV, S, D)
    v = _to_cache_layout(v)
    if S < P:
        pad = (0, 0, 0, P - S)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    device = k.device
    if length is None:
        main_len = torch.tensor(S, dtype=torch.int32, device=device)
    else:
        main_len = torch.as_tensor(length, dtype=torch.int32).to(device)
        keep = (torch.arange(P, device=device)[None, None, :, None]
                < main_len)
        k = torch.where(keep, k, torch.zeros((), dtype=k.dtype, device=device))
        v = torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=device))
    k_codes, k_scale = _quantize_sym_per_token(k, cfg.sym_bits)
    v_codes, v_scale = _quantize_sym_per_token(v, cfg.sym_bits)
    return cache._replace(
        k_codes=k_codes, k_scale=k_scale, v_codes=v_codes, v_scale=v_scale,
        main_len=main_len,
        res_len=torch.zeros((), dtype=torch.int32, device=device),
    )


def append_to_cache(cache: QuantizedKVCache, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> QuantizedKVCache:
    """Append decode-step K/V (B, n, KV, D) at the shared residual index
    (0-d ``res_len``), writing the ring **in place**.  Like a dynamic
    update slice, the start index is clamped so that the n rows fit."""
    n = k_new.shape[1]
    R = cache.k_res.shape[2]
    start = cache.res_len.clamp(0, R - n)
    idx = start + torch.arange(n, device=start.device)
    for buf, new in ((cache.k_res, k_new), (cache.v_res, v_new)):
        buf.index_copy_(2, idx, _to_cache_layout(new).to(buf.dtype))
    return cache._replace(res_len=cache.res_len + n)


def append_per_slot(cache: QuantizedKVCache, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> QuantizedKVCache:
    """Append one decode token per slot at each slot's own residual index,
    writing the ring **in place**.  k_new/v_new: (B, 1, KV, D); res_len:
    (B,).  A slot whose ring is full (res_len >= R) is left unwritten."""
    B = k_new.shape[0]
    R = cache.k_res.shape[2]
    rows = torch.arange(B, device=k_new.device)
    idx = cache.res_len.clamp(0, R - 1).long()
    full = (cache.res_len >= R)[:, None, None]
    for buf, new in ((cache.k_res, k_new), (cache.v_res, v_new)):
        cur = buf[rows, :, idx]                          # (B, KV, D)
        buf[rows, :, idx] = torch.where(full, cur, new[:, 0].to(buf.dtype))
    return cache._replace(res_len=cache.res_len + 1)


def cache_kv(cache: QuantizedKVCache, cfg: KVCacheConfig,
             dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialized (K, V) = [dequant(main); residual], each
    (B, max_prefill + max_decode, KV, D); invalid slots must be masked by
    the caller (see per_slot_mask)."""
    _check_ported(cfg)
    k_main = _dequantize_sym_per_token(cache.k_codes, cache.k_scale,
                                       cfg.sym_bits, dtype)
    v_main = _dequantize_sym_per_token(cache.v_codes, cache.v_scale,
                                       cfg.sym_bits, dtype)
    k = torch.cat([k_main, cache.k_res.to(dtype)], dim=2)
    v = torch.cat([v_main, cache.v_res.to(dtype)], dim=2)
    return _to_model_layout(k), _to_model_layout(v)


def per_slot_mask(cfg: KVCacheConfig, main_len: torch.Tensor,
                  res_len: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Additive decode mask (B, 1, 1, P+R) from per-slot lengths: main slots
    < main_len[b] visible; residual slots <= res_len[b] visible (the current
    token was just appended at index res_len[b])."""
    P, R = cfg.max_prefill, cfg.max_decode
    kv_pos = torch.arange(P + R, device=main_len.device)[None, :]
    in_main = kv_pos < main_len[:, None]
    in_res = (kv_pos >= P) & ((kv_pos - P) <= res_len[:, None])
    mask = torch.where(in_main | in_res, 0.0, MASK_VALUE).to(dtype)
    return mask[:, None, None, :]


# ---------------------------------------------------------------------------
# Token-planar packing: the serving cache layout
# ---------------------------------------------------------------------------
#
# Codes (..., P, D) pack along the *token* axis into (..., P//per, D) int32
# words with per = 32//bits: word[..., t', d] holds the codes of tokens
# t = s * (P//per) + t' in bit field s (s = 0..per-1), each stored centered
# (c - 2^(bits-1)) as a bits-wide two's-complement field.  The last dim
# stays D, so a row of words is one contiguous 4*D-byte read, and unpacking
# plane s is a shift-left / arithmetic-shift-right pair yielding the
# contiguous token block [s*P//per, (s+1)*P//per).


def pack_tokens_planar(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., P, D) int codes in [0, 2^bits) -> (..., P//per, D) int32 words,
    token-planar, fields centered two's-complement."""
    assert bits in (1, 2, 4)
    per = 32 // bits
    *lead, P, D = codes.shape
    assert P % per == 0, (P, per)
    mid = 1 << (bits - 1)
    mask = (1 << bits) - 1
    pp = P // per
    fields = (codes.to(torch.int32) - mid) & mask
    out = torch.zeros((*lead, pp, D), dtype=torch.int32, device=codes.device)
    for s in range(per):
        out |= fields[..., s * pp:(s + 1) * pp, :] << (bits * s)
    return out


def unpack_tokens_planar(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of pack_tokens_planar; returns uint8 codes (..., P, D)."""
    per = 32 // bits
    *lead, Pp, D = packed.shape
    mid = 1 << (bits - 1)
    sh_l = ((32 - bits) - torch.arange(per, dtype=torch.int32,
                                       device=packed.device) * bits)
    sh_l = sh_l.reshape((1,) * len(lead) + (per, 1, 1))
    planes = ((packed.unsqueeze(-3) << sh_l) >> (32 - bits)) + mid
    return planes.reshape(*lead, per * Pp, D).to(torch.uint8)
