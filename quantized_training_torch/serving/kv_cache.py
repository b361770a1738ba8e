"""Two-tier quantized KV cache: a quantized main tier filled at prefill plus
a bf16 residual ring for decode tokens (reference: llm_utils.py:295-499,
the KIVI attention at llm_utils.py:115-243).

Two main-tier formats are ported:

* **per-token symmetric** (``KVCacheConfig.int_sym``): one f32 scale per
  (batch, kv head, token) for K and V; int4 codes stored token-planar
  packed in int32 words (see :func:`pack_tokens_planar`), int8 codes one
  byte each;
* **KIVI group-affine** (``KVCacheConfig.kivi``): K grouped along tokens,
  V along features, bf16 scale and zero point per group; uint2/uint4 codes
  either one byte each or, with ``pack=True``, token-planar packed.

With both specs None (and no ``sym_bits``) the main tier keeps the
prefill K/V unquantized, in the cache dtype (the JAX package's
"unquantized main" two-tier cache).  The model's other full-precision
cache, the static ring of ``LlamaConfig(kv_cache=None)``, is
:class:`FullPrecisionCache`.  ``residual_causal_mask`` masks a
speculative verify block appended to the residual ring.

``prefill_slot`` (raw K/V quantized into one slot) and the byte packing
``pack_codes``/``unpack_codes`` keep the JAX package's cache API; no serving
path calls them.  The engine prefills a slot as the JAX engine does: the
model fills a batch-1 cache, whose fields are copied into the slot.

Storage layout is head-major, (B, KV, T, D); model code speaks
(B, S, KV, D) and the wrappers transpose at the boundary.  Lengths are
int32 tensors: 0-d for a cache whose rows move in lockstep (``generate``),
(B,) per slot for continuous batching.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ..numerics import clamp_keep_zero_sign
from ..qspec import QuantizationSpec
from ..quantize.fake_quant import _group_affine_qparams
from ..quantize.ops import expand_scale

__all__ = ["KVCacheConfig", "QuantizedKVCache", "FullPrecisionCache",
           "init_cache", "prefill_cache", "prefill_slot", "append_to_cache",
           "append_per_slot", "cache_kv", "per_slot_mask",
           "residual_causal_mask", "pack_tokens_planar",
           "unpack_tokens_planar", "pack_codes", "unpack_codes"]

MASK_VALUE = float(torch.finfo(torch.bfloat16).min)


class KVCacheConfig(NamedTuple):
    """Static cache geometry + main-tier format.

    ``k_spec``/``v_spec`` are the KIVI group-affine specs (axes in the
    cache's (B, KV, T, D) layout); ``pack=True`` stores their unsigned
    1/2/4-bit codes token-planar packed.  A side whose spec is None keeps
    its K (or V) unquantized.  ``sym_bits`` (4 or 8) selects the per-token
    symmetric tier instead (both specs None).
    """

    max_prefill: int
    max_decode: int
    k_spec: Optional[QuantizationSpec] = None
    v_spec: Optional[QuantizationSpec] = None
    pack: bool = False
    sym_bits: Optional[int] = None

    @staticmethod
    def kivi(max_prefill: int, max_decode: int,
             k_spec: str = "uint2,qs=group_wise_affine,bs=32,ax=-2",
             v_spec: str = "uint2,qs=group_wise_affine,bs=32,ax=-1",
             pack: bool = False):
        """The KIVI two-tier cache: K quantized along tokens, V along
        features (reference tests: test_codegen.py:536-586)."""
        return KVCacheConfig(
            max_prefill, max_decode,
            _translate_spec_axes(QuantizationSpec.from_str(k_spec)),
            _translate_spec_axes(QuantizationSpec.from_str(v_spec)),
            pack=pack)

    @staticmethod
    def int_sym(max_prefill: int, max_decode: int, bits: int = 4):
        """Per-token symmetric two-tier cache: int4 packed or int8."""
        if bits not in (4, 8):
            raise ValueError(f"int_sym bits must be 4 or 8, got {bits}")
        return KVCacheConfig(max_prefill, max_decode, None, None,
                             pack=(bits == 4), sym_bits=bits)

    def _pack_bits(self, spec: Optional[QuantizationSpec]) -> Optional[int]:
        """Bits per code when this spec's codes are stored packed, else
        None: packing applies to unsigned 1/2/4-bit codes only."""
        if not self.pack or spec is None or spec.quant_min < 0:
            return None
        b = int(spec.quant_max).bit_length()      # uint2: 3 -> 2 bits
        return b if b in (1, 2, 4) else None


class QuantizedKVCache(NamedTuple):
    """Per-layer cache state.  For the per-token symmetric tier, and for a
    side without a spec (whose ``*_codes`` hold the raw K or V), the
    scale and zero point are (1,) placeholders."""

    k_codes: torch.Tensor    # (B, KV, P or P*bits/32, D)
    k_scale: torch.Tensor    # sym: (B, KV, 1, P) f32; KIVI: (B, KV, P/bs, D) bf16
    k_zp: torch.Tensor
    v_codes: torch.Tensor
    v_scale: torch.Tensor    # sym: (B, KV, 1, P) f32; KIVI: (B, KV, P, D/bs) bf16
    v_zp: torch.Tensor
    k_res: torch.Tensor      # (B, KV, R, D) residual, bf16
    v_res: torch.Tensor
    main_len: torch.Tensor   # int32: valid tokens in the quantized tier
    res_len: torch.Tensor    # int32: valid tokens in the residual ring


class FullPrecisionCache(NamedTuple):
    """One layer's static full-precision ring, (B, max_position_embeddings,
    KV, D) each, in the model layout: a forward writes its K/V at
    ``cache_index`` in place, and the model's mask hides the slots not yet
    written, so a caller rewinds by passing a smaller index."""

    k: torch.Tensor
    v: torch.Tensor


def _translate_spec_axes(spec: QuantizationSpec) -> QuantizationSpec:
    """Spec axes (the reference's (batch, heads, tokens, dim) order) as
    non-negative indices of the cache layout."""
    axes = spec.ch_axis if isinstance(spec.ch_axis, tuple) else (spec.ch_axis,)
    ours = tuple(a + 4 if a < 0 else a for a in axes)
    return spec.replace(ch_axis=ours if len(ours) > 1 else ours[0])


def _to_cache_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, S, KV, D) model layout -> (B, KV, S, D) cache layout."""
    return x.transpose(1, 2)


def _to_model_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, KV, S, D) cache layout -> (B, S, KV, D) model layout."""
    return x.transpose(1, 2)


def _qparam_shape(shape, spec: QuantizationSpec):
    """Shape of the group-affine scale/zp of a (B, KV, T, D) tensor."""
    axes = spec.ch_axis if isinstance(spec.ch_axis, tuple) else (spec.ch_axis,)
    out = list(shape)
    for ax in axes:
        ax = ax + len(shape) if ax < 0 else ax
        out[ax] = -(-shape[ax] // spec.block_size)
    return tuple(out)


def _code_dtype(spec: QuantizationSpec):
    return torch.int8 if spec.quant_min < 0 else torch.uint8


def _quantize_groupwise(x: torch.Tensor, spec: QuantizationSpec):
    """Group-affine encode: (codes u/int8, scale bf16, zp bf16) in x's
    layout; the qparams come from x in its own dtype."""
    sf, zp = _group_affine_qparams(x, spec)
    sfe = expand_scale(sf, x.shape, spec.block_size)
    zpe = expand_scale(zp, x.shape, spec.block_size)
    codes = clamp_keep_zero_sign(
        torch.round(x.to(torch.float32) / sfe.to(torch.float32)
                    + zpe.to(torch.float32)),
        spec.quant_min, spec.quant_max,
    ).to(_code_dtype(spec))
    return (codes.contiguous(), sf.to(torch.bfloat16).contiguous(),
            zp.to(torch.bfloat16).contiguous())


def _dequantize_groupwise(codes, scale, zp, spec: QuantizationSpec, dtype):
    sfe = expand_scale(scale.to(torch.float32), codes.shape, spec.block_size)
    zpe = expand_scale(zp.to(torch.float32), codes.shape, spec.block_size)
    return ((codes.to(torch.float32) - zpe) * sfe).to(dtype)


_SYM_QMAX = {8: 127, 4: 7}


def _quantize_sym_per_token(x: torch.Tensor, bits: int):
    """(B, KV, T, D) -> (codes, scale).  Scale is (B, KV, 1, T) f32, one
    scalar per token; bits=8: int8 codes (B, KV, T, D); bits=4:
    token-planar packed int32 words (B, KV, T//8, D) holding 4-bit
    two's-complement codes (the +8 offset makes pack_tokens_planar store
    the signed code's raw field, so a shl/asr unpack sign-extends straight
    to the code)."""
    qmax = _SYM_QMAX[bits]
    xf = x.to(torch.float32)
    amax = torch.clamp_min(xf.abs().amax(dim=-1), 1e-30)        # (B, KV, T)
    sf = amax / qmax
    codes = torch.clamp(torch.round(xf / sf[..., None]), -qmax, qmax)
    if bits == 4:
        codes = pack_tokens_planar(codes.to(torch.int32) + 8, 4)
    else:
        codes = codes.to(torch.int8).contiguous()
    return codes, sf[:, :, None, :].contiguous()


def _dequantize_sym_per_token(codes, scale, bits: int, dtype):
    if bits == 4:
        c = unpack_tokens_planar(codes, 4).to(torch.int32) - 8
    else:
        c = codes.to(torch.int32)
    sf_t = scale.to(torch.float32)[:, :, 0, :, None]             # (B,KV,T,1)
    return (c.to(torch.float32) * sf_t).to(dtype)


def init_cache(cfg: KVCacheConfig, batch: int, kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, *, device) -> QuantizedKVCache:
    """An empty cache with 0-d lengths."""
    P, R = cfg.max_prefill, cfg.max_decode
    shape = (batch, kv_heads, P, head_dim)
    rshape = (batch, kv_heads, R, head_dim)
    lens = dict(main_len=torch.zeros((), dtype=torch.int32, device=device),
                res_len=torch.zeros((), dtype=torch.int32, device=device))
    res = dict(k_res=torch.zeros(rshape, dtype=dtype, device=device),
               v_res=torch.zeros(rshape, dtype=dtype, device=device))
    if cfg.sym_bits is not None:
        if cfg.sym_bits == 4:
            if P % 8:
                raise ValueError(f"max_prefill={P} must be a multiple of 8 "
                                 "(eight int4 tokens share a word)")
            cshape, cdt = (batch, kv_heads, P // 8, head_dim), torch.int32
        else:
            cshape, cdt = shape, torch.int8
        sshape = (batch, kv_heads, 1, P)
        zp = torch.zeros((1,), dtype=torch.bfloat16, device=device)
        return QuantizedKVCache(
            torch.zeros(cshape, dtype=cdt, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device), zp,
            torch.zeros(cshape, dtype=cdt, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device),
            zp.clone(), **res, **lens)

    def side(spec):
        if spec is None:
            placeholder = torch.ones((1,), dtype=torch.bfloat16,
                                     device=device)
            return (torch.zeros(shape, dtype=dtype, device=device),
                    placeholder, torch.zeros_like(placeholder))
        bits = cfg._pack_bits(spec)
        if bits is None:
            codes = torch.zeros(shape, dtype=_code_dtype(spec), device=device)
        else:
            if P % (32 // bits):
                raise ValueError(f"max_prefill={P} must be a multiple of "
                                 f"{32 // bits} to pack {bits}-bit codes")
            codes = torch.zeros((batch, kv_heads, P * bits // 32, head_dim),
                                dtype=torch.int32, device=device)
        scale = torch.ones(_qparam_shape(shape, spec), dtype=torch.bfloat16,
                           device=device)
        return codes, scale, torch.zeros_like(scale)

    return QuantizedKVCache(*side(cfg.k_spec), *side(cfg.v_spec), **res,
                            **lens)


def _quantize_main(cfg: KVCacheConfig, k: torch.Tensor, v: torch.Tensor):
    """Main-tier fields of (B, KV, P, D) K/V: (k_codes, k_scale, k_zp,
    v_codes, v_scale, v_zp); the zero points are None for the per-token
    symmetric tier, scale and zero point None for a side without a spec
    (its codes are the raw K or V)."""
    if cfg.sym_bits is not None:
        k_codes, k_scale = _quantize_sym_per_token(k, cfg.sym_bits)
        v_codes, v_scale = _quantize_sym_per_token(v, cfg.sym_bits)
        return k_codes, k_scale, None, v_codes, v_scale, None
    out = []
    for x, spec in ((k, cfg.k_spec), (v, cfg.v_spec)):
        if spec is None:
            out += [x, None, None]
            continue
        codes, scale, zp = _quantize_groupwise(x, spec)
        bits = cfg._pack_bits(spec)
        if bits is not None:
            codes = pack_tokens_planar(codes, bits)
        out += [codes, scale, zp]
    return tuple(out)


def prefill_cache(cache: QuantizedKVCache, cfg: KVCacheConfig,
                  k: torch.Tensor, v: torch.Tensor,
                  length=None) -> QuantizedKVCache:
    """Quantize the prefill K/V (B, S, KV, D) into the main tier.

    Shorter prefills pad with zeros to ``max_prefill``; ``length`` (int or
    0-d tensor, default S) also zeroes K/V at positions >= length, so a
    padded fixed-shape prefill stores the same cache content as a
    true-length one.  The residual ring is emptied (``res_len`` 0).
    """
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
    kc, ks, kz, vc, vs, vz = _quantize_main(cfg, k, v)
    keep = lambda new, old: old if new is None else new
    return cache._replace(
        k_codes=kc, k_scale=keep(ks, cache.k_scale), k_zp=keep(kz, cache.k_zp),
        v_codes=vc, v_scale=keep(vs, cache.v_scale), v_zp=keep(vz, cache.v_zp),
        main_len=main_len,
        res_len=torch.zeros((), dtype=torch.int32, device=device),
    )


def prefill_slot(cache: QuantizedKVCache, cfg: KVCacheConfig,
                 k: torch.Tensor, v: torch.Tensor,
                 slot: int) -> QuantizedKVCache:
    """Quantize one request's prefill K/V (1, S, KV, D) into batch slot
    ``slot`` of a per-slot cache ((B,) lengths), **in place**, and reset
    that slot's residual ring.  A packed cache needs S == max_prefill (the
    token-planar planes span the whole prefill extent)."""
    if cfg.pack and k.shape[1] != cfg.max_prefill:
        raise ValueError(f"a packed cache takes a prefill of max_prefill="
                         f"{cfg.max_prefill} tokens, got {k.shape[1]}")
    k = _to_cache_layout(k)                      # (1, KV, S, D)
    v = _to_cache_layout(v)
    fields = _quantize_main(cfg, k, v)
    names = ("k_codes", "k_scale", "k_zp", "v_codes", "v_scale", "v_zp")
    for name, val in zip(names, fields):
        if val is not None:
            buf = getattr(cache, name)
            region = tuple(slice(0, n) for n in val.shape[1:])
            buf[slot][region].copy_(val[0].to(buf.dtype))
    cache.k_res[slot].zero_()
    cache.v_res[slot].zero_()
    cache.main_len[slot] = k.shape[2]
    cache.res_len[slot] = 0
    return cache


def append_to_cache(cache: QuantizedKVCache, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> QuantizedKVCache:
    """Append decode-step K/V (B, n, KV, D) at the shared residual index
    (0-d ``res_len``), writing the ring **in place**: one decode token, or
    an n-token speculative verify block.  Like a dynamic update slice, the
    start index is clamped so that the n rows fit."""
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


def _main_tier(cache: QuantizedKVCache, cfg: KVCacheConfig, dtype):
    """The dequantized main tier, (B, KV, P, D) each for K and V."""
    if cfg.sym_bits is not None:
        return (_dequantize_sym_per_token(cache.k_codes, cache.k_scale,
                                          cfg.sym_bits, dtype),
                _dequantize_sym_per_token(cache.v_codes, cache.v_scale,
                                          cfg.sym_bits, dtype))
    out = []
    for codes, scale, zp, spec in (
            (cache.k_codes, cache.k_scale, cache.k_zp, cfg.k_spec),
            (cache.v_codes, cache.v_scale, cache.v_zp, cfg.v_spec)):
        if spec is None:
            out.append(codes.to(dtype))
            continue
        bits = cfg._pack_bits(spec)
        if bits is not None:
            codes = unpack_tokens_planar(codes, bits)
        out.append(_dequantize_groupwise(codes, scale, zp, spec, dtype))
    return tuple(out)


def cache_kv(cache: QuantizedKVCache, cfg: KVCacheConfig,
             dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialized (K, V) = [dequant(main); residual], each
    (B, max_prefill + max_decode, KV, D); invalid slots must be masked by
    the caller (see per_slot_mask, residual_causal_mask)."""
    k_main, v_main = _main_tier(cache, cfg, dtype)
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


def residual_causal_mask(cfg: KVCacheConfig, batch: int, q_len: int,
                         main_len: torch.Tensor, res_len: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Additive mask (B, 1, q_len, P+R) over [main; residual] slots for a
    query block appended to the residual ring at ``res_len`` (0-d):
    main slots < main_len visible, and query i sees residual slots
    r <= res_len + i (reference: llm_utils.py:278-292)."""
    P, R = cfg.max_prefill, cfg.max_decode
    device = main_len.device
    kv_pos = torch.arange(P + R, device=device)[None, :]
    q_pos = torch.arange(q_len, device=device)[:, None]
    in_main = kv_pos < main_len
    in_res = (kv_pos >= P) & ((kv_pos - P) <= res_len + q_pos)
    mask = torch.where(in_main | in_res, 0.0, MASK_VALUE).to(dtype)
    return mask[None, None].expand(batch, 1, q_len, P + R)


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


# ---------------------------------------------------------------------------
# Sub-byte export packing (codes -> bytes along the last axis)
# ---------------------------------------------------------------------------

def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack intN codes (stored one per byte, last axis) into bytes, 8//bits
    per byte, low field first."""
    assert bits in (1, 2, 4)
    per = 8 // bits
    *lead, last = codes.shape
    assert last % per == 0
    u = (codes.to(torch.uint8) & ((1 << bits) - 1)).reshape(
        *lead, last // per, per).to(torch.int32)
    shifts = torch.arange(per, dtype=torch.int32, device=codes.device) * bits
    return (u << shifts).sum(dim=-1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int,
                 signed: bool = False) -> torch.Tensor:
    """Inverse of pack_codes; returns int8 codes.  ``signed=True``
    sign-extends the low ``bits`` bits (two's complement)."""
    per = 8 // bits
    shifts = torch.arange(per, dtype=torch.int32, device=packed.device) * bits
    u = (packed.to(torch.int32)[..., None] >> shifts) & ((1 << bits) - 1)
    *lead, last, _ = u.shape
    u = u.reshape(*lead, last * per)
    if signed:
        sign_bit = 1 << (bits - 1)
        u = (u ^ sign_bit) - sign_bit
    return u.to(torch.int8)
