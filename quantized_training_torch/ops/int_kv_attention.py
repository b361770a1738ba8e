"""Integer-KV decode attention over the two-tier per-token-symmetric cache
(``csrc/int_kv_decode.cu``).

The main tier stores per-token symmetric int4 codes, so the scales factor
out of the (P, D) element path:

    k[t, :] = ks[t] * ck[t, :]  =>  s[h, t] = (q_h . ck[t]) * ks[t]
    v[t, :] = vs[t] * cv[t, :]  =>  o       = (p * vs) @ cv

and decode tokens live in a bf16 residual ring; attention runs over the
concatenation with post-append visibility (main t < main_len, residual
r < res_len) -- the reference's two-tier cache semantics (reference:
llm_utils.py:115-243, llm_utils.py:295-499).

Layouts (head-major cache, see serving/kv_cache.py):
  q               (B, H, D)
  k/v codes       (B, KV, P//8, D) int32, token-planar packed int4
  k/v scale       (B, KV, 1, P) f32 -- per-token scalar scales
  k/v residual    (B, KV, R, D) bf16
  main_len/res_len (B,) int32

This slice ports the form serving runs: ``bits=4, int_dots=False,
k_transposed=False``.  The int8 codes, integer dots and the transposed-K
layout come later and raise.
"""

import ctypes
import math
from typing import Optional

import torch

from . import _cuda

__all__ = ["int_kv_decode_attention", "int_kv_decode_plain"]

NEG_INF = -2.0 ** 30


def _unpack_planar(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., Pw, D) packed int32 words -> (..., P, D) int32 signed codes, in
    token order (plane s of word t' is token s * Pw + t')."""
    per = 32 // bits
    planes = [(codes << (32 - bits * (s + 1))) >> (32 - bits)
              for s in range(per)]
    return torch.cat(planes, dim=-2)


def int_kv_decode_plain(q, k_codes, k_scale, v_codes, v_scale, k_res, v_res,
                        main_len, res_len, *, scale: float) -> torch.Tensor:
    """The plain version, rounding where the kernel rounds: q * scale to
    bf16, p * vs and the residual p to bf16 before their f32-accumulated
    products."""
    B, H, D = q.shape
    KV = k_codes.shape[1]
    G = H // KV
    P = k_scale.shape[-1]
    R = k_res.shape[2]
    f32, bf16 = torch.float32, torch.bfloat16
    qb = (q.to(f32).reshape(B, KV, G, D) * scale).to(bf16).to(f32)
    kc = _unpack_planar(k_codes, 4).to(f32)                  # (B, KV, P, D)
    vc = _unpack_planar(v_codes, 4).to(f32)
    s_main = torch.matmul(qb, kc.transpose(-1, -2)) * k_scale.to(f32)
    t_idx = torch.arange(P, device=q.device)
    s_main = torch.where(t_idx < main_len.reshape(B, 1, 1, 1), s_main,
                         torch.full_like(s_main, NEG_INF))
    s_res = torch.matmul(qb, k_res.to(f32).transpose(-1, -2))
    r_idx = torch.arange(R, device=q.device)
    s_res = torch.where(r_idx < res_len.reshape(B, 1, 1, 1), s_res,
                        torch.full_like(s_res, NEG_INF))
    m = torch.maximum(s_main.amax(-1, keepdim=True),
                      s_res.amax(-1, keepdim=True))
    p_main = torch.exp(s_main - m)
    p_res = torch.exp(s_res - m)
    denom = p_main.sum(-1, keepdim=True) + p_res.sum(-1, keepdim=True)
    pv = (p_main * v_scale.to(f32)).to(bf16).to(f32)
    acc = torch.matmul(pv, vc) + torch.matmul(p_res.to(bf16).to(f32),
                                              v_res.to(f32))
    return (acc / denom).to(q.dtype).reshape(B, H, D)


def _lib():
    lib = _cuda.load("int_kv_decode")
    if lib.int_kv_decode.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.int_kv_decode.argtypes = [vp] * 13 + [ci] * 6 + [ctypes.c_float,
                                                              vp]
        lib.int_kv_decode.restype = ci
        lib.int_kv_num_splits.argtypes = [ci, ci]
        lib.int_kv_num_splits.restype = ci
    return lib


def int_kv_decode_attention(
    q, k_codes, k_scale, v_codes, v_scale, k_res, v_res, main_len, res_len,
    *, bits: int = 4, int_dots: bool = False, k_transposed: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of attention over the two-tier int4 cache; returns
    (B, H, D) in q's dtype.

    CPU tensors take :func:`int_kv_decode_plain`; CUDA tensors launch the
    kernel, and anything it does not take raises.
    """
    if bits != 4 or int_dots or k_transposed:
        raise NotImplementedError(
            "int_kv_decode_attention: only bits=4, int_dots=False, "
            "k_transposed=False is ported; the int8 variants come later")
    B, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return int_kv_decode_plain(q, k_codes, k_scale, v_codes, v_scale,
                                   k_res, v_res, main_len, res_len,
                                   scale=scale)
    KV = k_codes.shape[1]
    P = k_scale.shape[-1]
    R = k_res.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"int_kv_decode_attention: no kernel for device {q.device}")
    problems = []
    if q.dtype != torch.bfloat16 or k_res.dtype != torch.bfloat16 \
            or v_res.dtype != torch.bfloat16:
        problems.append("q and the residual ring must be bf16")
    if k_codes.dtype != torch.int32 or v_codes.dtype != torch.int32 \
            or k_scale.dtype != torch.float32 \
            or v_scale.dtype != torch.float32 \
            or main_len.dtype != torch.int32 or res_len.dtype != torch.int32:
        problems.append("codes and lengths int32, scales float32 expected")
    code_shape = (B, KV, P // 8, D)
    if H != KV or D != 128 or P % 8 or tuple(k_codes.shape) != code_shape \
            or tuple(v_codes.shape) != code_shape \
            or tuple(k_scale.shape) != (B, KV, 1, P) \
            or tuple(v_scale.shape) != (B, KV, 1, P) \
            or tuple(k_res.shape) != (B, KV, R, D) \
            or tuple(v_res.shape) != (B, KV, R, D) \
            or tuple(main_len.shape) != (B,) or tuple(res_len.shape) != (B,):
        problems.append(
            f"shapes q {tuple(q.shape)} codes {tuple(k_codes.shape)} "
            f"scales {tuple(k_scale.shape)} res {tuple(k_res.shape)} "
            f"lens {tuple(main_len.shape)} (the kernel takes D=128, H=KV)")
    tensors = (q, k_codes, k_scale, v_codes, v_scale, k_res, v_res,
               main_len, res_len)
    if any(not t.is_contiguous() or t.device != q.device for t in tensors):
        problems.append("tensors must be contiguous and on one device")
    if problems:
        raise ValueError("int_kv_decode_attention kernel: "
                         + "; ".join(problems))
    lib = _lib()
    ns = lib.int_kv_num_splits(P, R)
    m_part = torch.empty((B, H, ns), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, H, ns, D), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    err = lib.int_kv_decode(
        *(t.data_ptr() for t in tensors), m_part.data_ptr(),
        l_part.data_ptr(), acc_part.data_ptr(), out.data_ptr(),
        B, H, KV, D, P, R, float(scale), _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "int_kv_decode")
    int_kv_decode_attention.launches += 1
    return out


int_kv_decode_attention.launches = 0
