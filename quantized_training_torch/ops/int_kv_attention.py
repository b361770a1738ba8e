"""Integer-KV decode attention over the two-tier per-token-symmetric cache
(``csrc/int_kv_decode.cu``).

The main tier stores per-token symmetric int4 or int8 codes, so the scales
factor out of the (P, D) element path:

    k[t, :] = ks[t] * ck[t, :]  =>  s[h, t] = (q_h . ck[t]) * ks[t]
    v[t, :] = vs[t] * cv[t, :]  =>  o       = (p * vs) @ cv

and decode tokens live in a bf16 residual ring; attention runs over the
concatenation with post-append visibility (main t < main_len, residual
r < res_len) -- the reference's two-tier cache semantics (reference:
llm_utils.py:115-243, llm_utils.py:295-499).

Layouts (head-major cache, see serving/kv_cache.py):
  q               (B, H, D)
  k codes         (B, KV, P//8, D) int32, token-planar packed int4; or
                  (B, KV, P, D) int8; or, ``k_transposed``, (B, KV, D, P)
                  int8 (the "K^T cache")
  v codes         (B, KV, P//8, D) int32 or (B, KV, P, D) int8
  k/v scale       (B, KV, 1, P) f32 -- per-token scalar scales
  k/v residual    (B, KV, R, D) bf16
  main_len/res_len (B,) int32

Forms, as the reference's (``int_kv_attention.py:77 _kernel``; its
defaults are ``bits=8, int_dots=True, k_transposed=True``):
  * bf16 dots (``int_dots=False``): ``bf16(q * scale)`` against the codes,
    ``bf16(p * vs)`` against the V codes, both products accumulated in f32;
    bits 4 (untransposed only) or 8, K untransposed or transposed;
  * integer dots (``int_dots=True``, bits 8): q * scale quantized to int8
    with one scale per (batch, kv head) tile, ``qs = max|q|/127``, the
    score dot exact in integers times ``ks * qs``; after one softmax over
    [main; residual], ``p * vs`` quantized to int8 with one scale over the
    whole (group, P) tile, ``ps = max|p * vs|/127``, its dot with the V
    codes exact, times ps.
The residual tier always runs the bf16 dots.
"""

import ctypes
import math
from typing import Optional

import torch

from . import _cuda

__all__ = ["KERNEL_DG", "int_kv_decode_attention", "int_kv_decode_plain"]

NEG_INF = -2.0 ** 30


def _unpack_planar(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., Pw, D) packed int32 words -> (..., P, D) int32 signed codes, in
    token order (plane s of word t' is token s * Pw + t'); int8 codes
    (bits 8) are returned as they are."""
    if bits == 8:
        return codes.to(torch.int32)
    per = 32 // bits
    planes = [(codes << (32 - bits * (s + 1))) >> (32 - bits)
              for s in range(per)]
    return torch.cat(planes, dim=-2)


def _check_form(bits: int, int_dots: bool, k_transposed: bool) -> None:
    if bits not in (4, 8):
        raise ValueError(f"int_kv_decode_attention: bits={bits} (4 or 8)")
    if bits == 4 and (int_dots or k_transposed):
        raise ValueError("int_kv_decode_attention: int4 runs the bf16 dots "
                         "over untransposed words (as the reference)")


def _tile_int8(x: torch.Tensor):
    """(codes, scale) of one symmetric int8 scale per tile over the last
    two dims: ``scale = max(max|x|, 1e-30) / 127`` and ``codes =
    round(x / scale)`` (half to even), with true divisions."""
    amax = torch.clamp(x.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    scale = amax / torch.tensor(127.0, dtype=x.dtype, device=x.device)
    return torch.round(x / scale), scale


def _exact_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of integer-valued f32 tensors, exact (f64 holds every partial
    sum of int8 x int8 products), rounded once to f32 as the reference's
    int32 -> f32 convert rounds."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.float32)


def int_kv_decode_plain(q, k_codes, k_scale, v_codes, v_scale, k_res, v_res,
                        main_len, res_len, *, scale: float, bits: int = 8,
                        int_dots: bool = True,
                        k_transposed: bool = True) -> torch.Tensor:
    """The plain version of every form, rounding where the reference's
    kernel rounds (see the module docstring)."""
    _check_form(bits, int_dots, k_transposed)
    B, H, D = q.shape
    KV = k_codes.shape[1]
    G = H // KV
    P = k_scale.shape[-1]
    R = k_res.shape[2]
    f32, bf16 = torch.float32, torch.bfloat16
    qf = q.to(f32).reshape(B, KV, G, D) * scale
    qb = qf.to(bf16).to(f32)
    kc = _unpack_planar(k_codes, bits).to(f32)
    kt = kc if k_transposed else kc.transpose(-1, -2)        # (B, KV, D, P)
    ks = k_scale.to(f32)
    if int_dots:
        q8, qs = _tile_int8(qf)
        s_main = _exact_dot(q8, kt) * (ks * qs)
    else:
        s_main = torch.matmul(qb, kt) * ks
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
    pv = p_main * v_scale.to(f32)
    vc = _unpack_planar(v_codes, bits).to(f32)
    if int_dots:
        p8, ps = _tile_int8(pv)
        acc = _exact_dot(p8, vc) * ps
    else:
        acc = torch.matmul(pv.to(bf16).to(f32), vc)
    acc = acc + torch.matmul(p_res.to(bf16).to(f32), v_res.to(f32))
    return (acc / denom).to(q.dtype).reshape(B, H, D)


# The (head dim D, query heads per kv head G) pairs the kernels are
# instantiated for (csrc/int_kv_decode.cu, with_dg), in every form.
KERNEL_DG = tuple((d, g) for d in (64, 128) for g in (1, 2, 4, 8))


def _lib():
    lib = _cuda.load("int_kv_decode")
    if lib.int_kv_decode.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.int_kv_decode.argtypes = [vp] * 13 + [ci] * 7 + [ctypes.c_float,
                                                              vp]
        lib.int_kv_decode.restype = ci
        lib.int_kv_num_splits.argtypes = [ci, ci]
        lib.int_kv_num_splits.restype = ci
        lib.int_kv_decode_tile.argtypes = [vp] * 10 + [ci] * 8 + [
            ctypes.c_float, vp]
        lib.int_kv_decode_tile.restype = ci
        ptr = ctypes.POINTER(ctypes.c_longlong)
        lib.int_kv_tile_smem.argtypes = [ci] * 4 + [ptr, ptr]
        lib.int_kv_tile_smem.restype = ci
    return lib


def _check_tile_smem(lib, D: int, G: int, P: int, R: int) -> None:
    """The whole-tile kernel keeps all G * (P + R) scores in shared memory:
    refuse a shape that needs more than the card gives one block."""
    need, avail = ctypes.c_longlong(), ctypes.c_longlong()
    _cuda.check(lib, lib.int_kv_tile_smem(D, G, P, R, ctypes.byref(need),
                                          ctypes.byref(avail)),
                "int_kv_tile_smem")
    if need.value > avail.value:
        raise ValueError(
            f"int_kv_decode_attention kernel: the integer-dot / K^T form at "
            f"G={G} D={D} keeps G*(P+R) = {G * (P + R)} f32 scores in shared "
            f"memory, {need.value} bytes with its static arrays, above the "
            f"{avail.value} bytes this card gives one block (P={P} R={R})")


def int_kv_decode_attention(
    q, k_codes, k_scale, v_codes, v_scale, k_res, v_res, main_len, res_len,
    *, bits: int = 8, int_dots: bool = True, k_transposed: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of attention over the two-tier int4 or int8 cache;
    returns (B, H, D) in q's dtype.  The defaults are the reference's.

    CPU tensors take :func:`int_kv_decode_plain`; CUDA tensors launch the
    kernel, and anything it does not take raises: the kernels are built for
    head dim D in (64, 128) with G = H / KV in (1, 2, 4, 8) query heads per
    kv head (``KERNEL_DG``).  The bf16-dot forms over untransposed codes
    launch the split kernel (counted in ``launches``); the integer-dot and
    K^T forms launch the whole-tile kernel (counted in ``tile_launches``),
    which refuses a (G, P, R) whose scores do not fit one block's shared
    memory (G = 8 takes P + R up to about 6000 on an H100).
    """
    _check_form(bits, int_dots, k_transposed)
    B, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return int_kv_decode_plain(q, k_codes, k_scale, v_codes, v_scale,
                                   k_res, v_res, main_len, res_len,
                                   scale=scale, bits=bits, int_dots=int_dots,
                                   k_transposed=k_transposed)
    KV = k_codes.shape[1]
    P = k_scale.shape[-1]
    R = k_res.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"int_kv_decode_attention: no kernel for device {q.device}")
    problems = []
    if q.dtype != torch.bfloat16 or k_res.dtype != torch.bfloat16 \
            or v_res.dtype != torch.bfloat16:
        problems.append("q and the residual ring must be bf16")
    code_dtype = torch.int32 if bits == 4 else torch.int8
    if k_codes.dtype != code_dtype or v_codes.dtype != code_dtype \
            or k_scale.dtype != torch.float32 \
            or v_scale.dtype != torch.float32 \
            or main_len.dtype != torch.int32 or res_len.dtype != torch.int32:
        problems.append(f"codes {code_dtype}, lengths int32 and scales "
                        "float32 expected")
    v_shape = (B, KV, P // 8 if bits == 4 else P, D)
    k_shape = (B, KV, D, P) if k_transposed else v_shape
    if H % KV or (D, H // KV) not in KERNEL_DG or P % 8 \
            or tuple(k_codes.shape) != k_shape \
            or tuple(v_codes.shape) != v_shape \
            or tuple(k_scale.shape) != (B, KV, 1, P) \
            or tuple(v_scale.shape) != (B, KV, 1, P) \
            or tuple(k_res.shape) != (B, KV, R, D) \
            or tuple(v_res.shape) != (B, KV, R, D) \
            or tuple(main_len.shape) != (B,) or tuple(res_len.shape) != (B,):
        problems.append(
            f"shapes q {tuple(q.shape)} codes {tuple(k_codes.shape)} "
            f"scales {tuple(k_scale.shape)} res {tuple(k_res.shape)} "
            f"lens {tuple(main_len.shape)} (the kernels take D in (64, 128) "
            f"with G = H/KV in (1, 2, 4, 8), P % 8 == 0)")
    tensors = (q, k_codes, k_scale, v_codes, v_scale, k_res, v_res,
               main_len, res_len)
    tile = int_dots or k_transposed
    if any(not t.is_contiguous() or t.device != q.device
           or (tile and t.data_ptr() % 16) for t in tensors):
        problems.append("tensors must be contiguous and on one device (and "
                        "16-byte aligned for the whole-tile kernel)")
    if problems:
        raise ValueError("int_kv_decode_attention kernel: "
                         + "; ".join(problems))
    lib = _lib()
    if tile:
        _check_tile_smem(lib, D, H // KV, P, R)
    out = torch.empty_like(q)
    stream = _cuda.stream_ptr(q.device)
    if tile:
        err = lib.int_kv_decode_tile(
            *(t.data_ptr() for t in tensors), out.data_ptr(), B, H, KV, D, P,
            R, int(int_dots), int(k_transposed), float(scale), stream)
        _cuda.check(lib, err, "int_kv_decode_tile")
        int_kv_decode_attention.tile_launches += 1
        return out
    ns = lib.int_kv_num_splits(P, R)
    m_part = torch.empty((B, H, ns), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, H, ns, D), dtype=torch.float32,
                           device=q.device)
    err = lib.int_kv_decode(
        *(t.data_ptr() for t in tensors), m_part.data_ptr(),
        l_part.data_ptr(), acc_part.data_ptr(), out.data_ptr(),
        B, H, KV, D, P, R, bits, float(scale), stream)
    _cuda.check(lib, err, "int_kv_decode")
    int_kv_decode_attention.launches += 1
    return out


int_kv_decode_attention.launches = 0
int_kv_decode_attention.tile_launches = 0
