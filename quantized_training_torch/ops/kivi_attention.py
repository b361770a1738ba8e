"""Fused dequantize-attention for one decode step over the KIVI two-tier
cache (``csrc/kivi_decode.cu``).

The main tier holds group-affine codes: K grouped along tokens (scale and
zero point per (token group, feature)), V along features (per (token,
feature group)); decode tokens live in a bf16 residual ring.  The kernel
reads codes, qparams and the ring and never writes the dequantized K/V.
The zero points stay out of the per-element path: with centered codes
c' = c - mid (mid = 2^(bits-1) for packed codes, 0 for unpacked bytes)

    k[t] = (c'[t] + mid - kz[g]) ks[g]
    q.k[t] = q.(c'[t] ks[g]) + [q.((mid - kz[g]) ks[g])]_g(t)

a scale-only dequant plus one constant per K group; the V side factors
the same way with vz (reference: llm_utils.py:115-243; the factoring of
quantized_training_tpu/ops/pallas/kivi_attention.py:88-185).

Visibility is post-append: main slot t visible iff t < main_len, residual
slot r iff r < res_len.

On the card one launch takes a decode step: the blocks of each (batch, kv
head) pair form one cluster, whose size is :func:`kivi_decode_plan`'s
rule (the wrapper and ``chip_smoke.py`` read it through
:func:`kivi_launch_plan`, the CPU tests hold it to its contract), and p is
rounded against the pair's global max, as the TPU kernel rounds it.

Layouts (head-major cache, see serving/kv_cache.py):
  q                (B, H, D) bf16
  k/v codes        (B, KV, P*bits/32, D) int32 token-planar words of
                   centered codes, or (B, KV, P, D) uint8 codes
  k scale/zp       (B, KV, P/bsK, D) bf16
  v scale/zp       (B, KV, P, D/bsV) bf16
  k/v residual     (B, KV, R, D) bf16
  main_len/res_len (B,) int32
"""

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _cuda, _decode_gemm
from ._decode_attn import (MAX_SMEM, MAX_SPLITS, STEP, WARPS, aligned,
                           cluster_splits, plan_tokens)

__all__ = ["KERNEL_DG", "KiviPlan", "kivi_decode_attention",
           "kivi_decode_plain", "kivi_decode_plan", "kivi_launch_plan",
           "kivi_plan_tokens"]

NEG_INF = -2.0 ** 30

# The (head dim D, query heads per kv head G) pairs the kernel is
# instantiated for (csrc/kivi_decode.cu, with_dg), in every cache form
# (packed uint2 and uint4 words, uint8 codes), at any K group size that
# divides P and any V group of a multiple of D/32 features (at most 32
# groups).
KERNEL_DG = tuple((d, g) for d in (64, 128) for g in (1, 2, 4, 8))

def _unpack_planar(codes: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """(..., Pw, D) packed int32 words -> (..., P, D) int32 centered codes
    in token order; ``bits`` None: unpacked bytes, returned as they are."""
    if bits is None:
        return codes.to(torch.int32)
    per = 32 // bits
    planes = [(codes << (32 - bits * (s + 1))) >> (32 - bits)
              for s in range(per)]
    return torch.cat(planes, dim=-2)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 and back (the kernel's rounding points)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _k_group_constants(qb, ks, kz, mid):
    """Each query head's K zero-point constant of each K token group,
    bf16(qb . bf16((mid - kz) ks)): (B, KV, G, gP).  The G heads of a kv
    head each dot their own q with its one kz/ks."""
    return _bf16(torch.matmul(qb, _bf16((mid - kz) * ks).transpose(-1, -2)))


def kivi_decode_plain(q, k_codes, k_scale, k_zp, v_codes, v_scale, v_zp,
                      k_res, v_res, main_len, res_len, *,
                      bits_k: Optional[int], bits_v: Optional[int],
                      scale: float) -> torch.Tensor:
    """The plain version, rounding where the TPU kernel rounds: q * scale,
    khat = c' * ks and vhat = c' * vs to bf16; the per-group constants
    (mid - z) * s to bf16 before their products and the products to bf16
    before they are expanded over the lanes; p of the main tier and of the
    residual ring to bf16 before the PV products; f32 softmax over
    [main; residual]; acc / l at the end."""
    B, H, D = q.shape
    KV = k_codes.shape[1]
    G = H // KV
    f32 = torch.float32
    mid_k = (1 << (bits_k - 1)) if bits_k else 0
    mid_v = (1 << (bits_v - 1)) if bits_v else 0
    kc = _unpack_planar(k_codes, bits_k).to(f32)             # (B,KV,P,D)
    vc = _unpack_planar(v_codes, bits_v).to(f32)
    P = kc.shape[2]
    R = k_res.shape[2]
    gP, gD = k_scale.shape[2], v_scale.shape[3]
    bsP, bsD = P // gP, D // gD
    ks, kz = k_scale.to(f32), k_zp.to(f32)                   # (B,KV,gP,D)
    vs, vz = v_scale.to(f32), v_zp.to(f32)                   # (B,KV,P,gD)

    qb = _bf16(q.to(f32).reshape(B, KV, G, D) * scale)
    khat = _bf16(kc * ks.repeat_interleave(bsP, dim=2))
    s_main = torch.matmul(qb, khat.transpose(-1, -2))        # (B,KV,G,P)
    s_main = s_main + _k_group_constants(qb, ks, kz, mid_k).repeat_interleave(
        bsP, dim=-1)
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

    pb = _bf16(p_main)
    vhat = _bf16(vc * vs.repeat_interleave(bsD, dim=3))
    acc = torch.matmul(pb, vhat)                              # (B,KV,G,D)
    o2 = torch.matmul(pb, _bf16((mid_v - vz) * vs))           # (B,KV,G,gD)
    acc = acc + _bf16(o2).repeat_interleave(bsD, dim=-1)
    acc = acc + torch.matmul(_bf16(p_res), v_res.to(f32))
    return (acc / denom).to(q.dtype).reshape(B, H, D)


class KiviPlan(NamedTuple):
    """How one decode launch cuts each (batch, kv head) pair's tokens: the
    pair's ``splits`` blocks form one cluster, and its W = 4 * splits warps
    share each tier's 16-token steps evenly, in order (warp w: steps
    [w * n // W, (w + 1) * n // W)).  A main step is ``unit`` rows: word
    rows of packed codes (the token of row r in plane p is p * rows + r) or
    tokens of bytes; a residual step 16 ring rows.  The grid is (splits,
    KV, B)."""
    splits: int
    rows: int
    unit: int
    main_steps: int
    res_steps: int


@functools.lru_cache(maxsize=256)
def kivi_decode_plan(B: int, KV: int, P: int, R: int, bits: Optional[int],
                     sms: int = 132, blocks_per_sm: int = 4) -> KiviPlan:
    """The split of csrc/kivi_decode.cu's launch (the one rule; the kernel
    takes it as its ``splits`` argument): the most blocks a pair, a power
    of two up to 8 (a portable cluster), that keep the grid in one wave of
    ``blocks_per_sm`` blocks an SM and every warp at least one step.
    ``bits``: 2 or 4 for packed words, None (or 0) for bytes."""
    per = 32 // bits if bits else 1
    rows = P // per
    unit = STEP // per
    main_steps, res_steps = -(-rows // unit), -(-R // STEP)
    splits = cluster_splits(B * KV, main_steps + res_steps, sms,
                            blocks_per_sm)
    return KiviPlan(splits, rows, unit, main_steps, res_steps)


_LAUNCH_PLANS = {}


def kivi_launch_plan(device: torch.device, B: int, H: int, KV: int, D: int,
                     P: int, R: int, gP: int, gD: int,
                     bits: Optional[int]) -> KiviPlan:
    """kivi_decode_plan for a launch on ``device``: its SM count and the
    blocks of the kernel an SM holds (the library's occupancy at one
    split's shared memory, the most a block of this call can need)."""
    key = (device.index, B, H, KV, D, P, R, gP, gD, bits)
    plan = _LAUNCH_PLANS.get(key)
    if plan is None:
        lib = _lib()
        smem = lib.kivi_decode_smem(B, H, KV, D, P, R, gP, gD, bits or 0, 1)
        per_sm = lib.kivi_decode_blocks_per_sm(D, H // KV, bits or 0, smem)
        plan = _LAUNCH_PLANS[key] = kivi_decode_plan(
            B, KV, P, R, bits, _decode_gemm.sm_count(device), max(1, per_sm))
    return plan


def kivi_plan_tokens(plan: KiviPlan, R: int, bits: Optional[int]):
    """[[(main tokens, residual rows) of each warp] of each split], as the
    kernel reads them before it cuts them at main_len and res_len: every
    plane of a warp's word rows."""
    return plan_tokens(plan.splits, plan.rows, plan.unit,
                       32 // bits if bits else 1, plan.main_steps,
                       plan.res_steps, R)


def _lib():
    lib = _cuda.load("kivi_decode")
    if lib.kivi_decode.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kivi_decode.argtypes = ([vp] * 12 + [ci] * 10
                                    + [ctypes.c_float, ci, vp])
        lib.kivi_decode.restype = ci
        lib.kivi_decode_smem.argtypes = [ci] * 10
        lib.kivi_decode_smem.restype = ctypes.c_longlong
        lib.kivi_decode_blocks_per_sm.argtypes = [ci, ci, ci,
                                                  ctypes.c_longlong]
        lib.kivi_decode_blocks_per_sm.restype = ci
        lib.kivi_dequant_check.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.kivi_dequant_check.restype = ci
    return lib


def kivi_decode_attention(
    q, k_codes, k_scale, k_zp, v_codes, v_scale, v_zp, k_res, v_res,
    main_len, res_len, *, bits_k: Optional[int] = None,
    bits_v: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of attention over the KIVI cache; returns (B, H, D)
    in q's dtype.  ``bits_k``/``bits_v``: 2 or 4 for token-planar packed
    codes, None for one uint8 code per element.

    CPU tensors take :func:`kivi_decode_plain`; CUDA tensors launch the
    kernel, and anything it does not take raises: it is built for head dim
    D in (64, 128) with G = H / KV in (1, 2, 4, 8) query heads per kv head
    (``KERNEL_DG``), for each cache form, with V groups of a multiple of
    D/32 features (at most 32 groups).
    """
    B, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return kivi_decode_plain(q, k_codes, k_scale, k_zp, v_codes, v_scale,
                                 v_zp, k_res, v_res, main_len, res_len,
                                 bits_k=bits_k, bits_v=bits_v, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"kivi_decode_attention: no kernel for device "
                         f"{q.device}")
    KV = k_codes.shape[1]
    R = k_res.shape[2]
    P = v_scale.shape[2]
    gP, gD = k_scale.shape[2], v_scale.shape[3]
    problems = []
    if bits_k not in (None, 2, 4) or bits_k != bits_v:
        problems.append(f"bits_k={bits_k} bits_v={bits_v} (equal: 2, 4 or "
                        "None)")
    if q.dtype != torch.bfloat16 or k_res.dtype != torch.bfloat16 \
            or v_res.dtype != torch.bfloat16:
        problems.append("q and the residual ring must be bf16")
    for name, t, bits in (("k", k_codes, bits_k), ("v", v_codes, bits_v)):
        want = torch.int32 if bits else torch.uint8
        rows = P * bits // 32 if bits else P
        if t.dtype != want or tuple(t.shape) != (B, KV, rows, D) \
                or (bits and P * bits % 32):
            problems.append(f"{name} codes {t.dtype} {tuple(t.shape)} "
                            f"(want {want} {(B, KV, rows, D)})")
    if any(t.dtype != torch.bfloat16 for t in (k_scale, k_zp, v_scale, v_zp)):
        problems.append("scales and zero points must be bf16")
    if main_len.dtype != torch.int32 or res_len.dtype != torch.int32:
        problems.append("lengths must be int32")
    if H % KV or (D, H // KV) not in KERNEL_DG \
            or gP == 0 or P % gP or gD == 0 or D % gD \
            or (D // gD) % (D // 32) \
            or tuple(k_scale.shape) != (B, KV, gP, D) \
            or tuple(k_zp.shape) != (B, KV, gP, D) \
            or tuple(v_zp.shape) != (B, KV, P, gD) \
            or tuple(k_res.shape) != (B, KV, R, D) \
            or tuple(v_res.shape) != (B, KV, R, D) \
            or tuple(main_len.shape) != (B,) or tuple(res_len.shape) != (B,):
        problems.append(
            f"shapes q {tuple(q.shape)} k scale {tuple(k_scale.shape)} "
            f"v scale {tuple(v_scale.shape)} res {tuple(k_res.shape)} lens "
            f"{tuple(main_len.shape)} (the kernel takes D in (64, 128) with "
            f"G = H/KV in (1, 2, 4, 8), K groups that divide P, and V groups "
            f"of a multiple of D/32 features)")
    tensors = (q, k_codes, k_scale, k_zp, v_codes, v_scale, v_zp, k_res,
               v_res, main_len, res_len)
    if any(not t.is_contiguous() or t.device != q.device for t in tensors):
        problems.append("tensors must be contiguous and on one device")
    if problems:
        raise ValueError("kivi_decode_attention kernel: "
                         + "; ".join(problems))
    lib = _lib()
    plan = kivi_launch_plan(q.device, B, H, KV, D, P, R, gP, gD, bits_k)
    smem = lib.kivi_decode_smem(B, H, KV, D, P, R, gP, gD, bits_k or 0,
                                plan.splits)
    if smem > MAX_SMEM:
        raise ValueError(
            f"kivi_decode_attention kernel: P={P} R={R} at G={H // KV} needs "
            f"{smem} bytes of shared memory a block for its scores (at most "
            f"{MAX_SMEM})")
    tensors = tuple(aligned(t) for t in tensors)
    out = torch.empty_like(q)
    err = lib.kivi_decode(
        *(t.data_ptr() for t in tensors), out.data_ptr(), B, H, KV, D, P, R,
        gP, gD, bits_k or 0, bits_v or 0, float(scale), plan.splits,
        _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "kivi_decode")
    kivi_decode_attention.launches += 1
    return out


kivi_decode_attention.launches = 0


def kivi_dequant_check(codes: torch.Tensor, scales: torch.Tensor,
                       bits: Optional[int]) -> torch.Tensor:
    """bf16(codes * scales) through the kernel's own dequant, on the card
    (a check that it rounds as the plain version does): ``codes`` int32,
    centered two's complement codes for bits 2 or 4, bytes 0-255 for None;
    ``scales`` bf16; an even count."""
    lib = _lib()
    codes = codes.to(torch.int32).contiguous()
    scales = scales.contiguous()
    out = torch.empty_like(scales)
    _cuda.check(lib, lib.kivi_dequant_check(
        codes.data_ptr(), scales.data_ptr(), out.data_ptr(), codes.numel(),
        bits or 0, _cuda.stream_ptr(codes.device)), "kivi_dequant_check")
    return out
