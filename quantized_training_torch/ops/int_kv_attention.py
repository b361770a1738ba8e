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

On the card one launch takes a decode step in every form: the blocks of each
(batch, kv head) pair form one cluster, whose size is
:func:`int_kv_decode_plan`'s rule (the wrapper and ``chip_smoke.py`` read
it through :func:`int_kv_launch_plan`, the CPU tests hold it to its
contract), and p (and, under integer dots, ps) is taken against the pair's
global max, where the reference's kernel takes it.
"""

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _cuda, _decode_gemm
from ._decode_attn import (MAX_SMEM, MAX_SPLITS, STEP, WARPS, aligned,
                           cluster_splits, plan_tokens)

__all__ = ["KERNEL_DG", "IntKvPlan", "int_kv_decode_attention",
           "int_kv_decode_plain", "int_kv_decode_plan", "int_kv_decode_smem",
           "int_kv_launch_plan", "int_kv_plan_tokens"]

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


# The (head dim D, query heads per kv head G) pairs the kernel is
# instantiated for (csrc/int_kv_decode.cu, with_dg), in every form.
KERNEL_DG = tuple((d, g) for d in (64, 128) for g in (1, 2, 4, 8))


def _form(bits: int, int_dots: bool, k_transposed: bool) -> int:
    """The kernel's number of a form (csrc/int_kv_decode.cu: I4, I8, I8KT,
    ID, IDKT)."""
    if bits == 4:
        return 0
    return {(False, False): 1, (False, True): 2, (True, False): 3,
            (True, True): 4}[(bool(int_dots), bool(k_transposed))]


class _Geo(NamedTuple):
    """A form's geometry (csrc/int_kv_decode.cu:Geo)."""
    per: int      # tokens a main-tier row
    step: int     # tokens a main step
    unit: int     # rows a main step
    stage: int    # bytes of a ring slot
    stages: int   # ring slots a warp
    rec: int      # floats of a head's partial


def _geo(form: int, D: int) -> _Geo:
    per = 8 if form == 0 else 1
    step = 16 if form in (0, 1) else 32
    unit = step // per
    rowb = 4 * D if form == 0 else D
    sps = 2 if form in (0, 2, 4) else 1
    kstage = D * sps * step if form in (2, 4) else sps * unit * rowb
    stage = max(kstage, sps * unit * rowb)
    return _Geo(per, step, unit, stage, 2 if stage >= 4096 else 4,
                1 + (2 if form in (3, 4) else 1) * D)


def int_kv_decode_smem(form: int, D: int, G: int, P: int, R: int,
                       splits: int) -> int:
    """Bytes of shared memory a block of the kernel's launch needs (the
    library's ``layout``), from a 1024-byte line: the rings (or the
    partials, whichever is larger), the ring barriers, each warp's run of
    scales and its scores (G floats a token) until the cluster knows the
    pair's max, the maxima."""
    geo = _geo(form, D)
    W = WARPS * splits
    max_main = -(-(-(-(P // geo.per) // geo.unit)) // W)
    max_res = -(-(-(-R // STEP)) // W)
    ring = WARPS * geo.stages * geo.stage
    parts = (WARPS + 1) * G * geo.rec * 4
    sbuf0 = (max(ring, parts) + 15) // 16 * 16 + WARPS * geo.stages * 8
    scores0 = sbuf0 + WARPS * max_main * geo.step * 4
    max0 = scores0 + WARPS * (max_main * geo.step + max_res * STEP) * G * 4
    return max0 + (2 * WARPS * G + 2 * G) * 4 + 1024  # + the alignment


class IntKvPlan(NamedTuple):
    """How one launch cuts each (batch, kv head) pair's tokens: the pair's
    ``splits`` blocks form one cluster, whose 4 * splits warps share each
    tier's steps evenly, in order (``ops/_decode_attn.py``).  A main step
    is ``unit`` rows (word rows of int4 codes, whose plane p holds token p
    * rows + r, or one int8 row a token), a residual step 16 ring rows.
    ``smem``: the bytes of shared memory a block needs (at most MAX_SMEM,
    or the kernel refuses the call).  The grid is (splits, KV, B)."""
    splits: int
    rows: int
    unit: int
    per: int
    main_steps: int
    res_steps: int
    smem: int


@functools.lru_cache(maxsize=256)
def int_kv_decode_plan(B: int, KV: int, P: int, R: int, D: int, G: int,
                       form: int, sms: int = 132,
                       blocks_per_sm=4) -> IntKvPlan:
    """The split of csrc/int_kv_decode.cu's launch (the one rule; the
    kernel takes it as its ``splits`` argument): the decode kernels' rule
    (``_decode_attn.cluster_splits``: one wave of ``blocks_per_sm`` blocks
    an SM, a count or a tuple of the counts at 1, 2, 4 and 8 blocks a pair;
    every warp a step), then more blocks a pair, up to 8, while a block's
    scores outgrow its shared memory."""
    geo = _geo(form, D)
    rows = P // geo.per
    main_steps, res_steps = -(-rows // geo.unit), -(-R // STEP)
    splits = cluster_splits(B * KV, main_steps + res_steps, sms,
                            blocks_per_sm)
    while splits < MAX_SPLITS and \
            int_kv_decode_smem(form, D, G, P, R, splits) > MAX_SMEM:
        splits *= 2
    return IntKvPlan(splits, rows, geo.unit, geo.per, main_steps, res_steps,
                     int_kv_decode_smem(form, D, G, P, R, splits))


def int_kv_plan_tokens(plan: IntKvPlan, R: int):
    """[[(main tokens, residual rows) of each warp] of each split], as the
    kernel reads them before it cuts them at main_len and res_len."""
    return plan_tokens(plan.splits, plan.rows, plan.unit, plan.per,
                       plan.main_steps, plan.res_steps, R)


_LAUNCH_PLANS = {}


def int_kv_launch_plan(device: torch.device, B: int, H: int, KV: int,
                       D: int, P: int, R: int, form: int) -> IntKvPlan:
    """int_kv_decode_plan for a launch on ``device``: its SM count and the
    blocks of the kernel an SM holds at each split's shared memory (the
    library's occupancy)."""
    key = (device.index, B, H, KV, D, P, R, form)
    plan = _LAUNCH_PLANS.get(key)
    if plan is None:
        G = H // KV
        lib = _lib()
        per_sm = tuple(max(1, lib.int_kv_decode_blocks_per_sm(
            form, D, G, min(int_kv_decode_smem(form, D, G, P, R, s),
                            MAX_SMEM))) for s in (1, 2, 4, 8))
        plan = _LAUNCH_PLANS[key] = int_kv_decode_plan(
            B, KV, P, R, D, G, form, _decode_gemm.sm_count(device), per_sm)
    return plan


def _lib():
    lib = _cuda.load("int_kv_decode")
    if lib.int_kv_decode.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.int_kv_decode.argtypes = ([vp] * 10 + [ci] * 7
                                      + [ctypes.c_float, ci, vp])
        lib.int_kv_decode.restype = ci
        lib.int_kv_decode_smem.argtypes = [ci] * 8
        lib.int_kv_decode_smem.restype = ctypes.c_longlong
        lib.int_kv_decode_blocks_per_sm.argtypes = [ci, ci, ci,
                                                    ctypes.c_longlong]
        lib.int_kv_decode_blocks_per_sm.restype = ci
    return lib


def int_kv_decode_attention(
    q, k_codes, k_scale, v_codes, v_scale, k_res, v_res, main_len, res_len,
    *, bits: int = 8, int_dots: bool = True, k_transposed: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode step of attention over the two-tier int4 or int8 cache;
    returns (B, H, D) in q's dtype.  The defaults are the reference's.

    CPU tensors take :func:`int_kv_decode_plain`; CUDA tensors launch the
    kernel, and anything it does not take raises: it is built for head dim
    D in (64, 128) with G = H / KV in (1, 2, 4, 8) query heads per kv head
    (``KERNEL_DG``), P % 8 == 0 (P % 16 == 0 for K^T), and refuses a cache
    whose scores outgrow a block's shared memory at 8 blocks a (batch, kv
    head) pair (``int_kv_decode_plan``; at G = 8, D = 128 P + R about
    34000 in the K^T forms, 44000 over untransposed codes).  Launches of
    the bf16-dot forms over untransposed codes count in ``launches``, of
    the integer-dot and K^T forms in ``tile_launches``.
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
    if H % KV or (D, H // KV) not in KERNEL_DG \
            or P % (16 if k_transposed else 8) \
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
            f"lens {tuple(main_len.shape)} (the kernel takes D in (64, 128) "
            f"with G = H/KV in (1, 2, 4, 8), P % 8 == 0, and P % 16 == 0 "
            f"for K^T)")
    tensors = (q, k_codes, k_scale, v_codes, v_scale, k_res, v_res,
               main_len, res_len)
    if any(not t.is_contiguous() or t.device != q.device for t in tensors):
        problems.append("tensors must be contiguous and on one device")
    if problems:
        raise ValueError("int_kv_decode_attention kernel: "
                         + "; ".join(problems))
    form = _form(bits, int_dots, k_transposed)
    plan = int_kv_launch_plan(q.device, B, H, KV, D, P, R, form)
    if plan.smem > MAX_SMEM:
        raise ValueError(
            f"int_kv_decode_attention kernel: P={P} R={R} at G={H // KV} "
            f"D={D} needs {plan.smem} bytes of shared memory a block for "
            f"its scores at {plan.splits} blocks a pair (at most {MAX_SMEM})")
    lib = _lib()
    tensors = tuple(aligned(t) for t in tensors)
    out = torch.empty_like(q)
    err = lib.int_kv_decode(
        *(t.data_ptr() for t in tensors), out.data_ptr(), B, H, KV, D, P, R,
        form, float(scale), plan.splits, _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "int_kv_decode")
    if form in (0, 1):
        int_kv_decode_attention.launches += 1
    else:
        int_kv_decode_attention.tile_launches += 1
    return out


int_kv_decode_attention.launches = 0
int_kv_decode_attention.tile_launches = 0
