"""Causal GQA flash attention, forward (``csrc/flash_attn_fwd.cu``) and
backward (``csrc/flash_attn_bwd.cu``).

Interface shapes: q (B, H, S, D); k, v (B, KV, T, D) with H % KV == 0;
output (B, H, S, D) in q's dtype.  ``q_offset`` is the absolute position
of q[0].

Quantization hooks (reference: ops/pallas/flash_attention.py):
  * ``q_qfn``/``k_qfn``/``v_qfn`` are elementwise, so they are hoisted out
    of the kernel: straight-through roundings of the operands before it (the
    rounding kernel on CUDA);
  * ``p_qfn`` selects the two-pass form: pass 1 finds each row's
    logsumexp, pass 2 rounds the true probability exp(s - lse) (to bf16,
    then through ``p_qfn``) and accumulates round(p) @ v with no division;
  * ``out_qfn`` rounds the bf16 output, in the two-pass kernel's epilogue
    (after the single-pass kernel, it is the rounding kernel's own pass);
  * ``err_qfn`` is the backward's error tap: dp = dO V^T is rounded (to
    bf16, then through ``err_qfn``) before the softmax Jacobian, with
    di = rowsum(p * err(dp)) from its own pass (kernel ``flash_bwd_di``),
    and dq, dk, dv are rounded as they leave, dk and dv after the GQA sum.
On CUDA a hook must be a ``numerics.quantize_fn`` callable, whose format the
kernels read.

``flash_attention`` is differentiable on both devices.  When autograd
records it, the forward is the training form, which also returns each
row's logsumexp (f32, (B, H, S)) and ``o_unq``, the output with the
probabilities unrounded (the two-pass kernel accumulates bf16(p) @ v beside
round(p) @ v; the single-pass one returns its output before ``out_qfn``).
The backward is the reference's tile-recomputing one: di, then dq (one
block per query tile over the key tiles), then dk and dv per query head
(one block per key tile over the query tiles), summed over the GQA group
outside.  On the CPU it runs the kernels' plain versions, never autograd
through :func:`naive_attention`: those put the dp tap and di elsewhere.
"""

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from . import _cuda
from ..numerics import QuantFn
from ..quantize.fake_quant import straight_through

__all__ = ["flash_attention", "naive_attention", "attention_forward_plain",
           "flash_forward_train", "forward_plan", "FWD_FORMS",
           "flash_backward", "flash_bwd_di", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_di_plain", "flash_bwd_dq_plain", "flash_bwd_dkv_plain",
           "NEG_INF"]

NEG_INF = -2.0 ** 30  # large-but-safe additive mask


def _plain(fn):
    """A hook's plain PyTorch rounding (any device)."""
    return fn.plain if isinstance(fn, QuantFn) else fn


def _scores(q, k, *, scale, causal, q_offset):
    """f32 scores q k^T * scale, (B, H, S, T), masked with NEG_INF; k is
    repeated over the GQA group."""
    H, S = q.shape[1], q.shape[2]
    T = k.shape[2]
    if k.shape[1] != H:
        k = torch.repeat_interleave(k, H // k.shape[1], dim=1)
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * scale
    if causal:
        q_pos = torch.arange(S, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(T, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))
    return s


def _expand(t, H):
    return t if t.shape[1] == H else torch.repeat_interleave(
        t, H // t.shape[1], dim=1)


def _pv(p, v):
    """p rounded to v's dtype, f32-accumulated p @ v."""
    return torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))


def naive_attention(q, k, v, *, scale: float, causal: bool = True,
                    q_offset: int = 0, p_qfn=None,
                    out_qfn=None) -> torch.Tensor:
    """The plain version: full (B, H, S, T) scores in f32.  Without
    ``p_qfn``: softmax, p rounded to v's dtype, f32-accumulated p @ v.  With
    it: p = exp(s - logsumexp(s)), rounded to bf16 and through ``p_qfn``,
    then the f32 p @ v, summed tile by tile as the kernel does.
    ``out_qfn`` rounds the output in q's dtype.  Every
    rounding is the plain PyTorch one, on any device."""
    return attention_forward_plain(q, k, v, scale=scale, causal=causal,
                                   q_offset=q_offset, p_qfn=p_qfn,
                                   out_qfn=out_qfn, save=False)[0]


TILE = 128   # the reference kernel's block_q = block_k


def _two_pass_tiles(q, k, v, p_qfn, *, scale, causal, q_offset, save):
    """The two-pass form in the reference kernel's tile order
    (ops/pallas/flash_attention.py:66 with 128 x 128 blocks): per query
    tile, pass 1 carries the running max m and sum l over the key tiles
    (l = l exp(m - m') + sum exp(s - m')) to lse = m + log l; pass 2 adds
    round(p) @ v tile by tile in f32, p = exp(s - lse) rounded to bf16 and
    through ``p_qfn``.  Key tiles wholly above the causal diagonal are
    skipped, which changes no bit (their p is 0).  Returns (acc, lse,
    acc_unq) in f32; acc_unq sums bf16(p) @ v (None unless ``save``)."""
    B, H, S, D = q.shape
    T = k.shape[2]
    k, v = _expand(k, H), _expand(v, H)
    f32 = torch.float32
    acc = torch.empty((B, H, S, D), dtype=f32, device=q.device)
    acc_unq = torch.empty_like(acc) if save else None
    lse = torch.empty((B, H, S), dtype=f32, device=q.device)
    for i0 in range(0, S, TILE):
        i1 = min(i0 + TILE, S)
        last_q = q_offset + i1 - 1
        tiles = []
        m = torch.full((B, H, i1 - i0, 1), NEG_INF, dtype=f32,
                       device=q.device)
        l = torch.zeros_like(m)
        for j0 in range(0, T, TILE):
            if causal and j0 > last_q:
                break
            j1 = min(j0 + TILE, T)
            st = torch.matmul(q[:, :, i0:i1].to(f32),
                              k[:, :, j0:j1].to(f32).transpose(-1, -2)) * scale
            if causal:
                q_pos = torch.arange(i0, i1, device=q.device)[:, None] \
                    + q_offset
                k_pos = torch.arange(j0, j1, device=q.device)[None, :]
                st = torch.where(k_pos <= q_pos, st,
                                 torch.full_like(st, NEG_INF))
            tiles.append((j0, j1, st))
            m_new = torch.maximum(m, torch.amax(st, dim=-1, keepdim=True))
            l = (l * torch.exp(m - m_new)
                 + torch.sum(torch.exp(st - m_new), dim=-1, keepdim=True))
            m = m_new
        row_lse = m + torch.log(torch.where(l == 0.0, torch.ones_like(l), l))
        a = torch.zeros((B, H, i1 - i0, D), dtype=f32, device=q.device)
        a_unq = torch.zeros_like(a) if save else None
        for j0, j1, st in tiles:
            p = torch.exp(st - row_lse)
            pq = _plain(p_qfn)(p.to(torch.bfloat16)).to(f32)
            vt = v[:, :, j0:j1]
            a = a + _pv(pq, vt)
            if save:
                a_unq = a_unq + _pv(p, vt)
        acc[:, :, i0:i1] = a
        lse[:, :, i0:i1] = row_lse[..., 0]
        if save:
            acc_unq[:, :, i0:i1] = a_unq
    return acc, lse, acc_unq


def attention_forward_plain(q, k, v, *, scale: float, causal: bool = True,
                            q_offset: int = 0, p_qfn=None, out_qfn=None,
                            save: bool = True):
    """The plain version of the training forward: ``(o, lse, o_unq)`` with
    lse f32 (B, H, S) and o_unq the output with p unrounded (bf16(p) @ v
    with ``p_qfn``, the output before ``out_qfn`` without it).  With
    ``save=False`` lse and o_unq are None.  The two-pass form (``p_qfn``)
    sums in the reference kernel's tile order (:func:`_two_pass_tiles`)."""
    lse = o_unq = None
    if p_qfn is None:
        s = _scores(q, k, scale=scale, causal=causal, q_offset=q_offset)
        out = _pv(torch.softmax(s, dim=-1), _expand(v, q.shape[1])).to(
            q.dtype)
        if save:
            lse, o_unq = torch.logsumexp(s, dim=-1), out
    else:
        acc, lse, acc_unq = _two_pass_tiles(
            q, k, v, p_qfn, scale=scale, causal=causal, q_offset=q_offset,
            save=save)
        out = acc.to(q.dtype)
        if save:
            o_unq = acc_unq.to(q.dtype)
        else:
            lse = None
    if out_qfn is not None:
        out = _plain(out_qfn)(out)
    return out, lse, o_unq


# ------------------------------------------------------------ the backward
def _probs(q, k, lse, *, scale, causal, q_offset):
    """p = exp(s - lse), f32 (B, H, S, T); 0 where masked."""
    s = _scores(q, k, scale=scale, causal=causal, q_offset=q_offset)
    return torch.exp(s - lse[..., None])


def _dp(do, v, err_qfn, H):
    """dp = dO V^T in f32 (B, H, S, T); with ``err_qfn``, rounded to bf16
    and through it (the error tap before the softmax Jacobian)."""
    dp = torch.matmul(do.to(torch.float32),
                      _expand(v, H).to(torch.float32).transpose(-1, -2))
    if err_qfn is not None:
        dp = _plain(err_qfn)(dp.to(torch.bfloat16)).to(torch.float32)
    return dp


def flash_bwd_di_plain(q, k, v, do, lse, *, scale: float, causal: bool = True,
                       q_offset: int = 0, err_qfn=None) -> torch.Tensor:
    """di = rowsum(p * err(bf16(dO V^T))), f32 (B, H, S)."""
    p = _probs(q, k, lse, scale=scale, causal=causal, q_offset=q_offset)
    return torch.sum(p * _dp(do, v, err_qfn, q.shape[1]), dim=-1)


def flash_bwd_dq_plain(q, k, v, do, lse, di, *, scale: float,
                       causal: bool = True, q_offset: int = 0,
                       err_qfn=None) -> torch.Tensor:
    """dq = [p * (dp - di) * scale, rounded to k's dtype] @ K, f32-summed,
    in q's dtype; p is the unrounded softmax (straight-through)."""
    H = q.shape[1]
    p = _probs(q, k, lse, scale=scale, causal=causal, q_offset=q_offset)
    ds = p * (_dp(do, v, err_qfn, H) - di[..., None]) * scale
    dq = torch.matmul(ds.to(k.dtype).to(torch.float32),
                      _expand(k, H).to(torch.float32))
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, di, *, scale: float,
                        causal: bool = True, q_offset: int = 0, p_qfn=None,
                        err_qfn=None):
    """Per query head (B, H, T, D): dv_h = pv^T dO with pv the rounded
    bf16(p) under ``p_qfn`` and the f32 p without it; dk_h = [p * (dp - di)
    * scale, rounded to q's dtype]^T Q.  In k's and v's dtypes."""
    H = q.shape[1]
    p = _probs(q, k, lse, scale=scale, causal=causal, q_offset=q_offset)
    pv = p if p_qfn is None else _plain(p_qfn)(
        p.to(torch.bfloat16)).to(torch.float32)
    dv = torch.matmul(pv.transpose(-1, -2), do.to(torch.float32))
    ds = p * (_dp(do, v, err_qfn, H) - di[..., None]) * scale
    dk = torch.matmul(ds.to(q.dtype).to(torch.float32).transpose(-1, -2),
                      q.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_lib():
    lib = _cuda.load("flash_attn_bwd")
    if lib.flash_bwd_di.argtypes is None:
        vp, ci, cf, fmt = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                           _cuda.QtFormat)
        shape = [ci, ci, ci, ci, ci, ci, cf, ci, ci]
        lib.flash_bwd_di.argtypes = [vp] * 6 + shape + [fmt, vp]
        lib.flash_bwd_dq.argtypes = [vp] * 7 + shape + [fmt, vp]
        lib.flash_bwd_dkv.argtypes = [vp] * 8 + shape + [fmt, fmt, vp]
        for fn in (lib.flash_bwd_di, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ci
    return lib


def _check_operands(what, q, k, v, *rows):
    """Raise unless the CUDA kernels take these operands: bf16 q, k, v (and
    dO) of the interface shapes with D 64 or 128, f32 row statistics
    (B, H, S), all contiguous on one device."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    problems = []
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        problems.append("q, k, v must be bf16")
    if H % KV or tuple(v.shape) != tuple(k.shape) or k.shape[0] != B \
            or k.shape[3] != D or D not in (64, 128):
        problems.append(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                        f"v {tuple(v.shape)} (D must be 64 or 128)")
    for name, t, dtype, shape in rows:
        if t.dtype != dtype or tuple(t.shape) != shape:
            problems.append(f"{name} must be {dtype} {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if any(not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16
           for t in (q, k, v, *(r[1] for r in rows))):
        problems.append("operands must be contiguous, 16-byte aligned and on "
                        "one device")
    if problems:
        raise ValueError(f"{what} kernel: " + "; ".join(problems))


def _bwd_common(q, k, scale, causal, q_offset):
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if q_offset < 0:
        raise ValueError(f"flash backward kernel: q_offset={q_offset}")
    return (B, H, KV, S, T, D, float(scale), int(bool(causal)),
            int(q_offset))


def _check_bwd_operands(what, q, k, v, do, lse, di=None):
    B, H, S, D = q.shape
    rows = [("dO", do, torch.bfloat16, tuple(q.shape)),
            ("lse", lse, torch.float32, (B, H, S))]
    if di is not None:
        rows.append(("di", di, torch.float32, (B, H, S)))
    _check_operands(what, q, k, v, *rows)


def flash_bwd_di(q, k, v, do, lse, *, scale: float, causal: bool = True,
                 q_offset: int = 0, err_qfn=None) -> torch.Tensor:
    """Kernel 2 (``_bwd_di_kernel``): di f32 (B, H, S).  CPU tensors take
    :func:`flash_bwd_di_plain`."""
    kw = dict(scale=scale, causal=causal, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_bwd_di_plain(q, k, v, do, lse, err_qfn=err_qfn, **kw)
    _check_bwd_operands("flash_bwd_di", q, k, v, do, lse)
    fmt = _kernel_format(err_qfn, "err_qfn", backward=True)
    di = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    err = lib.flash_bwd_di(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                           *_bwd_common(q, k, scale, causal, q_offset),
                           _cuda.qt_format(fmt), _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "flash_bwd_di")
    flash_bwd_di.launches += 1
    return di


def flash_bwd_dq(q, k, v, do, lse, di, *, scale: float, causal: bool = True,
                 q_offset: int = 0, err_qfn=None) -> torch.Tensor:
    """Kernel 3 (``_bwd_dq_kernel``): dq bf16 (B, H, S, D).  CPU tensors
    take :func:`flash_bwd_dq_plain`."""
    kw = dict(scale=scale, causal=causal, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, di, err_qfn=err_qfn, **kw)
    _check_bwd_operands("flash_bwd_dq", q, k, v, do, lse, di)
    fmt = _kernel_format(err_qfn, "err_qfn", backward=True)
    dq = torch.empty_like(q)
    lib = _bwd_lib()
    err = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                           dq.data_ptr(),
                           *_bwd_common(q, k, scale, causal, q_offset),
                           _cuda.qt_format(fmt), _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, di, *, scale: float, causal: bool = True,
                  q_offset: int = 0, p_qfn=None, err_qfn=None):
    """Kernel 4 (``_bwd_dkv_kernel``): (dk_h, dv_h) bf16 (B, H, T, D), per
    query head.  CPU tensors take :func:`flash_bwd_dkv_plain`."""
    kw = dict(scale=scale, causal=causal, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, di, p_qfn=p_qfn,
                                   err_qfn=err_qfn, **kw)
    _check_bwd_operands("flash_bwd_dkv", q, k, v, do, lse, di)
    p_fmt = _kernel_format(p_qfn, "p_qfn", backward=True)
    e_fmt = _kernel_format(err_qfn, "err_qfn", backward=True)
    B, H, _, D = q.shape
    T = k.shape[2]
    dk = torch.empty((B, H, T, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _bwd_lib()
    err = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(),
                            *_bwd_common(q, k, scale, causal, q_offset),
                            _cuda.qt_format(p_fmt), _cuda.qt_format(e_fmt),
                            _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_backward(q, k, v, lse, o_unq, do, *, scale: float,
                   causal: bool = True, q_offset: int = 0, p_qfn=None,
                   err_qfn=None):
    """(dq, dk, dv) from the training forward's saved tensors and dO
    (reference: flash_attention.py:_flash_bwd).  di is rowsum(dO * o_unq)
    in f32 without ``err_qfn`` and kernel 2 with it; dk and dv are summed
    over the GQA group in f32, then rounded to k's and v's dtypes; with
    ``err_qfn`` dq, dk and dv are rounded through it last."""
    do = do.contiguous()
    kw = dict(scale=scale, causal=causal, q_offset=q_offset)
    if err_qfn is None:
        di = torch.sum(do.to(torch.float32) * o_unq.to(torch.float32), dim=-1)
    else:
        di = flash_bwd_di(q, k, v, do, lse, err_qfn=err_qfn, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, di, err_qfn=err_qfn, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, p_qfn=p_qfn,
                           err_qfn=err_qfn, **kw)
    B, KV, T, D = k.shape
    group = q.shape[1] // KV
    if group > 1:
        dk = dk.to(torch.float32).reshape(B, KV, group, T, D).sum(2).to(
            k.dtype)
        dv = dv.to(torch.float32).reshape(B, KV, group, T, D).sum(2).to(
            v.dtype)
    if err_qfn is not None:
        dq, dk, dv = err_qfn(dq), err_qfn(dk), err_qfn(dv)
    return dq, dk, dv


# ------------------------------------------------------------- the forward
# The forward kernel's forms (csrc/flash_attn_fwd.cu): single pass, single
# pass with the row logsumexp, two pass (p_qfn), two pass with lse and o_unq.
FWD_FORMS = ("single", "single_lse", "two_pass", "two_pass_lse")
SMEM_PER_BLOCK = 232_448      # an H100 block's opt-in shared memory


class FwdPlan(NamedTuple):
    block_q: int        # query rows per block: two warpgroups of 64
    block_k: int        # keys per tile
    stages: int         # depth of the K/V ring
    threads: int
    grid: tuple         # (B * H, q tiles), q tiles launched longest first
    smem_bytes: int     # dynamic shared memory per block


def forward_plan(form: str, D: int, B: int = 1, H: int = 1,
                 S: int = 1) -> FwdPlan:
    """The forward kernel's launch for ``form`` at head dim D, as
    ``csrc/flash_attn_fwd.cu`` makes it (``Layout<D>``): a 128 x D Q tile and
    three stages of a 64-key K tile and V tile, bf16, in shared memory (pass
    1 of the two-pass forms leaves the V half idle), plus 1024 bytes to
    align the swizzled tiles.  Raises for a form or a D the kernel does not
    take."""
    if form not in FWD_FORMS:
        raise ValueError(f"flash_attention kernel: no form {form!r}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention kernel: D={D} (must be 64 or 128)")
    block_q, block_k, stages = 128, 64, 3
    smem = block_q * D * 2 + stages * 2 * block_k * D * 2 + 1024
    return FwdPlan(block_q, block_k, stages, 256,
                   (B * H, -(-S // block_q)), smem)


def _lib():
    lib = _cuda.load("flash_attn_fwd")
    if lib.flash_attn_fwd.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [ci, ci, ci, ci, ci, ci, cf, ci, ci]
        lib.flash_attn_fwd.argtypes = [vp] * 5 + shape + [vp]
        lib.flash_attn_fwd.restype = ci
        lib.flash_attn_fwd_two_pass.argtypes = [vp] * 6 + shape + [
            _cuda.QtFormat, _cuda.QtFormat, vp]
        lib.flash_attn_fwd_two_pass.restype = ci
    return lib


def _kernel_format(fn, name, backward=False):
    """The kernel format of a hook.  The backward kernels (and so the
    training forward, whose backward they are) take the posit, fp8, fp and
    int roundings they are checked with on the card; a NormalFloat codebook
    or a native cast there raises."""
    if fn is None:
        return None
    if not isinstance(fn, QuantFn) or fn.fmt is None:
        raise ValueError(f"flash_attention kernel: {name} must be a "
                         f"quantize_fn callable with a kernel format, got "
                         f"{fn!r}")
    if backward and fn.fmt.kind in ("nf", "cast"):
        raise ValueError(f"flash backward kernels: {name}={fn.dtype!r} has "
                         f"no checked backward form (posit, fp8, fp and int "
                         f"roundings only)")
    return fn.fmt


class _Hooks(NamedTuple):
    scale: float
    causal: bool
    q_offset: int
    p_qfn: object
    out_qfn: object
    err_qfn: object


def _forward(q, k, v, h: _Hooks, save: bool):
    """(o, lse, o_unq): the plain version on the CPU, a kernel on CUDA; lse
    and o_unq are None unless ``save``."""
    if q.device.type == "cpu":
        return attention_forward_plain(
            q, k, v, scale=h.scale, causal=h.causal, q_offset=h.q_offset,
            p_qfn=h.p_qfn, out_qfn=h.out_qfn, save=save)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    p_fmt = _kernel_format(h.p_qfn, "p_qfn")
    out_fmt = _kernel_format(h.out_qfn, "out_qfn")
    if h.q_offset < 0:
        raise ValueError(f"flash_attention kernel: q_offset={h.q_offset}")
    _check_operands("flash_attention", q, k, v)
    B, H, S, D = q.shape
    _, KV, T, _ = k.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if save else None)
    o_unq = torch.empty_like(q) if save and p_fmt is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    args = (B, H, KV, S, T, D, float(h.scale), int(bool(h.causal)),
            int(h.q_offset))
    stream = _cuda.stream_ptr(q.device)
    if p_fmt is None:
        err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), ptr(lse), *args, stream)
        _cuda.check(lib, err, "flash_attn_fwd")
        flash_attention.launches += 1
        o_unq = out if save else None
        if h.out_qfn is not None:
            out = h.out_qfn(out)
    else:
        err = lib.flash_attn_fwd_two_pass(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ptr(lse), ptr(o_unq), *args, _cuda.qt_format(p_fmt),
            _cuda.qt_format(out_fmt), stream)
        _cuda.check(lib, err, "flash_attn_fwd_two_pass")
        flash_attention.two_pass_launches += 1
    if save:
        flash_attention.lse_launches += 1
    return out, lse, o_unq


def flash_forward_train(q, k, v, *, scale: float, causal: bool = True,
                        q_offset: int = 0, p_qfn=None, out_qfn=None):
    """The training forward on its own: ``(o, lse, o_unq)``, the kernel's
    on CUDA (counted in ``flash_attention.lse_launches`` and the form's own
    counter), :func:`attention_forward_plain` on the CPU."""
    return _forward(q, k, v, _Hooks(scale, causal, q_offset, p_qfn, out_qfn,
                                    None), save=True)


class _FlashAttention(torch.autograd.Function):
    """The reference's custom_vjp: the training forward saves q, k, v, lse
    and o_unq; the backward is :func:`flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, hooks):
        out, lse, o_unq = _forward(q, k, v, hooks, save=True)
        ctx.save_for_backward(q, k, v, lse, o_unq)
        ctx.hooks = hooks
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lse, o_unq = ctx.saved_tensors
        h = ctx.hooks
        dq, dk, dv = flash_backward(
            q, k, v, lse, o_unq, g, scale=h.scale, causal=h.causal,
            q_offset=h.q_offset, p_qfn=h.p_qfn, err_qfn=h.err_qfn)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = True, q_offset: int = 0,
                    q_qfn=None, k_qfn=None, p_qfn=None, v_qfn=None,
                    out_qfn=None, err_qfn=None) -> torch.Tensor:
    """Causal flash attention.

    CPU tensors take the plain versions; CUDA tensors launch the single-pass
    kernel, or the two-pass one when ``p_qfn`` is set (bf16, D in {64,
    128}, any S and T), and anything they do not take raises.  When
    autograd records the call, the forward saves the logsumexp (and o_unq)
    and the backward runs the flash backward kernels.
    """
    train = torch.is_grad_enabled() and any(t.requires_grad
                                            for t in (q, k, v))
    if q.device.type == "cuda":
        for name, fn in (("q_qfn", q_qfn), ("k_qfn", k_qfn),
                         ("v_qfn", v_qfn), ("err_qfn", err_qfn)):
            _kernel_format(fn, name)
        if train:
            _kernel_format(p_qfn, "p_qfn", backward=True)
            _kernel_format(err_qfn, "err_qfn", backward=True)
    # hoisted operand roundings, straight-through
    if q_qfn is not None:
        q = straight_through(q_qfn)(q)
    if k_qfn is not None:
        k = straight_through(k_qfn)(k)
    if v_qfn is not None:
        v = straight_through(v_qfn)(v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    hooks = _Hooks(scale, causal, q_offset, p_qfn, out_qfn, err_qfn)
    if train:
        return _FlashAttention.apply(q, k, v, hooks)
    return _forward(q, k, v, hooks, save=False)[0]


flash_attention.launches = 0            # single-pass kernel
flash_attention.two_pass_launches = 0   # two-pass kernel
flash_attention.lse_launches = 0        # either, in its training form
flash_bwd_di.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
