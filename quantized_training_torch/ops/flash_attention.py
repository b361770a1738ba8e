"""Causal GQA flash attention forward (``csrc/flash_attn_fwd.cu``).

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
    (after the single-pass kernel, it is the rounding kernel's own pass).
On CUDA a hook must be a ``numerics.quantize_fn`` callable, whose format the
kernels read.  ``err_qfn`` (the backward's error taps) and the logsumexp
output for the backward come with the backward kernels.
"""

import ctypes
import math
from typing import Optional

import torch

from . import _cuda
from ..numerics import QuantFn
from ..quantize.fake_quant import straight_through

__all__ = ["flash_attention", "naive_attention", "NEG_INF"]

NEG_INF = -2.0 ** 30  # large-but-safe additive mask


def _plain(fn):
    """A hook's plain PyTorch rounding (any device)."""
    return fn.plain if isinstance(fn, QuantFn) else fn


def naive_attention(q, k, v, *, scale: float, causal: bool = True,
                    q_offset: int = 0, p_qfn=None,
                    out_qfn=None) -> torch.Tensor:
    """The plain version: full (B, H, S, T) scores in f32.  Without
    ``p_qfn``: softmax, p rounded to v's dtype, f32-accumulated p @ v.  With
    it: p = exp(s - logsumexp(s)), rounded to bf16 and through ``p_qfn``,
    then the f32 p @ v.  ``out_qfn`` rounds the output in q's dtype.  Every
    rounding is the plain PyTorch one, on any device."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=1)
        v = torch.repeat_interleave(v, H // KV, dim=1)
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * scale
    if causal:
        q_pos = torch.arange(S, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(T, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))
    if p_qfn is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
        p = _plain(p_qfn)(p.to(torch.bfloat16)).to(torch.float32)
    out = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    out = out.to(q.dtype)
    return out if out_qfn is None else _plain(out_qfn)(out)


def _lib():
    lib = _cuda.load("flash_attn_fwd")
    if lib.flash_attn_fwd.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attn_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                       cf, ci, ci, vp]
        lib.flash_attn_fwd.restype = ci
        lib.flash_attn_fwd_two_pass.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, ci, ci,
            _cuda.QtFormat, _cuda.QtFormat, vp]
        lib.flash_attn_fwd_two_pass.restype = ci
    return lib


def _kernel_format(fn, name):
    if fn is None:
        return None
    if not isinstance(fn, QuantFn) or fn.fmt is None:
        raise ValueError(f"flash_attention kernel: {name} must be a "
                         f"quantize_fn callable with a kernel format, got "
                         f"{fn!r}")
    return fn.fmt


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = True, q_offset: int = 0,
                    q_qfn=None, k_qfn=None, p_qfn=None, v_qfn=None,
                    out_qfn=None, err_qfn=None) -> torch.Tensor:
    """Causal flash attention forward.

    CPU tensors take :func:`naive_attention`; CUDA tensors launch the
    single-pass kernel, or the two-pass one when ``p_qfn`` is set (bf16, D
    in {64, 128}, any S and T), and anything they do not take raises.
    """
    if err_qfn is not None:
        raise NotImplementedError(
            "flash_attention err_qfn (the backward's error taps) comes with "
            "the flash backward kernels")
    if q.device.type == "cuda":
        for name, fn in (("q_qfn", q_qfn), ("k_qfn", k_qfn),
                         ("v_qfn", v_qfn)):
            _kernel_format(fn, name)
    # hoisted operand roundings, straight-through
    if q_qfn is not None:
        q = straight_through(q_qfn)(q)
    if k_qfn is not None:
        k = straight_through(k_qfn)(k)
    if v_qfn is not None:
        v = straight_through(v_qfn)(v)
    B, H, S, D = q.shape
    _, KV, T, _ = k.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return naive_attention(q, k, v, scale=scale, causal=causal,
                               q_offset=q_offset, p_qfn=p_qfn,
                               out_qfn=out_qfn)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    p_fmt = _kernel_format(p_qfn, "p_qfn")
    out_fmt = _kernel_format(out_qfn, "out_qfn")
    problems = []
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        problems.append("q, k, v must be bf16")
    if H % KV or tuple(v.shape) != tuple(k.shape) or k.shape[0] != B \
            or k.shape[3] != D or D not in (64, 128):
        problems.append(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                        f"v {tuple(v.shape)} (D must be 64 or 128)")
    if any(not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16
           for t in (q, k, v)):
        problems.append("q, k, v must be contiguous, 16-byte aligned and on "
                        "one device")
    if q_offset < 0:
        problems.append(f"q_offset={q_offset}")
    if problems:
        raise ValueError("flash_attention kernel: " + "; ".join(problems))
    out = torch.empty_like(q)
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, S, T, D, float(scale), int(bool(causal)), int(q_offset))
    stream = _cuda.stream_ptr(q.device)
    if p_fmt is None:
        err = lib.flash_attn_fwd(*args, stream)
        _cuda.check(lib, err, "flash_attn_fwd")
        flash_attention.launches += 1
        return out if out_qfn is None else out_qfn(out)
    err = lib.flash_attn_fwd_two_pass(*args, _cuda.qt_format(p_fmt),
                                      _cuda.qt_format(out_fmt), stream)
    _cuda.check(lib, err, "flash_attn_fwd_two_pass")
    flash_attention.two_pass_launches += 1
    return out


flash_attention.launches = 0            # single-pass kernel
flash_attention.two_pass_launches = 0   # two-pass kernel
