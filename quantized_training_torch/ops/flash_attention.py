"""Causal GQA flash attention forward (``csrc/flash_attn_fwd.cu``).

Interface shapes: q (B, H, S, D); k, v (B, KV, T, D) with H % KV == 0;
output (B, H, S, D) in q's dtype.  ``q_offset`` is the absolute position
of q[0].  This slice ports the single-pass forward without quantization
hooks; the probability / output rounding hooks and the backward come with
slices 2 and 3.
"""

import ctypes
import math
from typing import Optional

import torch

from . import _cuda

__all__ = ["flash_attention", "naive_attention", "NEG_INF"]

NEG_INF = -2.0 ** 30  # large-but-safe additive mask


def naive_attention(q, k, v, *, scale: float, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """The plain version: full (B, H, S, T) scores in f32, softmax, p rounded
    to v's dtype before the f32-accumulated p @ v."""
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
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


def _lib():
    lib = _cuda.load("flash_attn_fwd")
    if lib.flash_attn_fwd.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                       ctypes.c_float, ci, ci, vp]
        lib.flash_attn_fwd.restype = ci
    return lib


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = True, q_offset: int = 0,
                    q_qfn=None, k_qfn=None, p_qfn=None, v_qfn=None,
                    out_qfn=None, err_qfn=None) -> torch.Tensor:
    """Causal flash attention forward.

    CPU tensors take :func:`naive_attention`; CUDA tensors launch the kernel
    (bf16, D in {64, 128}, any S and T), and anything it does not take
    raises.  The quantization hooks are not ported yet and raise.
    """
    if any(f is not None for f in (q_qfn, k_qfn, p_qfn, v_qfn, out_qfn,
                                   err_qfn)):
        raise NotImplementedError(
            "flash_attention quantization hooks come with slice 2")
    B, H, S, D = q.shape
    _, KV, T, _ = k.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return naive_attention(q, k, v, scale=scale, causal=causal,
                               q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
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
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KV, S, T, D, float(scale), int(bool(causal)), int(q_offset),
        _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "flash_attn_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
