"""W8A8 integer GEMM: int8 weights times dynamically int8-quantized
activations, accumulated exactly in int32, then rescaled by the rank-1
outer product of the two scale vectors.

Weights are int8 codes with one f32 scale per output channel
(``pack_int8_weights``); activations are quantized per row (per token) on
the fly.  ``w8a8_matmul(x, *pack_int8_weights(w))`` equals
``dequant(quant(x)) @ dequant(quant(w))`` evaluated in f32 after an exact
integer dot.  In the JAX package this is an XLA s8 x s8 -> s32 dot, not a
Pallas kernel; on CUDA the port runs it through ``torch._int_mm`` (cuBLAS
int8), on the CPU through an exact float64 product of the codes.
"""

from typing import Tuple

import torch

__all__ = ["pack_int8_weights", "quantize_int8_rowwise", "w8a8_matmul"]


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, correctly rounded on every device (PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal)."""
    return t / torch.tensor(127.0, device=t.device)


def pack_int8_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float weights -> (int8 codes (K, N), f32 scales (N,)),
    per-output-channel symmetric: scale = amax(|w[:, n]|) / 127."""
    wf = w.to(torch.float32)
    scale = _div127(wf.abs().amax(dim=0))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return codes.to(torch.int8), scale


def quantize_int8_rowwise(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float activations -> (int8 codes, f32 scales (M,)), per-row
    symmetric."""
    xf = x.to(torch.float32)
    scale = _div127(xf.abs().amax(dim=1))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product of (M, K) and (K, N) codes."""
    if a.device.type == "cpu":
        # |sum| <= 127^2 K < 2^53: every partial sum is exact in float64
        return torch.matmul(a.to(torch.float64),
                            b.to(torch.float64)).to(torch.int32)
    M, K = a.shape
    N = b.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"w8a8_matmul on CUDA: K={K} and N={N} must be "
                         "multiples of 8 (torch._int_mm)")
    # torch._int_mm takes at least 17 rows, a multiple of 8: pad with zero
    # rows, which add nothing, and slice the result back
    rows = max(32, -(-M // 8) * 8)
    if rows != M:
        a = torch.cat([a, a.new_zeros((rows - M, K))])
    return torch._int_mm(a, b)[:M]


def w8a8_matmul(x: torch.Tensor, w_codes: torch.Tensor,
                w_scale: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y = dequant(quant_rowwise(x)) @ dequant(w_codes): an exact int8 dot
    and the rank-1 rescale.  x (M, K) float; w_codes (K, N) int8; w_scale
    (N,) f32."""
    out_dtype = out_dtype or x.dtype
    x_codes, x_scale = quantize_int8_rowwise(x)
    acc = _int_dot(x_codes, w_codes.contiguous())
    y = acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]
    return y.to(out_dtype)
