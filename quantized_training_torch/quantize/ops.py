"""Functional quantized-tensor ops (reference: quantize/ops.py,
decomposed.py:166-561): block-expanded scales, quantize / dequantize with a
direct quantizer, the microscaling qparams, the dequantize-then-compute MX
GEMMs and convolution, and the outlier split with its residual matmul and
CSR export."""

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..numerics import normalize_axes, reshape_to_blocks, shared_exponents
from ..numerics.bitutils import bits_f32

__all__ = ["expand_scale", "quantize", "dequantize", "calculate_mx_qparam",
           "quantize_mx", "linear_mx", "matmul_mx", "conv2d_mx",
           "filter_outlier", "outlier_matmul", "to_csr"]


def expand_scale(
    scale: torch.Tensor, shape: Sequence[int], block_size: int
) -> torch.Tensor:
    """Broadcast per-block scales back to the full tensor shape.

    Matches the reference ``expand`` (decomposed.py:127-140): unsqueeze
    leading dims, repeat each mismatching dim by ``block_size``, then crop
    any padding overhang.
    """
    shape = tuple(shape)
    while scale.dim() < len(shape):
        scale = scale.unsqueeze(0)
    for dim in range(len(shape)):
        if scale.shape[dim] != shape[dim]:
            scale = torch.repeat_interleave(scale, block_size, dim=dim)
    if tuple(scale.shape) != shape:
        scale = scale[tuple(slice(0, s) for s in shape)]
    return scale


def quantize(x: torch.Tensor, scale: torch.Tensor,
             zero_point: Optional[torch.Tensor] = None,
             block_size: Optional[int] = None, qfn=None) -> torch.Tensor:
    """``qfn(x / scale + zero_point)`` with block-expanded qparams."""
    if qfn is None:
        raise ValueError("qfn must be provided for quantization")
    if block_size is not None:
        scale = expand_scale(scale, x.shape, block_size)
        if zero_point is not None:
            zero_point = expand_scale(zero_point, x.shape, block_size)
    x = x / scale if zero_point is None else x / scale + zero_point
    return qfn(x)


def dequantize(x: torch.Tensor, scale: torch.Tensor,
               zero_point: Optional[torch.Tensor] = None,
               block_size: Optional[int] = None,
               input_codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(decode(x) - zero_point) * scale``."""
    if input_codebook is not None:
        x = input_codebook[x.long()].to(x.dtype)
    if block_size is not None:
        scale = expand_scale(scale, x.shape, block_size)
        if zero_point is not None:
            zero_point = expand_scale(zero_point, x.shape, block_size)
    return x * scale if zero_point is None else (x - zero_point) * scale


def calculate_mx_qparam(
    x: torch.Tensor,
    axes: Union[int, Tuple[int, ...]],
    block_size: int,
    quant_max: float,
    force_scale_power_of_two: bool = False,
    scale_qfn=None,
) -> torch.Tensor:
    """Per-block scales for microscaling: blockwise amax / quant_max
    (optionally rounded through ``scale_qfn``), or power-of-two shared
    exponents offset by floor(log2(quant_max)) (reference:
    decomposed.py:366-419)."""
    if block_size <= 0:
        raise ValueError(f"block_size={block_size}")
    axes = normalize_axes(axes, x.dim())
    blocked, baxes, _, _ = reshape_to_blocks(x, axes, block_size)
    shared_axes = tuple(a + 1 for a in baxes)

    if force_scale_power_of_two:
        shared_exp = shared_exponents(blocked, method="max", axes=shared_axes,
                                      ebits=0)
        shared_exp = shared_exp - math.floor(math.log2(quant_max))
        for axis in reversed(baxes):
            shared_exp = shared_exp.squeeze(axis + 1)
        bits = torch.clamp(shared_exp.to(torch.int32) + 127, 0, 255) << 23
        scale = bits_f32(bits).to(x.dtype)
    else:
        amax = torch.amax(blocked.abs(), dim=shared_axes)
        # amax / quant_max as the CPU computes it (an f32 quotient rounded
        # to amax's dtype), on every device: CUDA divides by a Python
        # scalar through its reciprocal, which would move scales off the
        # CPU's bits
        scale = (amax.to(torch.float32) / torch.tensor(
            float(quant_max), dtype=torch.float32, device=amax.device)
                 ).to(amax.dtype)
        if scale_qfn is not None:
            scale = scale_qfn(scale)
    return torch.where(scale > 0.0, scale, torch.ones_like(scale))


def quantize_mx(x: torch.Tensor, qfn, axes: Union[int, Tuple[int, ...]],
                block_size: int, quant_max: float,
                force_scale_power_of_two: bool = False,
                scale_qfn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-scale quantization: ``(scale, qfn(x / scale))``."""
    scale = calculate_mx_qparam(x, tuple(normalize_axes(axes, x.dim())),
                                block_size, quant_max,
                                force_scale_power_of_two, scale_qfn)
    return scale, quantize(x, scale, None, block_size, qfn)


def _decode_and_rescale(x: torch.Tensor, scale: Optional[torch.Tensor],
                        codebook: Optional[torch.Tensor],
                        block_size: Optional[int]) -> torch.Tensor:
    """Codebook indices to values (in ``x``'s dtype), then times the
    block-expanded scale."""
    if codebook is not None:
        x = codebook[x.long()].to(x.dtype)
    if scale is not None:
        x = x * expand_scale(scale, x.shape, block_size)
    return x


def linear_mx(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              input_scale: Optional[torch.Tensor] = None,
              weight_scale: Optional[torch.Tensor] = None,
              block_size: Optional[int] = None,
              input_codebook: Optional[torch.Tensor] = None,
              weight_codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize-then-linear (reference: decomposed.py:304-333);
    ``weight`` is (out, in)."""
    x = _decode_and_rescale(x, input_scale, input_codebook, block_size)
    w = _decode_and_rescale(weight, weight_scale, weight_codebook, block_size)
    out = torch.matmul(x, w.T)
    return out if bias is None else out + bias


def matmul_mx(a: torch.Tensor, b: torch.Tensor, *,
              input_scale: Optional[torch.Tensor] = None,
              weight_scale: Optional[torch.Tensor] = None,
              block_size: Optional[int] = None,
              input_codebook: Optional[torch.Tensor] = None,
              weight_codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize-then-matmul (reference: decomposed.py:336-363)."""
    a = _decode_and_rescale(a, input_scale, input_codebook, block_size)
    b = _decode_and_rescale(b, weight_scale, weight_codebook, block_size)
    return torch.matmul(a, b)


def conv2d_mx(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride=1, padding=0,
              dilation=1, groups: int = 1, *,
              input_scale: Optional[torch.Tensor] = None,
              weight_scale: Optional[torch.Tensor] = None,
              block_size: Optional[int] = None,
              input_codebook: Optional[torch.Tensor] = None,
              weight_codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize-then-conv2d in NCHW / OIHW (reference:
    decomposed.py:265-301): the products summed in f32 and rounded to
    ``x``'s dtype, as the reference's ``preferred_element_type=f32``."""
    x = _decode_and_rescale(x, input_scale, input_codebook, block_size)
    w = _decode_and_rescale(weight, weight_scale, weight_codebook, block_size)
    out = F.conv2d(x.to(torch.float32), w.to(torch.float32), None, stride,
                   padding, dilation, groups).to(x.dtype)
    return out if bias is None else out + bias[None, :, None, None]


def filter_outlier(x: torch.Tensor, threshold: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``x`` into dense (inlier, outlier) parts at |x| > threshold
    (the reference converts outliers to CSR, decomposed.py:451-561; here,
    as in the JAX package, they stay dense: :func:`to_csr` packs them)."""
    is_outlier = x.abs() > threshold
    zero = torch.zeros_like(x)
    return torch.where(is_outlier, zero, x), torch.where(is_outlier, x, zero)


def outlier_matmul(outlier: torch.Tensor, b: torch.Tensor,
                   b_scale: Optional[torch.Tensor] = None,
                   b_codebook: Optional[torch.Tensor] = None,
                   block_size: Optional[int] = None,
                   weight_transposed: bool = False) -> torch.Tensor:
    """The outlier part's residual matmul (reference spmm_csr semantics,
    decomposed.py:513-561, computed dense)."""
    b = _decode_and_rescale(b, b_scale, b_codebook, block_size)
    if weight_transposed:
        b = b.T
    out2d = torch.matmul(outlier.reshape(-1, outlier.shape[-1]), b)
    return out2d.reshape(*outlier.shape[:-1], b.shape[-1])


def to_csr(dense, max_nnz: int):
    """Host-side CSR packing of an outlier tensor, padded to ``max_nnz``
    (reference: decomposed.py:451-487): ``(data, indices, indptr)`` as
    numpy arrays; past ``max_nnz`` the tail is cut and ``indptr`` clamped,
    so no row pointer reads past the padded arrays."""
    if isinstance(dense, torch.Tensor):
        dense = dense.detach().cpu().float().numpy()
    arr = np.asarray(dense, dtype=np.float32).reshape(-1, dense.shape[-1])
    r, c = np.nonzero(arr)
    data = arr[r, c]
    indptr = np.zeros(arr.shape[0] + 1, dtype=np.int32)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    actual = min(data.size, max_nnz)
    data_p = np.zeros(max_nnz, dtype=np.float32)
    idx_p = np.zeros(max_nnz, dtype=np.int32)
    data_p[:actual] = data[:actual]
    idx_p[:actual] = c[:actual]
    return data_p, idx_p, np.minimum(indptr, actual).astype(np.int32)
