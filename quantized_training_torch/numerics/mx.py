"""Microscaling (MX) block utilities: shared exponents and block reshaping
(reference: numerics/mx.py, mx_utils.py:16-134).

``reshape_to_blocks`` pads each block axis to a multiple of ``block_size``
and splits it into (num_blocks, block_size).
"""

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .bitutils import F32_EXP_MASK, f32_bits

__all__ = ["shared_exponents", "reshape_to_blocks", "undo_reshape_to_blocks",
           "normalize_axes", "floor_log2_f32"]

FP32_MIN_NORMAL = 2.0 ** -126


def normalize_axes(axes: Union[int, Sequence[int]], ndim: int) -> List[int]:
    """Axes as a sorted list of non-negative ints."""
    if isinstance(axes, int):
        axes = [axes]
    return sorted(a + ndim if a < 0 else a for a in axes)


def floor_log2_f32(a: torch.Tensor) -> torch.Tensor:
    """floor(log2|a|) from the float32 exponent field; subnormals are
    normalized by an exact 2**64 scaling first.  Zeros are the caller's."""
    af = a.abs().to(torch.float32)
    exp = ((f32_bits(af) & F32_EXP_MASK) >> 23) - 127
    exp_up = ((f32_bits(af * 2.0 ** 64) & F32_EXP_MASK) >> 23) - 127 - 64
    return torch.where(exp == -127, exp_up, exp)


def shared_exponents(a: torch.Tensor, method: str = "max",
                     axes: Sequence[int] = None,
                     ebits: int = 0) -> torch.Tensor:
    """Shared exponent per block, floor(log2(max |a|)) over ``axes``, with
    the reference's overflow-to-NaN / underflow-to--emax bounds when
    ``ebits`` bounds the exponent format."""
    if method == "max":
        if axes is None:
            shared = a.abs().max()
        else:
            shared = a.abs()
            for axis in axes:
                shared = torch.amax(shared, dim=axis, keepdim=True)
    elif method == "none":
        shared = a.abs()
    else:
        raise ValueError(f"Unrecognized shared exponent method {method}")

    shared = torch.where(shared == 0, FP32_MIN_NORMAL, shared)
    shared_exp = floor_log2_f32(shared).to(a.dtype)
    if ebits > 0:
        emax = 2 ** (ebits - 1) - 1
        shared_exp = torch.where(shared_exp > emax, float("nan"), shared_exp)
        shared_exp = torch.where(shared_exp < -emax, float(-emax), shared_exp)
    return shared_exp


def reshape_to_blocks(
    a: torch.Tensor, axes: Sequence[int], block_size: int
) -> Tuple[torch.Tensor, List[int], Tuple[int, ...], Tuple[int, ...]]:
    """Split each axis in ``axes`` into (ceil(n/block), block) tiles.

    Returns ``(blocked, shifted_axes, orig_shape, padded_shape)`` where
    ``orig_shape``/``padded_shape`` describe the intermediate tensor with
    the singleton tile dims inserted.
    """
    if axes is None:
        raise ValueError("axes required to determine block dimensions")
    if block_size == 0:
        raise ValueError("block_size == 0 in reshape_to_blocks")

    axes = normalize_axes(axes, a.dim())

    # Insert a tile dimension after each block axis.
    shifted = []
    for i, axis in enumerate(axes):
        axis += i
        shifted.append(axis)
        a = a.unsqueeze(axis + 1)
    axes = shifted

    orig_shape = tuple(a.shape)
    pad = [0] * (2 * a.dim())          # F.pad order: last dim first
    for axis in axes:
        size = orig_shape[axis]
        if size % block_size != 0:
            pad[2 * (a.dim() - 1 - axis) + 1] = block_size - size % block_size
    if any(pad):
        a = F.pad(a, pad)

    padded_shape = tuple(a.shape)
    new_shape = list(padded_shape)
    for axis in axes:
        if new_shape[axis] >= block_size:
            assert new_shape[axis] % block_size == 0
            new_shape[axis + 1] = block_size
            new_shape[axis] = new_shape[axis] // block_size
        else:
            new_shape[axis + 1] = new_shape[axis]
            new_shape[axis] = 1

    return a.reshape(new_shape), axes, orig_shape, padded_shape


def undo_reshape_to_blocks(a: torch.Tensor, padded_shape: Sequence[int],
                           orig_shape: Sequence[int],
                           axes: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`reshape_to_blocks`."""
    a = a.reshape(padded_shape)
    if list(padded_shape) != list(orig_shape):
        a = a[tuple(slice(0, s) for s in orig_shape)]
    for axis in reversed(list(axes)):
        a = a.squeeze(axis + 1)
    return a
