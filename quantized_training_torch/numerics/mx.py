"""Block reshaping for block-scaled formats (group-affine, microscaling).

``reshape_to_blocks`` pads each block axis to a multiple of ``block_size``
and splits it into (num_blocks, block_size) (reference:
src/quantized_training/mx_utils.py:62-121).  The shared-exponent helpers
come with the numerics port.
"""

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["reshape_to_blocks", "normalize_axes"]


def normalize_axes(axes: Union[int, Sequence[int]], ndim: int) -> List[int]:
    """Axes as a sorted list of non-negative ints."""
    if isinstance(axes, int):
        axes = [axes]
    return sorted(a + ndim if a < 0 else a for a in axes)


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
