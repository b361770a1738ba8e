"""Functional quantized-tensor ops.  This slice carries ``expand_scale``;
the rest of the op library comes with the fake-quant port."""

from typing import Sequence

import torch

__all__ = ["expand_scale"]


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
