"""NormalFloat (NF4-style) codebook quantization (reference:
numerics/normal_float.py): codebook values are normal-distribution
quantiles, optionally with one extra positive value, normalized to [-1, 1]
and optionally scaled to integers for ``nfK_B`` formats.  The codebook is
built once on the host with scipy; the quantize step is a nearest-value
search over at most 16 entries, first index on ties."""

import functools
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["create_normal_map", "quantize_to_nf", "nf_codebook"]

_CHUNK = 1 << 20


@functools.lru_cache(maxsize=None)
def _normal_map_np(offset: float, use_extra_value: bool, k: int) -> np.ndarray:
    from scipy.stats import norm

    num_values = 2 ** (k - 1)
    if use_extra_value:
        v1 = norm.ppf(np.linspace(offset, 0.5, num_values + 1)[:-1]).tolist()
        v2 = [0.0]
        v3 = (-norm.ppf(np.linspace(offset, 0.5, num_values)[:-1])).tolist()
    else:
        v1 = norm.ppf(np.linspace(offset, 0.5, num_values)[:-1]).tolist()
        v2 = [0.0] * 2
        v3 = (-norm.ppf(np.linspace(offset, 0.5, num_values)[:-1])).tolist()
    values = np.sort(np.asarray(v1 + v2 + v3, dtype=np.float32))
    values = values / values.max()
    if values.size != 2 ** k:
        raise ValueError(f"nf{k} codebook has {values.size} entries")
    return values


def create_normal_map(offset: float = 0.9677083, use_extra_value: bool = True,
                      k: int = 4) -> torch.Tensor:
    """Normalized normal-quantile codebook with 2**k entries in [-1, 1]."""
    return torch.from_numpy(_normal_map_np(offset, use_extra_value, k).copy())


def nf_codebook(k: int = 4, use_extra_value: bool = True,
                int_bits: Optional[int] = None, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Codebook of ``nfK`` / ``nfK_B`` in ``dtype``."""
    values = create_normal_map(k=k, use_extra_value=use_extra_value)
    if int_bits is not None:
        values = torch.round(values * (2 ** (int_bits - 1) - 1))
    return values.to(dtype=dtype, device=device)


def quantize_to_nf(x: torch.Tensor, k: int = 4, use_extra_value: bool = True,
                   int_bits: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 codebook indices, codebook in ``x.dtype``) of the nearest
    entry; ties take the lowest index."""
    values = nf_codebook(k, use_extra_value, int_bits, x.dtype, x.device)
    lo, hi = values.min(), values.max()
    # the search builds a (n, 2**k) distance tensor: a 4096 x 11008 f32
    # weight would take 2.9 GB at once, so it runs over slices of the
    # flattened input (each element's search is independent: same bits)
    flat = x.reshape(-1)
    indices = torch.empty(flat.shape, dtype=torch.int32, device=x.device)
    for s in range(0, flat.numel(), _CHUNK):
        part = torch.clamp(flat[s:s + _CHUNK], lo, hi)
        indices[s:s + _CHUNK] = torch.argmin((values - part[:, None]).abs(),
                                             dim=-1)
    return indices.reshape(x.shape), values
