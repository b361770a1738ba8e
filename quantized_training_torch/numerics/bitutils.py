"""Bit-level helpers shared by the numerics code.

Only the helpers the serving slice needs are here; the posit / FP8 bit
manipulation they support elsewhere comes with the numerics port.
"""

import torch

__all__ = ["materialize_rounding", "clamp_keep_zero_sign"]


def materialize_rounding(x: torch.Tensor) -> torch.Tensor:
    """Identity in eager PyTorch.

    Its counterpart exists because a fusing compiler may elide an
    f32->bf16->f32 convert chain inside a fused region, so a value that is
    nominally bf16 reaches a quantizer unrounded.  Eager PyTorch runs every
    op on its own and writes its result in the tensor's dtype, so the
    rounding has already happened; the call is kept so that the code reads
    like the reference at each quantizer boundary.
    """
    return x


def clamp_keep_zero_sign(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """torch.clamp semantics spelled with ``where``: lanes already inside
    [lo, hi] are untouched, so a -0 with lo <= 0 keeps its sign bit."""
    lo_t = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.where(x < lo_t, lo_t, torch.where(x > hi_t, hi_t, x))
