"""8-bit blockwise Adam: optimizer state at about 1/4 of f32 (reference:
training/optim8bit.py, after Dettmers et al., 2022).

Both moments are stored blockwise (``block_size`` consecutive elements of
the flattened parameter share one f32 scale): m as signed int8 codes of
m / (absmax / 127), v as uint8 codes of sqrt(v) / (max / 255), decoded by
squaring.  They are requantized after every update.  A parameter keeps one
of three kinds of state, told apart by the code dtype as in the reference:

  * f32: parameters under ``min_8bit_size`` elements keep exact moments
    (the norms); the scale slot holds a (1,) placeholder;
  * int32: blocks of 256 whose row count is a multiple of 512 (every matmul
    weight of the LLaMA models) are packed four codes to a word with
    lane-tiled scales (ops/adam8bit_step.py); on CUDA kernel 14 updates
    them;
  * int8 / uint8: every other 8-bit leaf, codes (nb, block) and scales
    (nb,) (BERT's hidden-768 weights, for one); on CUDA kernel 13 updates
    them.
The 8-bit leaves' update is the fused kernels' wrapper, which runs the
plain version for CPU tensors.

:class:`Adam8bit` is ``optax.chain(scale_by_adam8bit, add_decayed_weights,
scale_by_learning_rate)`` followed by ``apply_updates``, with the same f32
roundings: the bias corrections 1 - b**count are f32 powers of an f32
count, divisions and square roots are correctly rounded on both devices,
and the update is applied as u * (-lr), then p + that.
"""

from typing import Optional

import numpy as np
import torch

from ..ops.adam8bit_step import (adam_constants, div_rn,
                                 fused_adam8bit_update,
                                 fused_adam8bit_update_packed,
                                 pack_moment_rows, pack_scale_rows,
                                 packable_rows, sqrt_rn)

__all__ = ["Adam8bit", "ScaleByAdam8bit", "adam8bit", "scale_by_adam8bit",
           "state_nbytes"]


def _pad_len(n: int, block: int) -> int:
    return (block - n % block) % block


def _quantize_signed(x: torch.Tensor, block: int):
    """Flattened blockwise-linear signed int8: (codes (nb, block), scales
    (nb,))."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, _pad_len(flat.numel(), block)))
    blocks = flat.reshape(-1, block)
    absmax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    scale = torch.where(absmax > 0, div_rn(absmax, 127.0),
                        torch.ones_like(absmax)).to(torch.float32)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale[:, 0]


def _dequantize_signed(codes, scale, shape):
    n = int(np.prod(shape, dtype=np.int64))
    flat = (codes.to(torch.float32) * scale[:, None]).reshape(-1)
    return flat[:n].reshape(shape)


def _quantize_sqrt(x: torch.Tensor, block: int):
    """uint8 of sqrt(x) with per-block max (x >= 0)."""
    flat = sqrt_rn(x.reshape(-1))
    flat = torch.nn.functional.pad(flat, (0, _pad_len(flat.numel(), block)))
    blocks = flat.reshape(-1, block)
    mx = torch.amax(blocks, dim=1, keepdim=True)
    scale = torch.where(mx > 0, div_rn(mx, 255.0),
                        torch.ones_like(mx)).to(torch.float32)
    codes = torch.clamp(torch.round(blocks / scale), 0, 255).to(torch.uint8)
    return codes, scale[:, 0]


def _dequantize_sqrt(codes, scale, shape):
    n = int(np.prod(shape, dtype=np.int64))
    root = (codes.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return (root * root).reshape(shape)


def bias_corrections(b1: float, b2: float, count: int):
    """(1 - b1**count, 1 - b2**count) as f32 values, computed as the
    reference does (an f32 power of the f32 count)."""
    c = torch.tensor(float(count), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    return tuple(float(one - torch.tensor(b, dtype=torch.float32) ** c)
                 for b in (b1, b2))


class ScaleByAdam8bit:
    """The Adam moment core with 8-bit blockwise state, per leaf (reference:
    ``scale_by_adam8bit``): ``init(p)`` makes a leaf's state, ``update(g,
    state, count)`` returns the bias-corrected update and writes the new
    moments into ``state``."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 block_size: int = 256, min_8bit_size: int = 4096):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.block_size, self.min_8bit_size = block_size, min_8bit_size

    def _packed(self, p) -> bool:
        if self.block_size != 256:
            return False
        n = p.numel()
        return packable_rows((n + _pad_len(n, 256)) // 256)

    def init(self, p: torch.Tensor) -> dict:
        """{"mu_codes", "mu_scale", "nu_codes", "nu_scale"} of zeros, on
        ``p``'s device."""
        dev = p.device
        if p.numel() < self.min_8bit_size:
            zero = torch.zeros((1,), dtype=torch.float32, device=dev)
            return dict(mu_codes=torch.zeros_like(p, dtype=torch.float32),
                        mu_scale=zero,
                        nu_codes=torch.zeros_like(p, dtype=torch.float32),
                        nu_scale=zero.clone())
        zeros = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        mc, ms = _quantize_signed(zeros, self.block_size)
        vc, vs = _quantize_sqrt(zeros, self.block_size)
        if self._packed(p):
            mc, vc = pack_moment_rows(mc), pack_moment_rows(vc)
            ms, vs = pack_scale_rows(ms), pack_scale_rows(vs)
        return dict(mu_codes=mc, mu_scale=ms, nu_codes=vc, nu_scale=vs)

    def update(self, g: torch.Tensor, state: dict, count: int) -> torch.Tensor:
        b1, omb1, b2, omb2, eps = adam_constants(self.b1, self.b2, self.eps)
        bc1, bc2 = bias_corrections(self.b1, self.b2, count)
        g = g.to(torch.float32)
        kind = state["mu_codes"].dtype
        if kind == torch.float32:                     # exact small leaf
            m = b1 * state["mu_codes"] + omb1 * g
            v = b2 * state["nu_codes"] + omb2 * g * g
            state["mu_codes"], state["nu_codes"] = m, v
            return div_rn(m, bc1) / (sqrt_rn(div_rn(v, bc2)) + eps)
        block = self.block_size
        flat = g.reshape(-1)
        pad = _pad_len(flat.numel(), block)
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        g2d = flat.reshape(-1, block).contiguous()
        fused = (fused_adam8bit_update_packed if kind == torch.int32
                 else fused_adam8bit_update)
        upd, mc, ms, vc, vs = fused(
            g2d, state["mu_codes"], state["mu_scale"], state["nu_codes"],
            state["nu_scale"], bc1, bc2, b1=self.b1, b2=self.b2,
            eps=self.eps)
        state.update(mu_codes=mc, mu_scale=ms, nu_codes=vc, nu_scale=vs)
        return upd.reshape(-1)[:g.numel()].reshape(g.shape)


def scale_by_adam8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      block_size: int = 256,
                      min_8bit_size: int = 4096) -> ScaleByAdam8bit:
    return ScaleByAdam8bit(b1, b2, eps, block_size, min_8bit_size)


class Adam8bit(torch.optim.Optimizer):
    """Adam(W) with 8-bit blockwise moment state (reference: ``adam8bit``).

    Per parameter, ``state[p]`` holds ``count`` (steps taken, an int) and
    the moment tensors of :meth:`ScaleByAdam8bit.init`.  A step updates
    the moments, adds ``weight_decay * p`` to the update when set, scales
    it by -lr and adds it to p.  The new moments replace the old tensors;
    p is updated in place."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, block_size: int = 256,
                 min_8bit_size: int = 4096,
                 weight_decay: Optional[float] = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      block_size=block_size,
                                      min_8bit_size=min_8bit_size,
                                      weight_decay=weight_decay))

    def load_state_dict(self, state_dict: dict) -> None:
        """As torch's, but the moments keep their dtypes (torch casts every
        floating parameter's state tensors to the parameter's dtype, which
        would turn codes and words into floats)."""
        super().load_state_dict(state_dict)
        params = [p for g in self.param_groups for p in g["params"]]
        saved = state_dict["state"]
        for index, p in enumerate(params):
            if index in saved:
                self.state[p] = {
                    k: v.to(p.device) if torch.is_tensor(v) else v
                    for k, v in saved[index].items()}

    def _core(self, group) -> ScaleByAdam8bit:
        b1, b2 = group["betas"]
        return ScaleByAdam8bit(b1, b2, group["eps"], group["block_size"],
                               group["min_8bit_size"])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            core = self._core(group)
            wd = group["weight_decay"]
            neg_lr = float(np.float32(-group["lr"]))
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(core.init(p), count=0)
                state["count"] += 1
                upd = core.update(p.grad, state, state["count"])
                if wd:
                    upd = upd + float(np.float32(wd)) * p
                upd = upd * neg_lr
                p.copy_((p + upd).to(p.dtype))
        return loss


def adam8bit(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, block_size: int = 256,
             min_8bit_size: int = 4096,
             weight_decay: Optional[float] = None) -> Adam8bit:
    """:class:`Adam8bit` with the reference's argument names."""
    return Adam8bit(params, learning_rate, (b1, b2), eps, block_size,
                    min_8bit_size, weight_decay)


def state_nbytes(optimizer: torch.optim.Optimizer) -> int:
    """Total bytes of an optimizer's state tensors, with 4 for each step
    count (the reference's one int32 count is counted once)."""
    total, counted = 0, False
    for state in optimizer.state.values():
        for key, val in state.items():
            if torch.is_tensor(val):
                total += val.numel() * val.element_size()
            elif key == "count" and not counted:
                total, counted = total + 4, True
    return total
