"""Quantization-aware building blocks.

Quantization is built into the modules, driven by a static
:class:`QuantConfig` that is consulted with (module path, op, category,
index) at every site (reference: quantize.py:52-193,
modules/qat/linear.py:40-41).  Each module is constructed with its dotted
``path`` -- the same path the reference annotator matches against.

This slice serves with packed weight storage only, so no activation,
weight or error quantization is live: a site whose config resolves a spec
raises NotImplementedError (the fake-quant sites come with slice 2).
"""

from typing import Optional

import torch
import torch.nn as nn

from ..ops.affine_storage import affine_matmul
from ..quantize.config import OpCategory, QuantConfig
from ..quantize.storage import _eligible

__all__ = ["QuantMixin", "QDense", "QRMSNorm", "Embed"]


class QuantMixin:
    """Config-driven quantization points for a module with ``qconfig`` and
    ``path`` attributes.  Every helper is a no-op when the config resolves
    no spec, so the same module serves float and stored-weight execution."""

    qconfig: Optional[QuantConfig]
    path: str

    def _site_error(self, site: str, spec):
        raise NotImplementedError(
            f"{self.path}: quantization site {site} ({spec}) comes with "
            "slice 2 (the fake-quant port)")

    def quant_input(self, x: torch.Tensor, op: str, category: OpCategory,
                    index: int = 0, hook: Optional[str] = None):
        """Quantize a forward input tensor (observer ``{hook}_{index}``,
        hook defaulting to ``{op}_pre_process``) and tap its gradient."""
        cfg = self.qconfig
        if cfg is None:
            return x
        site = f"{hook or op + '_pre_process'}_{index}"
        for spec in (cfg.activation_spec(self.path, op, category, index),
                     cfg.error_spec(self.path, op, category, index)):
            if spec is not None:
                self._site_error(site, spec)
        return x

    def quant_residual(self, a, b, hook: Optional[str] = None):
        """Residual add with both inputs quantized, sum in the model dtype."""
        a = self.quant_input(a, "add", OpCategory.RESIDUAL, 0, hook=hook)
        b = self.quant_input(b, "add", OpCategory.RESIDUAL, 1, hook=hook)
        return a + b

    def quant_mul(self, a, b, hook: Optional[str] = None):
        """Elementwise scaling with quantized inputs, product in the model
        dtype."""
        a = self.quant_input(a, "mul", OpCategory.SCALING, 0, hook=hook)
        b = self.quant_input(b, "mul", OpCategory.SCALING, 1, hook=hook)
        return a * b

    def quant_activation_input(self, x, op: str):
        return self.quant_input(x, op, OpCategory.ACTIVATION, 0)

    def quant_norm_input(self, x, op: str = "layer_norm"):
        return self.quant_input(x, op, OpCategory.LAYERNORM, 0)

    def weight_fake_quant(self, w, op: str = "linear"):
        cfg = self.qconfig
        if cfg is not None:
            spec = cfg.weight_spec(self.path, op)
            if spec is not None:
                self._site_error("weight_fake_quant", spec)
        return w


class QDense(nn.Module, QuantMixin):
    """Bias-free dense layer, y = x @ kernel with kernel (in, out).

    With ``qconfig.storage_fmt`` set and an eligible shape, the kernel is
    not a param at all: the layer holds the packed ``codes``/``scales``/
    ``zero_points`` buffers (quantize/storage.py) and runs the storage GEMM
    (ops/affine_storage.py).  Otherwise ``kernel`` is a float32 param cast
    to the compute dtype; x is cast to it, the product accumulates in f32
    and rounds to the compute dtype.
    """

    def __init__(self, in_features: int, features: int, *,
                 qconfig: Optional[QuantConfig] = None, path: str = "",
                 dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.qconfig, self.path, self.dtype = qconfig, path, dtype
        fmt = qconfig.storage_fmt if qconfig is not None else None
        self.group = qconfig.storage_group if qconfig is not None else 0
        self.storage = fmt is not None and _eligible(
            f"{path}.kernel", (in_features, features), fmt, self.group)
        if self.storage:
            ng = in_features // self.group
            self.register_buffer("codes", torch.zeros(
                (in_features // 8, features), dtype=torch.int32,
                device=device))
            self.register_buffer("scales", torch.ones(
                (ng, features), dtype=torch.float32, device=device))
            self.register_buffer("zero_points", torch.zeros(
                (ng, features), dtype=torch.float32, device=device))
        else:
            self.kernel = nn.Parameter(torch.zeros(
                (in_features, features), dtype=torch.float32, device=device),
                requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.quant_input(x, "linear", OpCategory.GEMM, 0)
        if self.storage:
            lead = x.shape[:-1]
            x2 = x.to(self.dtype).reshape(-1, self.in_features).contiguous()
            y = affine_matmul(x2, self.codes, self.scales, self.zero_points,
                              nbits=4, group_size=self.group)
            return y.to(self.dtype).reshape(*lead, self.features)
        kernel = self.weight_fake_quant(self.kernel.to(self.dtype))
        y = torch.matmul(x.to(self.dtype).to(torch.float32),
                         kernel.to(torch.float32))
        return y.to(self.dtype)


class QRMSNorm(nn.Module, QuantMixin):
    """RMSNorm (LLaMA) with a quantizable input (layernorm category);
    statistics in f32, output in the compute dtype."""

    def __init__(self, dim: int, *, epsilon: float = 1e-6,
                 qconfig: Optional[QuantConfig] = None, path: str = "",
                 dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.epsilon, self.qconfig, self.path, self.dtype = (
            epsilon, qconfig, path, dtype)
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.quant_norm_input(x, "rms_norm")
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.epsilon)
        return (y * self.scale).to(self.dtype)


class Embed(nn.Module):
    """Token embedding: a float32 ``embedding`` param read in the compute
    dtype."""

    def __init__(self, vocab: int, dim: int, *, dtype=torch.bfloat16,
                 device="cpu"):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(
            (vocab, dim), dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids].to(self.dtype)
