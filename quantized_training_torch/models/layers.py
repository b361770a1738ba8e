"""Quantization-aware building blocks.

Quantization is built into the modules, driven by a static
:class:`QuantConfig` that is consulted with (module path, op, category,
index) at every site (reference: models/layers.py, quantize.py:52-193,
modules/qat/linear.py:40-41).  Each module is constructed with its dotted
``path``, the path the reference annotator matches against.

  * :class:`FakeQuant` fake-quantizes one site and keeps its observer state
    (delayed scaling); it observes while ``observe`` is True.
  * :class:`QuantMixin` gives a module its sites: ``quant_input`` (the
    activation spec, then ``bwd_quantize`` for an error spec), residual
    adds, scaling muls, activation and norm inputs, the shared input of
    sibling projections, and the weight fake-quant.  A site's FakeQuant is
    created at its first call, under ``quant_sites.{hook}_{index}``.
  * :func:`bwd_quantize` is the identity forward whose backward
    fake-quantizes the gradient.
"""

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.affine_storage import affine_matmul
from ..qspec import QScheme, QuantizationSpec
from ..quantize.config import OpCategory, QuantConfig
from ..quantize.fake_quant import fake_quantize
from ..quantize.storage import _eligible
from ..utils import resolve_device

__all__ = ["FakeQuant", "QuantMixin", "QDense", "QLayerNorm", "QRMSNorm",
           "NoNorm", "QSoftmax", "Embed", "bwd_quantize"]


class FakeQuant(nn.Module):
    """Fake-quantize a tensor per ``spec``, carrying observer state.

    Stateless schemes (direct rounding, microscaling, group affine) just
    round.  Delayed-scaling schemes start their state from the first input
    they see and update it on each call while ``observe`` is True (the
    reference's observer_enabled switch)."""

    def __init__(self, spec: Optional[QuantizationSpec],
                 quantize: bool = True):
        super().__init__()
        self.spec, self.quantize, self.observe = spec, quantize, True
        self.state = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        if spec is None:
            return x
        if spec.qscheme in (None, QScheme.MICROSCALING,
                            QScheme.GROUP_WISE_AFFINE):
            y, _ = fake_quantize(x, spec, None, observe=False,
                                 quantize=self.quantize)
            return y
        y, new_state = fake_quantize(x, spec, self.state,
                                     observe=self.observe,
                                     quantize=self.quantize)
        if self.observe or self.state is None:
            self.state = new_state
        return y


class _BwdQuantize(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        gq, _ = fake_quantize(g, ctx.spec.replace(amax_history_len=1), None,
                              observe=True, quantize=True)
        return gq, None


def bwd_quantize(x: torch.Tensor, spec: QuantizationSpec) -> torch.Tensor:
    """Identity forward; fake-quantizes the gradient in backward (the
    reference's error_pre_process hook, quantize.py:142-150), with the
    scale of a delayed-scaling spec taken from the gradient itself
    (amax history of length 1)."""
    return _BwdQuantize.apply(x, spec)


class QuantMixin:
    """Config-driven quantization points for a module with ``qconfig`` and
    ``path`` attributes.  Every helper is a no-op when the config resolves
    no spec, so the same module serves float and quantized execution."""

    qconfig: Optional[QuantConfig]
    path: str

    def _fake_quant(self, name: str, spec) -> FakeQuant:
        sites = self._modules.get("quant_sites")
        if sites is None:
            sites = nn.ModuleDict()
            self.add_module("quant_sites", sites)
        if name not in sites:
            if self.qconfig.record_histogram:
                raise NotImplementedError(
                    "exponent histograms are not ported yet")
            sites[name] = FakeQuant(spec)
        return sites[name]

    def quant_input(self, x: torch.Tensor, op: str, category: OpCategory,
                    index: int = 0, hook: Optional[str] = None):
        """Quantize a forward input tensor (observer ``{hook}_{index}``,
        hook defaulting to ``{op}_pre_process``), then tap its gradient."""
        cfg = self.qconfig
        if cfg is None:
            return x
        hook = hook or f"{op}_pre_process"
        spec = cfg.activation_spec(self.path, op, category, index)
        if spec is not None:
            x = self._fake_quant(f"{hook}_{index}", spec)(x)
        err = cfg.error_spec(self.path, op, category, index)
        if err is not None:
            x = bwd_quantize(x, err)
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

    def _shared_input_quant(self, x: torch.Tensor, children: Tuple[str, ...],
                            hook: str):
        """Round an input shared by several child dense layers once.

        Returns the rounded tensor when every child resolves the same
        direct-rounding spec and none has an error spec (the rounded tensor
        is the same at each site); None otherwise: stateful schemes keep
        per-site observers, and per-branch gradient taps stay at each site
        because branch cotangents are quantized before they sum."""
        cfg = self.qconfig
        if cfg is None:
            return None
        specs, errs = [], []
        for child in children:
            path = f"{self.path}.{child}" if self.path else child
            specs.append(cfg.activation_spec(path, "linear", OpCategory.GEMM,
                                             0))
            errs.append(cfg.error_spec(path, "linear", OpCategory.GEMM, 0))
        spec = specs[0]
        if (spec is None or any(s != spec for s in specs)
                or any(e is not None for e in errs)
                or spec.qscheme is not None
                or spec.outlier_threshold is not None):
            return None
        return self._fake_quant(f"{hook}_0", spec)(x)

    def weight_fake_quant(self, w, op: str = "linear"):
        cfg = self.qconfig
        if cfg is None:
            return w
        spec = cfg.weight_spec(self.path, op)
        if spec is None:
            return w
        return self._fake_quant("weight_fake_quant", spec)(w)


def _require_f32_reduction():
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise RuntimeError(
            "QDense on CUDA accumulates in f32, as the reference's "
            "jnp.dot(..., preferred_element_type=f32): set "
            "torch.backends.cuda.matmul."
            "allow_bf16_reduced_precision_reduction = False first")


class QDense(nn.Module, QuantMixin):
    """Bias-free dense layer, y = x @ kernel with kernel (in, out).

    With ``qconfig.storage_fmt`` set and an eligible shape, the kernel is
    not a param at all: the layer holds the packed ``codes``/``scales``/
    ``zero_points`` buffers (quantize/storage.py) and runs the storage GEMM
    (ops/affine_storage.py).  Otherwise ``kernel`` is a float32 param, cast
    to the compute dtype and fake-quantized at the weight site; the product
    accumulates in f32 and rounds to the compute dtype (on CUDA the bf16
    operands go to ``torch.matmul``; on the CPU the operands are widened to
    f32).  cuBLAS keeps the whole sum in f32 only while
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    is off (PyTorch turns it on by default), so a CUDA forward raises
    unless the caller has turned it off.

    ``forward(x, skip_input_quant=True)`` means the caller already applied
    this layer's forward input rounding (a shared q/k/v site, or the flash
    kernel's output epilogue): the value is already rounded, but the
    layer's backward error tap still attaches.
    """

    def __init__(self, in_features: int, features: int, *,
                 qconfig: Optional[QuantConfig] = None, path: str = "",
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        device = resolve_device(device)
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

    def _input_site(self, x, skip_input_quant: bool):
        if not skip_input_quant:
            return self.quant_input(x, "linear", OpCategory.GEMM, 0)
        cfg = self.qconfig
        if cfg is not None:
            err = cfg.error_spec(self.path, "linear", OpCategory.GEMM, 0)
            if err is not None:
                x = bwd_quantize(x, err)
        return x

    def forward(self, x: torch.Tensor,
                skip_input_quant: bool = False) -> torch.Tensor:
        if self.storage:
            x = self._input_site(x, skip_input_quant)
            lead = x.shape[:-1]
            x2 = x.to(self.dtype).reshape(-1, self.in_features).contiguous()
            y = affine_matmul(x2, self.codes, self.scales, self.zero_points,
                              nbits=4, group_size=self.group)
            return y.to(self.dtype).reshape(*lead, self.features)
        kernel = self.kernel.to(self.dtype)
        x = self._input_site(x, skip_input_quant)
        kernel = self.weight_fake_quant(kernel)
        if x.device.type == "cpu":
            y = torch.matmul(x.to(self.dtype).to(torch.float32),
                             kernel.to(torch.float32))
        else:
            if x.device.type == "cuda":
                _require_f32_reduction()
            y = torch.matmul(x.to(self.dtype), kernel)
        return y.to(self.dtype)


class QRMSNorm(nn.Module, QuantMixin):
    """RMSNorm (LLaMA) with a quantizable input (layernorm category);
    statistics in f32, output in the compute dtype."""

    def __init__(self, dim: int, *, epsilon: float = 1e-6,
                 qconfig: Optional[QuantConfig] = None, path: str = "",
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        device = resolve_device(device)
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


class QLayerNorm(nn.Module, QuantMixin):
    """LayerNorm with a quantizable input (layernorm category)."""

    def __init__(self, dim: int, *, epsilon: float = 1e-12,
                 use_scale: bool = True, use_bias: bool = True,
                 qconfig: Optional[QuantConfig] = None, path: str = "",
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.epsilon, self.qconfig, self.path, self.dtype = (
            epsilon, qconfig, path, dtype)
        self.scale = nn.Parameter(torch.ones(
            dim, dtype=torch.float32, device=device),
            requires_grad=False) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(
            dim, dtype=torch.float32, device=device),
            requires_grad=False) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.quant_norm_input(x, "layer_norm")
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        if self.scale is not None:
            y = y * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class NoNorm(nn.Module, QuantMixin):
    """MobileBERT's NoNorm: elementwise scale and shift in the input dtype,
    no statistics (layernorm category)."""

    def __init__(self, dim: int, *, qconfig: Optional[QuantConfig] = None,
                 path: str = "", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.qconfig, self.path = qconfig, path
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                             device=device),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.quant_norm_input(x, "layer_norm")
        return x * self.scale.to(x.dtype) + self.bias.to(x.dtype)


class QSoftmax(nn.Module, QuantMixin):
    """Softmax over the last axis with a quantized input (activation
    category); with the config's ``posit_exp`` / ``posit_reciprocal`` the
    posit16-approximated softmax of ops/softmax.py."""

    def __init__(self, *, qconfig: Optional[QuantConfig] = None,
                 path: str = "", dtype=torch.bfloat16):
        super().__init__()
        self.qconfig, self.path, self.dtype = qconfig, path, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.quant_activation_input(x, "softmax")
        cfg = self.qconfig
        use_exp = cfg is not None and (cfg.posit_exp or cfg.posit_exp_shifted)
        use_recip = cfg is not None and cfg.posit_reciprocal
        if use_exp or use_recip:
            from ..ops.softmax import posit_softmax
            return posit_softmax(x, use_exp, use_recip).to(self.dtype)
        xf = x.to(torch.float32)
        e = torch.exp(xf - torch.amax(xf, dim=-1, keepdim=True).detach())
        return (e / torch.sum(e, dim=-1, keepdim=True)).to(self.dtype)


class Embed(nn.Module):
    """Token embedding: a float32 ``embedding`` param read in the compute
    dtype."""

    def __init__(self, vocab: int, dim: int, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(
            (vocab, dim), dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids].to(self.dtype)
