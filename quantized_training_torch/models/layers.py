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
from ..ops.int8_matmul import w8a8_matmul
from ..ops.mx_storage import mx_matmul
from ..ops.posit_storage import posit_matmul
from ..qspec import QScheme, QuantizationSpec
from ..numerics import quantize_fn
from ..quantize.config import OpCategory, QuantConfig
from ..quantize.fake_quant import fake_quantize, straight_through
from ..quantize.gptq import hessian_from_inputs
from ..quantize.storage import _eligible, storage_shapes
from ..utils import resolve_device

__all__ = ["FakeQuant", "QuantMixin", "QDense", "QLoRADense", "QLayerNorm",
           "QRMSNorm", "NoNorm", "QSoftmax", "Embed", "bwd_quantize"]


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
        # the rounding kernel takes contiguous tensors; autograd may hand
        # over a strided view
        gq, _ = fake_quantize(g.contiguous(),
                              ctx.spec.replace(amax_history_len=1), None,
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


def _param(shape, device, fill=0.0):
    """A float32 parameter (frozen until a train step makes it trainable)."""
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32,
                                   device=device), requires_grad=False)


def _dense_product(x, kernel, dtype):
    """x @ kernel in the compute dtype, summed in f32 (the reference's
    ``jnp.dot(..., preferred_element_type=f32)``): on CUDA the bf16
    operands go to ``torch.matmul``, on the CPU they are widened to f32."""
    if x.device.type == "cpu":
        y = torch.matmul(x.to(dtype).to(torch.float32),
                         kernel.to(torch.float32))
    else:
        if x.device.type == "cuda":
            _require_f32_reduction()
        y = torch.matmul(x.to(dtype), kernel)
    return y.to(dtype)


def _lora_delta(a, b, alpha: float, rank: int):
    """(alpha / rank) * (a @ b) in the compute dtype of ``a`` and ``b``:
    the product summed in f32 and rounded, then scaled by the bf16-rounded
    factor, as the reference's bf16 arrays compute it."""
    prod = _dense_product(a, b, a.dtype)
    return torch.tensor(alpha / rank, dtype=a.dtype, device=a.device) * prod


class QDense(nn.Module, QuantMixin):
    """Dense layer, y = x @ kernel (+ bias) with kernel (in, out).

    With ``qconfig.storage_fmt`` set and an eligible shape, the kernel is
    not a param at all: the layer holds the packed ``codes`` (and
    ``scales``/``zero_points``) buffers of its format (quantize/storage.py)
    and runs that format's storage GEMM (ops/posit_storage.py,
    ops/mx_storage.py, ops/affine_storage.py, ops/int8_matmul.py).
    Otherwise ``kernel`` is a float32 param, cast
    to the compute dtype and fake-quantized at the weight site; the product
    accumulates in f32 and rounds to the compute dtype (on CUDA the bf16
    operands go to ``torch.matmul``; on the CPU the operands are widened to
    f32).  cuBLAS keeps the whole sum in f32 only while
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    is off (PyTorch turns it on by default), so a CUDA forward raises
    unless the caller has turned it off.

    When the config's LoRA targets match ``path`` (reference:
    modules/qat/lora.py:34-55), the layer also holds ``lora_a`` (in, r) and
    ``lora_b`` (r, out); each is fake-quantized at the weight spec, and the
    kernel becomes ``kernel + (alpha / r) * lora_a @ lora_b`` before its
    own weight site.  ``use_bias`` adds a float32 ``bias``, quantized with
    a derived scale where the config has a bias spec
    (:meth:`_maybe_quant_bias`).

    ``forward(x, skip_input_quant=True)`` means the caller already applied
    this layer's forward input rounding (a shared q/k/v site, or the flash
    kernel's output epilogue): the value is already rounded, but the
    layer's backward error tap still attaches.

    GPTQ calibration (quantize/gptq.py:collect_hessians): while
    ``hessians`` is a dict, the dense path adds ``X^T X`` in f32 of its
    matmul operand (after the input rounding) under the layer's ``path``.
    """

    def __init__(self, in_features: int, features: int, *,
                 use_bias: bool = True,
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
        self.storage_fmt = fmt if self.storage else None
        self.lora = (not self.storage and qconfig is not None
                     and qconfig.lora_matches(path))
        if self.storage:
            for name, (shape, dt) in storage_shapes(
                    fmt, in_features, features, self.group).items():
                self.register_buffer(name, torch.zeros(
                    shape, dtype=dt, device=device))
        else:
            self.kernel = _param((in_features, features), device)
        if self.lora:
            self.lora_a = _param((in_features, qconfig.lora_rank), device)
            self.lora_b = _param((qconfig.lora_rank, features), device)
        self.bias = _param((features,), device) if use_bias else None
        self.hessians = None

    def _input_site(self, x, skip_input_quant: bool):
        if not skip_input_quant:
            return self.quant_input(x, "linear", OpCategory.GEMM, 0)
        cfg = self.qconfig
        if cfg is not None:
            err = cfg.error_spec(self.path, "linear", OpCategory.GEMM, 0)
            if err is not None:
                x = bwd_quantize(x, err)
        return x

    def _storage_matmul(self, x2: torch.Tensor) -> torch.Tensor:
        """x2 @ dequant(packed codes) through the format's storage GEMM."""
        fmt = self.storage_fmt
        if fmt == "posit8":
            return posit_matmul(x2, self.codes)
        if fmt == "mx8":
            return mx_matmul(x2, self.codes, self.scales,
                             block_size=self.group)
        if fmt == "w8a8":
            # dynamic per-token activation quantization is inside the op
            return w8a8_matmul(x2, self.codes, self.scales)
        # w2x4 holds w2 values in the w4 word layout (zp shifted at pack
        # time), so it runs the nbits=4 GEMM unchanged
        return affine_matmul(x2, self.codes, self.scales, self.zero_points,
                             nbits=2 if fmt == "w2a16" else 4,
                             group_size=self.group)

    def _site_scale(self, site: str, spec):
        """The delayed scale of this layer's ``site`` observer, or None."""
        if spec is None or spec.qscheme != QScheme.PER_TENSOR_SYMMETRIC:
            return None
        sites = self._modules.get("quant_sites")
        fq = sites[site] if sites is not None and site in sites else None
        return None if fq is None or fq.state is None else fq.state.scale

    def _maybe_quant_bias(self, bias: torch.Tensor) -> torch.Tensor:
        """Derived-scale bias quantization, scale = act_scale *
        weight_scale (reference DerivedQuantizationSpec,
        quantize_pt2e.py:145-152), where the config has a bias spec and
        both the input and the weight observers of this layer are
        per-tensor delayed scaling; the scales are those observers' states
        after this call's observation."""
        cfg = self.qconfig
        if cfg is None:
            return bias
        bspec = cfg.bias_spec(self.path)
        if bspec is None:
            return bias
        s_a = self._site_scale("linear_pre_process_0", cfg.activation_spec(
            self.path, "linear", OpCategory.GEMM, 0))
        s_w = self._site_scale("weight_fake_quant", cfg.weight_spec(self.path))
        if s_a is None or s_w is None:
            return bias
        scale = (s_a * s_w).to(bias.dtype)
        qfn = quantize_fn(bspec.dtype)
        return straight_through(lambda b: qfn(b / scale) * scale)(bias)

    def forward(self, x: torch.Tensor,
                skip_input_quant: bool = False) -> torch.Tensor:
        if self.storage:
            x = self._input_site(x, skip_input_quant)
            lead = x.shape[:-1]
            x2 = x.to(self.dtype).reshape(-1, self.in_features).contiguous()
            y = self._storage_matmul(x2)
            y = y.to(self.dtype).reshape(*lead, self.features)
        else:
            kernel = self.kernel.to(self.dtype)
            x = self._input_site(x, skip_input_quant)
            if self.hessians is not None:
                h = hessian_from_inputs(x)
                prev = self.hessians.get(self.path)
                self.hessians[self.path] = h if prev is None else prev + h
            if self.lora:
                cfg = self.qconfig
                a, b = self.lora_a.to(self.dtype), self.lora_b.to(self.dtype)
                wspec = cfg.weight_spec(self.path)
                if wspec is not None:
                    a = self._fake_quant("lora_a_fake_quant", wspec)(a)
                    b = self._fake_quant("lora_b_fake_quant", wspec)(b)
                kernel = kernel + _lora_delta(a, b, cfg.lora_alpha,
                                              cfg.lora_rank)
            kernel = self.weight_fake_quant(kernel)
            y = _dense_product(x, kernel, self.dtype)
        if self.bias is not None:
            y = y + self._maybe_quant_bias(self.bias).to(self.dtype)
        return y


class QLoRADense(nn.Module, QuantMixin):
    """LoRA-adapted dense layer with the reference's QAT semantics
    (modules/qat/lora.py:34-55): ``lora_a`` and ``lora_b`` each
    fake-quantized with the weight spec, then the merged weight
    ``kernel + (alpha / r) * lora_a @ lora_b`` fake-quantized again before
    the product; the input is quantized at the linear GEMM site."""

    def __init__(self, in_features: int, features: int, *,
                 lora_rank: int = 8, lora_alpha: float = 16.0,
                 use_bias: bool = True,
                 qconfig: Optional[QuantConfig] = None, path: str = "",
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        self.qconfig, self.path, self.dtype = qconfig, path, dtype
        self.kernel = _param((in_features, features), device)
        self.lora_a = _param((in_features, lora_rank), device)
        self.lora_b = _param((lora_rank, features), device)
        self.bias = _param((features,), device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel.to(self.dtype)
        a, b = self.lora_a.to(self.dtype), self.lora_b.to(self.dtype)
        cfg = self.qconfig
        wspec = cfg.weight_spec(self.path) if cfg is not None else None
        if wspec is not None:
            a = self._fake_quant("lora_a_fake_quant", wspec)(a)
            b = self._fake_quant("lora_b_fake_quant", wspec)(b)
        merged = kernel + _lora_delta(a, b, self.lora_alpha, self.lora_rank)
        if wspec is not None:
            merged = self._fake_quant("weight_fake_quant", wspec)(merged)
        x = self.quant_input(x, "linear", OpCategory.GEMM, 0)
        y = _dense_product(x, merged, self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


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
