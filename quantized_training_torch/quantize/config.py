"""Quantization configuration: op categories, scopes, and the fusion ladder.

This layer replaces two reference mechanisms with one config object:

  * the eager flow's category lists + QConfig triple (reference:
    quantization_mappings.py:46-72, qconfig.py:14-58, quantize.py:103-110),
    including the --quantize_forward / --quantize_backprop selective
    quantization that implements the paper's fusion ladder;
  * the PT2E annotator's scope system — global / object-type / module-name
    regex / (module-name, op, index) (reference:
    quantizer/xnnpack_quantizer.py:180-223).

Models call ``resolve(path, op, index)`` at each quantization site; because
model code is plain Python, no graph surgery is needed — the resolved
spec decides whether a fake-quant op runs at all (an unquantized site
costs nothing).
"""

import re
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..qspec import QuantizationSpec

__all__ = [
    "OpCategory",
    "QConfig",
    "QuantConfig",
    "FUSION_LADDER",
    "parse_op_categories",
]


class OpCategory(str, Enum):
    """Fusion-ladder op categories (reference: quantization_mappings.py:46-72).

    A category being *quantized* means its inputs go through fake-quant; a
    category being *fused* means it consumes the high-precision accumulator
    of the preceding GEMM directly (the op joins the epilogue of that
    GEMM's kernel).
    """

    GEMM = "gemm"            # dense / conv / batched matmul inputs
    ACTIVATION = "activation"  # relu / gelu / softmax inputs
    LAYERNORM = "layernorm"    # layer_norm / rmsnorm / nonorm inputs
    RESIDUAL = "residual"      # residual-add inputs
    SCALING = "scaling"        # elementwise-mul inputs (attention scaling)


# The paper's fusion ladder, from "No Fusion" (quantize everything) to
# "+ Residual Fusion" (quantize only GEMM inputs)
# (reference: examples/question_answering/run_squad.py:18-26).
FUSION_LADDER: List[Tuple[str, Tuple[OpCategory, ...]]] = [
    ("no_fusion", (OpCategory.GEMM, OpCategory.ACTIVATION, OpCategory.LAYERNORM,
                   OpCategory.RESIDUAL, OpCategory.SCALING)),
    ("gemm_attn_scaling", (OpCategory.GEMM, OpCategory.ACTIVATION,
                           OpCategory.LAYERNORM, OpCategory.RESIDUAL)),
    ("activation_fusion", (OpCategory.GEMM, OpCategory.LAYERNORM,
                           OpCategory.RESIDUAL)),
    ("layernorm_fusion", (OpCategory.GEMM, OpCategory.RESIDUAL)),
    ("residual_fusion", (OpCategory.GEMM,)),
]


def parse_op_categories(
    ops: Union[None, str, Sequence[Union[str, OpCategory]]]
) -> Tuple[OpCategory, ...]:
    """Parse "gemm,residual,..." the way the reference CLI does
    (quantize.py:103-110)."""
    if ops is None:
        return ()
    if isinstance(ops, str):
        ops = [o for o in ops.split(",") if o]
    out = []
    for op in ops:
        if isinstance(op, OpCategory):
            out.append(op)
        else:
            try:
                out.append(OpCategory(op.strip().lower()))
            except ValueError:
                valid = ", ".join(c.value for c in OpCategory)
                raise ValueError(
                    f"Invalid operation(s) {op}. Options are {valid}."
                ) from None
    return tuple(out)


@dataclass(frozen=True)
class QConfig:
    """The (activation, weight, error) spec triple of the eager flow
    (reference: qconfig.py:14).  ``error`` quantizes gradients."""

    activation: Optional[QuantizationSpec] = None
    weight: Optional[QuantizationSpec] = None
    error: Optional[QuantizationSpec] = None
    # Bias spec: quantized with the *derived* scale act_scale * weight_scale
    # (reference: DerivedQuantizationSpec + derive_bias_qparams_fn,
    # quantize_pt2e.py:145-152).
    bias: Optional[QuantizationSpec] = None

    @staticmethod
    def from_strs(activation=None, weight=None, error=None, bias=None,
                  force_scale_power_of_two=False) -> "QConfig":
        def mk(s):
            if s is None:
                return None
            spec = QuantizationSpec.from_str(s)
            if force_scale_power_of_two:
                spec = spec.replace(force_scale_power_of_two=True)
            return spec

        return QConfig(mk(activation), mk(weight), mk(error), mk(bias))


# A scope rule: (pattern, op, index) -> QConfig. Any element may be None
# (wildcard). Pattern is a regex matched against the module path.
_Rule = Tuple[Optional[str], Optional[str], Optional[int], Optional[QConfig]]


@dataclass(frozen=True)
class QuantConfig:
    """Resolves which QConfig applies at a quantization site.

    Precedence (most to least specific, reference xnnpack_quantizer.py:231-276
    annotation order):
      1. (module_name, op, index) rules
      2. module_name regex rules
      3. object-type (op name) rules
      4. the global QConfig
    plus the fusion-ladder filters: ``forward_categories`` /
    ``backward_categories`` select which op categories get activation / error
    quantization, and ``op_fusion`` names module paths excluded entirely
    (reference: quantize.py:156-159 op_fusion skip list).
    """

    global_qconfig: Optional[QConfig] = None
    module_name_rules: Tuple[Tuple[str, QConfig], ...] = ()
    op_type_rules: Tuple[Tuple[str, QConfig], ...] = ()
    module_name_op_index_rules: Tuple[_Rule, ...] = ()
    forward_categories: Tuple[OpCategory, ...] = tuple(OpCategory)
    backward_categories: Tuple[OpCategory, ...] = ()
    op_fusion: Tuple[str, ...] = ()
    # LoRA adaptation (reference: peft wrapping + qat.LoraLinear semantics,
    # modules/qat/lora.py:34-55): dense layers whose path matches a target
    # regex grow lora_a/lora_b params, fake-quantized with the weight spec.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ()
    # Record per-observer exponent histograms (reference --record_histogram).
    record_histogram: bool = False
    # Posit-approximated softmax (reference --posit_exp[_shifted] /
    # --posit_reciprocal, modules/softmax.py): QSoftmax modules read these
    # so the "posit8-approx" paper rungs reach every model's attention.
    posit_exp: bool = False
    posit_exp_shifted: bool = False
    posit_reciprocal: bool = False
    # Deployed weight storage (serving): when set, QDense layers read packed
    # codes from the "storage" collection (built offline by
    # quantize/storage.py) instead of a bf16 kernel param — the weight bytes
    # streamed per step drop by the format's ratio and the in-kernel decode
    # matches the corresponding weight fake-quant exactly.  One of
    # {"posit8", "mx8", "w4a16", "w2a16"}.
    storage_fmt: Optional[str] = None
    storage_group: int = 64

    # ---- builder API (mirrors set_global / set_module_name / ...) ----
    def set_global(self, qconfig: QConfig) -> "QuantConfig":
        return replace(self, global_qconfig=qconfig)

    def set_module_name(self, pattern: str, qconfig: Optional[QConfig]) -> "QuantConfig":
        return replace(
            self, module_name_rules=self.module_name_rules + ((pattern, qconfig),)
        )

    def set_object_type(self, op: str, qconfig: Optional[QConfig]) -> "QuantConfig":
        return replace(
            self, op_type_rules=self.op_type_rules + ((op, qconfig),)
        )

    def set_module_name_op_index(
        self, pattern: str, op: str, index: int, qconfig: Optional[QConfig]
    ) -> "QuantConfig":
        rule = (pattern, op, index, qconfig)
        return replace(
            self,
            module_name_op_index_rules=self.module_name_op_index_rules + (rule,),
        )

    def with_fusion(self, forward=None, backward=None) -> "QuantConfig":
        out = self
        if forward is not None:
            out = replace(out, forward_categories=parse_op_categories(forward))
        if backward is not None:
            out = replace(out, backward_categories=parse_op_categories(backward))
        return out

    def with_op_fusion(self, names: Sequence[str]) -> "QuantConfig":
        return replace(self, op_fusion=tuple(names or ()))

    def with_lora(self, rank: int, alpha: float = 16.0,
                  targets: Sequence[str] = (".*",)) -> "QuantConfig":
        return replace(self, lora_rank=rank, lora_alpha=alpha,
                       lora_targets=tuple(targets))

    def with_histograms(self, on: bool = True) -> "QuantConfig":
        return replace(self, record_histogram=on)

    def with_storage(self, fmt: Optional[str],
                     group: int = 64) -> "QuantConfig":
        """Serve with packed weight storage (see quantize/storage.py)."""
        assert fmt in (None, "posit8", "mx8", "w4a16", "w2a16", "w2x4", "w8a8"), fmt
        return replace(self, storage_fmt=fmt, storage_group=group)

    def with_posit_softmax(self, exp: bool = False, exp_shifted: bool = False,
                           reciprocal: bool = False) -> "QuantConfig":
        return replace(self, posit_exp=exp, posit_exp_shifted=exp_shifted,
                       posit_reciprocal=reciprocal)

    def lora_matches(self, path: str) -> bool:
        return self.lora_rank > 0 and any(
            re.search(t, path) for t in self.lora_targets
        )

    # ---- resolution ----
    def resolve(
        self, path: str, op: str, index: int = 0
    ) -> Optional[QConfig]:
        """QConfig for a site, or None if the site is unquantized."""
        if any(name in path for name in self.op_fusion):
            return None
        for pattern, rop, ridx, qc in self.module_name_op_index_rules:
            if (pattern is None or re.search(pattern, path)) and \
               (rop is None or rop == op) and (ridx is None or ridx == index):
                return qc
        for pattern, qc in self.module_name_rules:
            if re.search(pattern, path):
                return qc
        for rop, qc in self.op_type_rules:
            if rop == op:
                return qc
        return self.global_qconfig

    def activation_spec(
        self, path: str, op: str, category: OpCategory, index: int = 0
    ) -> Optional[QuantizationSpec]:
        """Spec for a forward input tensor, honoring the fusion ladder."""
        if category not in self.forward_categories:
            return None
        qc = self.resolve(path, op, index)
        return qc.activation if qc else None

    def weight_spec(self, path: str, op: str = "linear") -> Optional[QuantizationSpec]:
        qc = self.resolve(path, op)
        return qc.weight if qc else None

    def bias_spec(self, path: str, op: str = "linear") -> Optional[QuantizationSpec]:
        qc = self.resolve(path, op)
        return getattr(qc, "bias", None) if qc else None

    def error_spec(
        self, path: str, op: str, category: OpCategory, index: int = 0
    ) -> Optional[QuantizationSpec]:
        """Spec for a backward (gradient) tensor, honoring the ladder."""
        if category not in self.backward_categories:
            return None
        qc = self.resolve(path, op, index)
        return qc.error if qc else None
