"""Offline weight folding: apply the weight fake-quant once, serve with an
activation-only config (reference: quantize/fold.py).

``fold_quantized_weights`` rounds every ``kernel`` (and ``lora_a`` /
``lora_b``) of a state dict at its site's weight spec; ``strip_weight_specs``
drops weight quantization from the config, so the runtime path quantizes
activations only, with outputs bit-identical to the unfolded model.
"""

import re
from dataclasses import replace
from typing import Dict, Mapping

import torch

from ..qspec import QScheme
from .config import QuantConfig
from .fake_quant import fake_quantize

__all__ = ["fold_quantized_weights", "strip_weight_specs"]

_FOLDED = ("kernel", "lora_a", "lora_b")


def _site(name: str) -> str:
    """State-dict name -> the module path the config resolves
    (``model.layers.3.mlp.up_proj.kernel`` -> ``model.layers_3.mlp.up_proj``)."""
    return re.sub(r"(^|\.)layers\.(\d+)", r"\1layers_\2",
                  name.rsplit(".", 1)[0])


@torch.no_grad()
def fold_quantized_weights(params: Mapping[str, torch.Tensor],
                           qconfig: QuantConfig,
                           compute_dtype=torch.bfloat16
                           ) -> Dict[str, torch.Tensor]:
    """Round every kernel per its site's weight spec (in ``compute_dtype``,
    stored back in the kernel's dtype).  Only direct-rounding and stateless
    (MX / group-affine) weight schemes fold; delayed-scaling weights keep
    their runtime observers and are left as they are."""
    out = {}
    for name, leaf in params.items():
        if name.rsplit(".", 1)[-1] in _FOLDED:
            spec = qconfig.weight_spec(_site(name))
            if spec is not None and spec.qscheme in (
                    None, QScheme.MICROSCALING, QScheme.GROUP_WISE_AFFINE):
                q, _ = fake_quantize(leaf.to(compute_dtype), spec, None,
                                     observe=False, quantize=True)
                leaf = q.to(leaf.dtype)
        out[name] = leaf
    return out


def strip_weight_specs(qconfig: QuantConfig) -> QuantConfig:
    """The config with every weight spec removed (use after folding)."""

    def strip(qc):
        return replace(qc, weight=None) if qc is not None else None

    return replace(
        qconfig,
        global_qconfig=strip(qconfig.global_qconfig),
        module_name_rules=tuple(
            (p, strip(qc)) for p, qc in qconfig.module_name_rules),
        op_type_rules=tuple(
            (p, strip(qc)) for p, qc in qconfig.op_type_rules),
        module_name_op_index_rules=tuple(
            (p, o, i, strip(qc))
            for p, o, i, qc in qconfig.module_name_op_index_rules),
    )
