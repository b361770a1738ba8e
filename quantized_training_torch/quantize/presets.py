"""Named mixed-precision presets — the reference's LLM PTQ configurations
(reference: quantize/presets.py, examples/language_modeling/prepare_model.py:9-106).

Each preset maps op-type / (module-name, op, index) scopes to
(activation_spec, weight_spec) string pairs; ``build_preset`` compiles one
into a :class:`QuantConfig`.  Names match the paper's sweep: e.g.
``linear4_matmul6_fp8_mixhead`` = NF4 microscaled linears + MXINT6 matmuls
with FP8-coded scales and a mixed-precision lm_head, optionally with
outlier splitting.
"""

from typing import Dict, Optional, Tuple, Union

from ..qspec import QuantizationSpec
from .config import QConfig, QuantConfig

__all__ = ["QUANTIZATION_CONFIGS", "build_preset"]

# Scope key forms: "op:<name>" (op-type rule), ("<name-regex>", "<op>", idx)
# (module_name_op_index rule).  Values: (activation, weight) spec strings.
QUANTIZATION_CONFIGS: Dict[str, Dict] = {
    "linear4": {
        "op:linear": ("nf4,qs=microscaling,bs=64,ax=-1",
                      "nf4,qs=microscaling,bs=64,ax=-1"),
    },
    "matmul4": {
        "op:matmul": ("nf4,qs=microscaling,bs=64,ax=-1",
                      "nf4,qs=microscaling,bs=64,ax=-2"),
    },
    "linear4_matmul6": {
        "op:linear": ("nf4,qs=microscaling,bs=64,ax=-1",
                      "nf4,qs=microscaling,bs=64,ax=-1"),
        "op:matmul": ("int6,qs=microscaling,bs=64,ax=-1",
                      "int6,qs=microscaling,bs=64,ax=-2"),
    },
    "linear4_matmul6_fp8": {
        "op:linear": ("nf4_6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3",
                      "nf4_6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3"),
        "op:matmul": ("int6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3",
                      "int6,qs=microscaling,bs=64,ax=-2,scale=fp8_e5m3"),
    },
    "linear4_matmul6_fp8_mixhead": {
        "op:linear": ("nf4_6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3",
                      "nf4_6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3"),
        "op:matmul": ("int6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3",
                      "int6,qs=microscaling,bs=64,ax=-2,scale=fp8_e5m3"),
        ("lm_head", "linear", 0): (
            "int6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3",
            "nf4_6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3"),
    },
    "linear4_matmul6_fp8_outlier": {
        "op:linear": (
            "nf4_6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3,outlier=4.0",
            "nf4_6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3"),
        "op:matmul": ("int6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3",
                      "int6,qs=microscaling,bs=64,ax=-2,scale=fp8_e5m3"),
        ("lm_head", "linear", 0): (
            "int6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3",
            "nf4_6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3"),
    },
}


def _to_qconfig(value) -> Optional[QConfig]:
    if value is None:
        return None
    if isinstance(value, str):
        spec = QuantizationSpec.from_str(value)
        return QConfig(activation=spec, weight=spec)
    act, weight = value[0], value[1]
    return QConfig(
        activation=QuantizationSpec.from_str(act) if act else None,
        weight=QuantizationSpec.from_str(weight) if weight else None,
    )


def build_preset(
    name_or_dict: Union[str, Dict], base: Optional[QuantConfig] = None
) -> QuantConfig:
    """Compile a named preset (or a raw scope dict) into a QuantConfig."""
    scopes = (QUANTIZATION_CONFIGS[name_or_dict]
              if isinstance(name_or_dict, str) else name_or_dict)
    cfg = base or QuantConfig()
    for key, value in scopes.items():
        qc = _to_qconfig(value)
        if isinstance(key, tuple):
            pattern, op, index = key
            cfg = cfg.set_module_name_op_index(pattern, op, index, qc)
        elif isinstance(key, str) and key.startswith("op:"):
            cfg = cfg.set_object_type(key[3:], qc)
        elif isinstance(key, str):
            cfg = cfg.set_module_name(key, qc)
        else:
            raise ValueError(f"Invalid scope key: {key!r}")
    return cfg
