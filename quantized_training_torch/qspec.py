"""QuantizationSpec and its string mini-language.

The spec string grammar is the reference framework's de-facto user-facing
config format and is kept verbatim (reference:
src/quantized_training/quantizer/quantizer.py:24-139):

    "<dtype>[,key=value]*"   e.g. "posit8_1,qs=per_tensor_symmetric,ahl=16"
                                  "int6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3"
                                  "uint2,qs=group_wise_affine,bs=32,ax=-2"

with abbreviations qmin/qmax/qs/ahl/ax/bs/scale/outlier and per-dtype
quant_min/max defaults.  ``QuantizationSpec`` is a frozen, hashable
dataclass.
"""

import re
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Callable, List, Optional, Tuple, Union

__all__ = [
    "QScheme",
    "QuantizationSpec",
    "DerivedQuantizationSpec",
    "get_quant_min_max",
]


class QScheme(str, Enum):
    PER_TENSOR_SYMMETRIC = "per_tensor_symmetric"
    PER_CHANNEL_SYMMETRIC = "per_channel_symmetric"
    MICROSCALING = "microscaling"
    GROUP_WISE_AFFINE = "group_wise_affine"


ABBREV_MAP = {
    "qmin": "quant_min",
    "qmax": "quant_max",
    "qs": "qscheme",
    "ahl": "amax_history_len",
    "ax": "ch_axis",
    "bs": "block_size",
    "scale": "scale_dtype",
    "outlier": "outlier_threshold",
}


def _parse_int_or_tuple(value: str):
    value = value.strip()
    if value.startswith("(") and value.endswith(")"):
        return tuple(int(v.strip()) for v in value[1:-1].split(","))
    return int(value)


PARAMS_TYPE = {
    "quant_min": float,
    "quant_max": float,
    "qscheme": QScheme,
    "amax_history_len": int,
    "ch_axis": _parse_int_or_tuple,
    "block_size": _parse_int_or_tuple,
    "scale_dtype": str,
    "outlier_threshold": float,
}


def get_quant_min_max(dtype: str) -> Tuple[float, float]:
    """Format range (quant_min, quant_max) per the reference's conventions
    (reference: quantizer/quantizer.py:53-94)."""
    if (m := re.fullmatch(r"int(\d+)", dtype, re.IGNORECASE)):
        nbits = int(m.group(1))
        return -(2 ** (nbits - 1)), 2 ** (nbits - 1) - 1

    if (m := re.fullmatch(r"uint(\d+)", dtype, re.IGNORECASE)):
        nbits = int(m.group(1))
        return 0, 2 ** nbits - 1

    if (m := re.fullmatch(r"(?:fp8\.)?(e4m3|e5m2)", dtype, re.IGNORECASE)):
        fmt = m.group(1).lower()
        max_val = 448.0 if fmt == "e4m3" else 57344.0
        return -max_val, max_val

    if (m := re.fullmatch(r"fp(\d+)_e(\d+)m(\d+)", dtype, re.IGNORECASE)):
        ebits = int(m.group(2))
        mbits = int(m.group(3)) + 2
        emax = 2 ** (ebits - 1) - 1 if ebits > 4 else 2 ** (ebits - 1)
        if dtype.lower() == "fp8_e4m3":
            max_val = 2 ** emax * 1.75
        else:
            max_val = 2 ** emax * (2 ** (mbits - 1) - 1) / 2 ** (mbits - 2)
        return -max_val, max_val

    if (m := re.fullmatch(r"posit(\d+)_(\d+)", dtype, re.IGNORECASE)):
        nbits, es = int(m.group(1)), int(m.group(2))
        max_val = (2 ** (2 ** es)) ** (nbits - 2)
        return -max_val, max_val

    if (m := re.fullmatch(r"nf(\d+)(?:_(\d+))?", dtype, re.IGNORECASE)):
        if m.group(2) is not None:
            max_val = 2 ** (int(m.group(2)) - 1) - 1
        else:
            max_val = 1
        return -max_val, max_val

    raise ValueError(f"Unsupported dtype: {dtype}")


@dataclass(frozen=True, eq=True)
class QuantizationSpec:
    """How to quantize one tensor: dtype plus scheme parameters.

    Frozen + hashable so a spec can key caches and compare by value;
    tuple-typed ch_axis/block_size keep it so.
    """

    dtype: str
    quant_min: Optional[float] = None
    quant_max: Optional[float] = None
    qscheme: Optional[QScheme] = None
    amax_history_len: Optional[int] = None
    ch_axis: Optional[Union[int, Tuple[int, ...]]] = None
    block_size: Optional[Union[int, Tuple[int, ...]]] = None
    scale_dtype: Optional[str] = None
    outlier_threshold: Optional[float] = None
    force_scale_power_of_two: bool = False
    is_dynamic: bool = False

    @staticmethod
    def from_str(s: Optional[str]) -> "QuantizationSpec":
        if not s:
            raise ValueError("String quantization_spec is None or empty")

        # Split on commas not inside parentheses (tuple values).
        fields_ = re.split(r",(?![^()]*\))", s)
        params = {"dtype": fields_[0]}

        for item in fields_[1:]:
            if "=" not in item:
                raise ValueError(f"Expected key=value format but got '{item}'")
            key, value = item.split("=")
            key = ABBREV_MAP.get(key, key)
            if key not in PARAMS_TYPE:
                valid = ", ".join(PARAMS_TYPE.keys())
                raise ValueError(
                    f"Unknown argument '{key}'. Valid keys: {valid}"
                )
            params[key] = PARAMS_TYPE[key](value)

        if (qscheme := params.get("qscheme")) is not None:
            qmin, qmax = get_quant_min_max(params["dtype"])
            params.setdefault("quant_min", float(qmin))
            params.setdefault("quant_max", float(qmax))
            if qscheme in (
                QScheme.PER_TENSOR_SYMMETRIC,
                QScheme.PER_CHANNEL_SYMMETRIC,
            ):
                params.setdefault("amax_history_len", 16)

        return QuantizationSpec(**params)

    def __post_init__(self):
        if self.qscheme is not None and self.quant_max is None:
            raise ValueError("quant_max is required for quantization.")
        if (
            self.qscheme in (QScheme.MICROSCALING, QScheme.GROUP_WISE_AFFINE)
            and self.block_size is None
        ):
            raise ValueError("block_size is required for microscaling.")

    def replace(self, **kwargs) -> "QuantizationSpec":
        return replace(self, **kwargs)

    def __str__(self) -> str:
        parts = [self.dtype]
        if self.qscheme is not None:
            parts.append(f"qs={self.qscheme.value}")
        for abbrev, name in (("ahl", "amax_history_len"), ("ax", "ch_axis"),
                             ("bs", "block_size"), ("scale", "scale_dtype"),
                             ("outlier", "outlier_threshold")):
            val = getattr(self, name)
            if val is not None:
                parts.append(f"{abbrev}={val}")
        return ",".join(parts)


@dataclass(frozen=True, eq=True)
class DerivedQuantizationSpec:
    """Spec whose scale derives from other tensors' quantizers — e.g. a bias
    whose scale is input_scale * weight_scale (reference:
    quantizer/quantizer.py:150-159, derive fn at quantize_pt2e.py:145-152)."""

    derived_from: Tuple[str, ...]
    dtype: str
    derive_qparams_fn: Optional[Callable] = field(default=None, compare=False)
    quant_min: Optional[float] = None
    quant_max: Optional[float] = None
    qscheme: Optional[QScheme] = None
