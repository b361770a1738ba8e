"""Quantizer dispatch by dtype string, and the bf16-keyed lookup tables.

``quantize_fn(dtype)`` returns a :class:`QuantFn`: a callable that carries
its parsed format (:class:`RoundFormat`).  On a CPU tensor it runs the plain
PyTorch rounding of this package; on a CUDA tensor it launches the
elementwise rounding kernel (``ops/quantize_elemwise.py``) for every format:
posit, fp8, fpN, int, the NormalFloat codebooks and the native bf16 / f16
casts (the ``float32`` cast is the identity on bf16 and f32 tensors, so it
returns its input).  The kernels that round inside themselves (flash
attention's probabilities and output, the fused quantize-matmul) read the
same format from the callable.

The 2**16-entry tables (:func:`get_quantization_map`) are the executable
specification: the reference quantizes through them (reference:
numerics/lut.py, fake_quantize.py:31-95), and the tests hold the direct
quantizers to them over every bf16 pattern.
"""

import re
from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Callable, Optional, Tuple, Union

import torch

from .bitutils import f32_bits, lshr
from .fp8 import (fp_max_norm, parse_fp_dtype, quantize_elemwise,
                  quantize_to_fp8_e4m3, quantize_to_fp8_e5m2)
from .integer import quantize_to_int
from .normal_float import nf_codebook, quantize_to_nf
from .posit import quantize_to_posit_fast

__all__ = ["RoundFormat", "QuantFn", "bf16_universe", "get_quantization_map",
           "apply_lut", "lut_indices", "quantize_fn", "quantize_fn_positive",
           "quantize_fn_unit", "dequantize_nf"]


@dataclass(frozen=True)
class RoundFormat:
    """A rounding as the CUDA kernels take it (``QtFormat`` in
    ``csrc/qt_round.cuh``).

    kind: ``posit`` (a=nbits, b=es), ``fp8`` (the E4M3/E5M2 bit form:
    b=mbits, max_norm, min_norm), ``fp`` (the generic fpN_eXmY form: a=ebits,
    b=mbits, max_norm, unsigned), ``int`` (a=nbits, unsigned), ``nf`` (a=k,
    b=int_bits or 0, ``codebook`` the 2**k entries in float32; the kernels
    search them rounded to the input's dtype, as the plain search does) or
    ``cast`` (a native float: a=ebits, b=mbits of bfloat16, float16 or
    float32)."""

    kind: str
    a: int = 0
    b: int = 0
    max_norm: float = 0.0
    min_norm: float = 0.0
    unsigned: bool = False
    codebook: Tuple[float, ...] = ()

    @property
    def identity(self) -> bool:
        """A cast to float32: no change to a bf16 or f32 value."""
        return self.kind == "cast" and self.b == 23


class QuantFn:
    """A direct elementwise quantizer: ``plain`` on CPU tensors, the
    rounding kernel on CUDA tensors, an error on any other device."""

    def __init__(self, dtype: Optional[str], plain: Callable,
                 fmt: Optional[RoundFormat]):
        self.dtype, self.plain, self.fmt = dtype, plain, fmt

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return x
        if x.device.type == "cpu":
            return self.plain(x)
        if x.device.type == "cuda":
            if self.fmt.identity and x.dtype in _KERNEL_DTYPES:
                return x
            from ..ops.quantize_elemwise import quantize_elemwise as launch
            # the kernel walks a flat array: a strided view (an einsum's
            # permuted product, a sliced token) is copied first
            return launch(x.contiguous(), self.fmt)
        raise ValueError(f"quantize_fn({self.dtype!r}): no rounding kernel "
                         f"for a tensor on {x.device}")

    def __repr__(self) -> str:
        return f"QuantFn({self.dtype!r}, {self.fmt})"


def bf16_universe() -> torch.Tensor:
    """All 2**16 bf16 bit patterns, in bit order (the LUT key space)."""
    return torch.arange(2 ** 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)


_NATIVE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                  "bfloat16": torch.bfloat16}
# (ebits, mbits) of each native dtype, the ``cast`` format's a and b
_NATIVE_BITS = {"float32": (8, 23), "float16": (5, 10), "bfloat16": (8, 7)}
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _fp_plain(x, ebits, mbits, max_norm, unsigned):
    if unsigned:
        x = x.abs()
    return quantize_elemwise(x, mbits + 2, ebits, max_norm, round_mode="even",
                             saturate_normals=True)


@lru_cache(maxsize=None)
def quantize_fn(dtype: Optional[str]) -> QuantFn:
    """Direct elementwise quantizer for a dtype string: ``int<N>``,
    ``uint<N>``, ``e4m3``/``e5m2`` (optionally ``fp8.``-prefixed),
    ``fp<N>_e<X>m<Y>``, ``posit<N>_<E>``, ``nf<K>``/``nf<K>_<B>`` (through
    the codebook) and the native float dtypes."""
    if dtype is None:
        return QuantFn(None, lambda x: x, None)

    if dtype in _NATIVE_DTYPES:
        target = _NATIVE_DTYPES[dtype]
        return QuantFn(dtype, lambda x: x.to(target).to(x.dtype),
                       RoundFormat("cast", *_NATIVE_BITS[dtype]))

    if (m := re.fullmatch(r"(u?)int(\d+)", dtype, re.IGNORECASE)):
        nbits, signed = int(m.group(2)), not m.group(1)
        return QuantFn(dtype, partial(quantize_to_int, nbits=nbits,
                                      signed=signed),
                       RoundFormat("int", nbits, unsigned=not signed))

    if (m := re.fullmatch(r"(?:fp8\.)?(e4m3|e5m2)", dtype, re.IGNORECASE)):
        e4m3 = m.group(1).lower() == "e4m3"
        fmt = (RoundFormat("fp8", 0, 3, 448.0, 2.0 ** -6) if e4m3
               else RoundFormat("fp8", 0, 2, 57344.0, 2.0 ** -14))
        return QuantFn(dtype, quantize_to_fp8_e4m3 if e4m3
                       else quantize_to_fp8_e5m2, fmt)

    if re.fullmatch(r"fp(\d+)_e(\d+)m(\d+)", dtype):
        nbits, ebits, mbits = parse_fp_dtype(dtype)
        max_norm = fp_max_norm(dtype)
        unsigned = nbits == ebits + mbits
        return QuantFn(dtype, partial(_fp_plain, ebits=ebits, mbits=mbits,
                                      max_norm=max_norm, unsigned=unsigned),
                       RoundFormat("fp", ebits, mbits, max_norm,
                                   unsigned=unsigned))

    if (m := re.fullmatch(r"posit(\d+)_(\d+)", dtype)):
        nbits, es = int(m.group(1)), int(m.group(2))
        return QuantFn(dtype, partial(quantize_to_posit_fast, nbits=nbits,
                                      es=es), RoundFormat("posit", nbits, es))

    if (m := re.fullmatch(r"nf(\d+)(?:_(\d+))?", dtype)):
        k = int(m.group(1))
        int_bits = int(m.group(2)) if m.group(2) else None

        def _nf(x, k=k, int_bits=int_bits):
            indices, values = quantize_to_nf(x, k, int_bits=int_bits)
            return values[indices.long()]

        codebook = nf_codebook(k, int_bits=int_bits).tolist()
        return QuantFn(dtype, _nf, RoundFormat("nf", k, int_bits or 0,
                                               codebook=tuple(codebook)))

    raise ValueError(f"Unsupported dtype: {dtype}")


def quantize_fn_positive(dtype: Optional[str]) -> QuantFn:
    """:func:`quantize_fn` for known non-negative finite inputs.  The
    reference's leaner positive forms are bit-identical to the general
    rounding there, so this is the general quantizer."""
    return quantize_fn(dtype)


def quantize_fn_unit(dtype: Optional[str]) -> QuantFn:
    """:func:`quantize_fn` for inputs in [0, 1] (softmax probabilities); the
    general quantizer, as :func:`quantize_fn_positive`."""
    return quantize_fn(dtype)


@lru_cache(maxsize=None)
def _cached_map(dtype: Optional[str]):
    values = bf16_universe()
    if dtype is None:
        return values
    if dtype in _NATIVE_DTYPES:
        return values.to(_NATIVE_DTYPES[dtype]).to(torch.bfloat16)
    if (m := re.fullmatch(r"nf(\d+)(?:_(\d+))?", dtype)):
        int_bits = int(m.group(2)) if m.group(2) else None
        return quantize_to_nf(values, int(m.group(1)), int_bits=int_bits)
    return quantize_fn(dtype)(values)


def get_quantization_map(
    dtype: Optional[str],
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The 2**16-entry bf16-keyed table of ``dtype`` (NF formats return
    ``(indices, codebook)``)."""
    return _cached_map(dtype)


def lut_indices(x: torch.Tensor) -> torch.Tensor:
    """bf16-bit LUT key of each element; wider floats take their top 16
    bits with the discarded bits ORed into the key's LSB (round to odd), so
    the round-to-even table composes into a correct rounding."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    raw = f32_bits(x)
    sticky = ((raw & 0xFFFF) != 0).to(torch.int32)
    return (lshr(raw, 16) & 0xFFFF) | sticky


def apply_lut(x: torch.Tensor, qmap: torch.Tensor) -> torch.Tensor:
    """Gather-based quantization through a bf16-keyed table."""
    return qmap[lut_indices(x).long()].to(x.dtype)


def dequantize_nf(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """NF codebook indices back to values."""
    return codebook[indices.long()]
