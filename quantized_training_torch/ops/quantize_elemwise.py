"""Elementwise direct rounding (``csrc/quantize_elemwise.cu``).

The wrapper of the rounding kernel that every direct-rounding site reaches
on CUDA through ``numerics.quantize_fn``: any contiguous bf16 or f32 tensor,
the same dtype out, in every format (posit, fp8, fpN, int, the NormalFloat
codebooks, the native bf16 and f16 casts).  Its plain version is the
numerics code itself (``QuantFn.plain``), taken only for CPU tensors.

The kernel has two forms (:func:`elemwise_form`): a bf16 tensor of at
least ``TABLE_MIN_ELEMENTS[kind]`` elements is rounded by lookups in a
2^16-entry table of the format (every bf16 pattern, rounded once on the
card by the arithmetic itself, cached per device and format under
:func:`table_key`); f32 tensors and smaller bf16 ones by the arithmetic.
"""

import ctypes
from collections import Counter
from typing import Dict, Tuple

import torch

from . import _cuda

__all__ = ["TABLE_MIN_ELEMENTS", "quantize_elemwise", "quantize_elemwise_plain",
           "elemwise_form", "table_key", "clear_tables"]

# bf16 tensors of at least this many elements take the table form, by the
# format's kind: below it the table's fill (128 KB into every block's
# shared memory) costs more than the arithmetic saves.  The crossovers,
# timed on an H100 (PERF.md): the codebook search and the generic fpN
# quantizer cost most, posit and fp8 less, int and the casts least.
TABLE_MIN_ELEMENTS = {"nf": 1 << 18, "fp": 1 << 20, "posit": 1 << 21,
                      "fp8": 1 << 21, "int": 1 << 22, "cast": 1 << 22}

_TABLES: Dict[Tuple[int, bytes], torch.Tensor] = {}


def quantize_elemwise_plain(x: torch.Tensor, qfn) -> torch.Tensor:
    """The plain version: the PyTorch rounding of ``qfn`` (a
    ``numerics.QuantFn``) on any device."""
    return qfn.plain(x)


def table_key(fmt) -> bytes:
    """The table cache's key of a ``numerics.RoundFormat``: the bytes of
    its bf16 ``QtFormat`` (kind, parameters and codebook)."""
    return bytes(_cuda.qt_format(fmt, bf16=True))


def elemwise_form(numel: int, dtype: torch.dtype, kind: str) -> str:
    """``"table"`` or ``"arith"``: the kernel's form for a tensor of
    ``numel`` elements of ``dtype`` rounded to a format of ``kind`` (a
    ``RoundFormat.kind``)."""
    if dtype == torch.bfloat16 and numel >= TABLE_MIN_ELEMENTS.get(
            kind, 1 << 22):
        return "table"
    return "arith"


def clear_tables() -> None:
    """Drop every cached table (the next table-form call builds anew)."""
    _TABLES.clear()


def _lib():
    lib = _cuda.load("quantize_elemwise")
    if lib.quantize_elemwise.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quantize_elemwise.argtypes = [vp, vp, cl, ci, _cuda.QtFormat, vp]
        lib.quantize_table_build.argtypes = [vp, _cuda.QtFormat, vp]
        lib.quantize_elemwise_table.argtypes = [vp, vp, cl, vp, vp]
        for fn in (lib.quantize_elemwise, lib.quantize_table_build,
                   lib.quantize_elemwise_table):
            fn.restype = ci
    return lib


def _table(lib, fmt, device: torch.device) -> torch.Tensor:
    """The format's 2^16-entry bf16 table on ``device``, built at first
    use (counted in ``quantize_elemwise.table_builds``)."""
    key = (device.index, table_key(fmt))
    table = _TABLES.get(key)
    if table is None:
        table = torch.empty(1 << 16, dtype=torch.int16, device=device)
        err = lib.quantize_table_build(table.data_ptr(),
                                       _cuda.qt_format(fmt, bf16=True),
                                       _cuda.stream_ptr(device))
        _cuda.check(lib, err, "quantize_table_build")
        _TABLES[key] = table
        quantize_elemwise.table_builds += 1
    return table


def quantize_elemwise(x: torch.Tensor, fmt) -> torch.Tensor:
    """Round every element of the CUDA tensor ``x`` to ``fmt`` (a
    ``numerics.RoundFormat``) with the kernel, in :func:`elemwise_form`'s
    form; anything it does not take raises."""
    return _quantize_elemwise(x, fmt, None)


def _quantize_elemwise(x: torch.Tensor, fmt, form) -> torch.Tensor:
    """:func:`quantize_elemwise` in ``form`` (``"table"``, bf16 only, or
    ``"arith"``), or in :func:`elemwise_form`'s for None: the checks hold
    each form to the plain version through this."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_elemwise kernel: tensor on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantize_elemwise kernel: dtype {x.dtype} (bf16 "
                         "or f32)")
    if not x.is_contiguous():
        raise ValueError("quantize_elemwise kernel: x must be contiguous")
    form = form or elemwise_form(x.numel(), x.dtype, fmt.kind)
    if form not in ("table", "arith") or (form == "table"
                                          and x.dtype != torch.bfloat16):
        raise ValueError(f"quantize_elemwise kernel: no {form} form for "
                         f"{x.dtype}")
    out = torch.empty_like(x)
    lib = _lib()
    stream = _cuda.stream_ptr(x.device)
    if form == "table":
        err = lib.quantize_elemwise_table(
            x.data_ptr(), out.data_ptr(), x.numel(),
            _table(lib, fmt, x.device).data_ptr(), stream)
        quantize_elemwise.table_launches += 1
    else:
        err = lib.quantize_elemwise(
            x.data_ptr(), out.data_ptr(), x.numel(),
            int(x.dtype == torch.bfloat16),
            _cuda.qt_format(fmt, bf16=x.dtype == torch.bfloat16), stream)
    _cuda.check(lib, err, "quantize_elemwise")
    quantize_elemwise.launches += 1
    quantize_elemwise.shape_launches[(x.numel(), x.element_size())] += 1
    if fmt.kind == "nf":
        quantize_elemwise.nf_launches += 1
    elif fmt.kind == "cast":
        quantize_elemwise.cast_launches += 1
    return out


quantize_elemwise.launches = 0        # every form
quantize_elemwise.nf_launches = 0     # the NormalFloat-codebook format
quantize_elemwise.cast_launches = 0   # the native bf16 / f16 cast format
quantize_elemwise.table_launches = 0  # the table form (bf16)
quantize_elemwise.table_builds = 0    # tables built (one a device and format)
# launches by (elements, bytes an element)
quantize_elemwise.shape_launches = Counter()
