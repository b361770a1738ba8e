"""Deployed weight storage: convert dense params into the packed code
buffers the QDense storage path consumes at serving time.

    storage, slim = build_storage(params, "w4a16", group=64)

packs every eligible 2-D ``kernel`` (the QDense weights, ``lm_head``
included; embeddings are left alone) and *removes it from the params* --
the dense weights never reach the device.  Keys are dotted module paths, so
both dicts load into a model built with
``QuantConfig().with_storage(fmt, group)``:

    model.load_state_dict({**slim, **storage})

The packed dequant matches the corresponding weight fake-quant exactly:

    posit8  == weight spec ``posit8_1``        (exact codes, 1 B/weight)
    mx8     == ``int8,qs=microscaling,bs=G``   (1 B + bf16 block scales)
    w4a16   == ``uint4,qs=group_wise_affine``  (0.5 B + f32 scale/zp)
    w2a16   == ``uint2,qs=group_wise_affine``  (0.25 B + f32 scale/zp)
    w2x4    == w2a16's values in the w4 word layout (0.5 B + scale/zp)
    w8a8    == ``int8,qs=per_channel_symmetric`` weights times dynamic
               per-token int8 activations, an exact integer dot
"""

from typing import Dict, Mapping, Tuple

import torch

from ..utils import resolve_device

__all__ = ["build_storage", "STORAGE_FORMATS", "storage_shapes"]

STORAGE_FORMATS = ("posit8", "mx8", "w4a16", "w2a16", "w2x4", "w8a8")


def _check_format(fmt: str) -> None:
    if fmt not in STORAGE_FORMATS:
        raise ValueError(f"unknown storage format {fmt!r}; "
                         f"expected one of {STORAGE_FORMATS}")


def _pack_kernel(w: torch.Tensor, fmt: str,
                 group: int) -> Dict[str, torch.Tensor]:
    """One (K, N) kernel -> its packed buffers."""
    _check_format(fmt)
    if fmt == "posit8":
        from ..ops.posit_storage import pack_posit_weights
        # encode from bf16, as the dense path fake-quants the bf16-cast
        # kernel (posit8(bf16(w)) can differ from posit8(w) at
        # double-rounding boundaries)
        return {"codes": pack_posit_weights(w.to(torch.bfloat16))}
    if fmt == "mx8":
        from ..ops.mx_storage import pack_mx_weights
        codes, scales = pack_mx_weights(w, block_size=group)
        return {"codes": codes, "scales": scales}
    if fmt == "w8a8":
        from ..ops.int8_matmul import pack_int8_weights
        codes, scale = pack_int8_weights(w)
        return {"codes": codes, "scales": scale}
    from ..ops.affine_storage import (expand_w2_words_to_w4,
                                      pack_affine_weights)
    if fmt == "w2x4":
        # w2 values in the w4 word layout; zp + 6 folds the mid-2 -> mid-8
        # shift so the nbits=4 GEMM computes the same products
        codes2, sf, zp = pack_affine_weights(w, 2, group)
        return {"codes": expand_w2_words_to_w4(codes2), "scales": sf,
                "zero_points": zp + 6.0}
    codes, sf, zp = pack_affine_weights(w, 4 if fmt == "w4a16" else 2, group)
    return {"codes": codes, "scales": sf, "zero_points": zp}


def storage_shapes(fmt: str, K: int, N: int,
                   group: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                  torch.dtype]]:
    """{buffer: (shape, dtype)} of one packed (K, N) kernel."""
    _check_format(fmt)
    if fmt == "posit8":
        return {"codes": ((K, N), torch.int8)}
    if fmt == "mx8":
        return {"codes": ((K, N), torch.int8),
                "scales": ((K // group, N), torch.bfloat16)}
    if fmt == "w8a8":
        return {"codes": ((K, N), torch.int8),
                "scales": ((N,), torch.float32)}
    per = 16 if fmt == "w2a16" else 8
    qp = ((K // group, N), torch.float32)
    return {"codes": ((K // per, N), torch.int32), "scales": qp,
            "zero_points": qp}


def _eligible(name: str, shape: Tuple[int, ...], fmt: str,
              group: int) -> bool:
    """Whether the param ``name`` of ``shape`` is packed: every 2-D
    ``kernel``; for the affine formats only where the contraction dim
    splits into whole groups of whole int32 words (w2x4 packs at 2 bits
    first, so it has the w2 constraint), for mx8 into whole blocks."""
    if not name.endswith("kernel") or len(shape) != 2:
        return False
    _check_format(fmt)
    if fmt in ("w4a16", "w2a16", "w2x4"):
        per = 8 if fmt == "w4a16" else 16
        return group % per == 0 and shape[0] % group == 0
    if fmt == "mx8":
        return shape[0] % group == 0
    return True


def build_storage(params: Mapping[str, torch.Tensor], fmt: str,
                  group: int = 64, *, device="cuda"):
    """(params) -> (storage, slim_params), both {dotted name: tensor} on
    ``device``.

    ``storage`` holds ``<module>.codes`` (and ``.scales``, ``.zero_points``
    where the format has them) where each eligible ``<module>.kernel`` was;
    ``slim_params`` is params with those kernels removed.  Kernels that are
    not eligible stay as ordinary params (QDense keeps its dense path for
    them).
    """
    device = resolve_device(device)
    _check_format(fmt)
    storage, slim = {}, {}
    for name, value in params.items():
        value = value.to(device)
        if _eligible(name, tuple(value.shape), fmt, group):
            prefix = name[:-len("kernel")]
            for key, arr in _pack_kernel(value.to(torch.float32), fmt,
                                         group).items():
                storage[prefix + key] = arr
        else:
            slim[name] = value
    return storage, slim
