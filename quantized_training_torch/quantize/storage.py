"""Deployed weight storage: convert dense params into the packed code
buffers the QDense storage path consumes at serving time.

    storage, slim = build_storage(params, "w4a16", group=64)

packs every eligible 2-D ``kernel`` (the QDense weights, ``lm_head``
included; embeddings are left alone) and *removes it from the params* --
the dense weights never reach the device.  Keys are dotted module paths, so
both dicts load into a model built with
``QuantConfig().with_storage("w4a16", 64)``:

    model.load_state_dict({**slim, **storage})

The packed dequant matches the weight fake-quant exactly:
``w4a16 == uint4,qs=group_wise_affine,bs=G,ax=0`` (0.5 B/weight + f32
scale/zero-point per group).  This slice ports w4a16; the other formats
raise and name their ROADMAP item.
"""

from typing import Dict, Mapping, Tuple

import torch

from ..utils import resolve_device

__all__ = ["build_storage", "STORAGE_FORMATS"]

STORAGE_FORMATS = ("posit8", "mx8", "w4a16", "w2a16", "w2x4", "w8a8")
PORTED_FORMATS = ("w4a16",)


def _check_format(fmt: str) -> None:
    if fmt not in STORAGE_FORMATS:
        raise ValueError(f"unknown storage format {fmt!r}; "
                         f"expected one of {STORAGE_FORMATS}")
    if fmt not in PORTED_FORMATS:
        raise NotImplementedError(
            f"storage format {fmt!r} is not ported yet (ROADMAP A9)")


def _pack_kernel(w: torch.Tensor, fmt: str,
                 group: int) -> Dict[str, torch.Tensor]:
    from ..ops.affine_storage import pack_affine_weights
    _check_format(fmt)
    codes, sf, zp = pack_affine_weights(w, 4, group)
    return {"codes": codes, "scales": sf, "zero_points": zp}


def _eligible(name: str, shape: Tuple[int, ...], fmt: str,
              group: int) -> bool:
    """Whether the param ``name`` of ``shape`` is packed: every 2-D
    ``kernel`` whose contraction dim splits into whole groups of whole
    int32 words."""
    if not name.endswith("kernel") or len(shape) != 2:
        return False
    _check_format(fmt)
    return group % 8 == 0 and shape[0] % group == 0


def build_storage(params: Mapping[str, torch.Tensor], fmt: str,
                  group: int = 64, *, device="cuda"):
    """(params) -> (storage, slim_params), both {dotted name: tensor} on
    ``device``.

    ``storage`` holds ``<module>.codes/.scales/.zero_points`` where each
    eligible ``<module>.kernel`` was; ``slim_params`` is params with those
    kernels removed.  Kernels that are not eligible stay as ordinary params
    (QDense keeps its dense path for them).
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
