"""GPTQ: error-compensated weight rounding for the affine storage formats.

Round-to-nearest (``pack_affine_weights``) quantizes each weight alone;
GPTQ (Frantar et al., 2023) minimizes the layer output error
``||X W - X W_q||_F`` instead: it quantizes the contraction dimension row
by row and folds each row's rounding error into the rows not yet
quantized through the inverse Hessian ``(X^T X)^{-1}``.  It feeds the
``w4a16`` and ``w2a16`` storage that the affine storage GEMM serves.

Pipeline::

    # 1. calibrate: QDense layers add X^T X of their (post-input-rounding)
    #    matmul operand, keyed by module path, while the context is open
    hessians = None
    for batch in batches:
        with collect_hessians(model) as col:
            model(batch)
        hessians = accumulate_gptq(hessians, col)

    # 2. quantize + pack into the affine storage layout
    storage, slim = build_storage_gptq(params, hessians, "w4a16", group=64)

    # 3. serve exactly like RTN-packed storage
    model = LlamaForCausalLM(cfg, QuantConfig().with_storage("w4a16", 64))
    model.load_state_dict({**slim, **storage})

The arithmetic is the reference's: the Hessian in float64 (damped, its
inverse's upper Cholesky factor), the weights, errors and updates in
float32, groups' qparams from the current (error-fed) rows with the RTN
format's min/max rule, codes rounded half to even, update blocks rounded
to whole groups, rows of dead inputs (a zero Hessian diagonal) zeroed, no
``act_order``.  So the packed result runs on the unmodified storage GEMM.
It runs on the device the caller names (``device``), the card for 7B
shapes.
"""

import contextlib
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..ops.affine_storage import plane_pack
from ..utils import resolve_device
from .storage import _eligible, _pack_kernel

__all__ = ["accumulate_gptq", "build_storage_gptq", "collect_hessians",
           "gptq_quantize", "hessian_from_inputs"]


def hessian_from_inputs(x) -> torch.Tensor:
    """``X^T X`` in float32 of a batch of layer inputs (leading dims
    flattened).  The update uses only ratios of inverse-Hessian entries,
    so any normalization cancels and raw sums over batches are exact."""
    x = torch.as_tensor(x)
    x2 = x.to(torch.float32).reshape(-1, x.shape[-1])
    return x2.T @ x2


@contextlib.contextmanager
def collect_hessians(model: torch.nn.Module):
    """Within the context every dense (unpacked) ``QDense`` of ``model``
    adds the Hessian of its matmul operand (after its input rounding) to
    the yielded dict, keyed by the layer's module path (the JAX package's
    path: ``model.layers_0.self_attn.q_proj``, or ``...qkv_proj`` with a
    fused projection).  No forward outside the context computes one."""
    from ..models.layers import QDense
    col: Dict[str, torch.Tensor] = {}
    layers = [m for m in model.modules() if isinstance(m, QDense)]
    for layer in layers:
        layer.hessians = col
    try:
        yield col
    finally:
        for layer in layers:
            layer.hessians = None


def accumulate_gptq(total: Optional[Dict[str, torch.Tensor]],
                    col: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Sum one calibration batch's Hessians into a running total (the same
    module paths in both)."""
    col = {key: h.to(torch.float32) for key, h in col.items()}
    if total is None:
        return col
    if set(total) != set(col):
        raise ValueError("the batches' Hessians cover other layers: "
                         f"{sorted(set(total) ^ set(col))}")
    return {key: total[key] + h for key, h in col.items()}


def _affine_qparams(w: torch.Tensor, qmin: int, qmax: int):
    """float32 group qparams over axis 0, the RTN format's rule
    (quantize/fake_quant.py:_group_affine_qparams)."""
    mn = w.amin(dim=0)
    mx = w.amax(dim=0)
    sf = (mx - mn) / float(qmax - qmin)
    sf = torch.where(sf > 0.0, sf, torch.ones_like(sf))
    zp = -mn / sf + float(qmin)
    return sf, zp


@torch.no_grad()
def gptq_quantize(w, hessian, nbits: int = 4, group_size: int = 128,
                  percdamp: float = 0.01, block_size: int = 128, *,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """Quantize ``w`` (K, N) to uintN group-affine codes, GPTQ-style, on
    ``device`` (default: ``w``'s).

    ``hessian`` is the (K, K) accumulated ``X^T X`` of the layer's inputs.
    Returns ``(wq, codes, sf, zp)``: the dequantized weights (float32,
    bit-equal to what the storage GEMM reconstructs), the int32 codes
    (K, N) and per-group qparams (K/group_size, N) for
    :func:`~quantized_training_torch.ops.affine_storage.plane_pack`.  A
    diagonal Hessian gives the RTN packing exactly.  On CUDA the float32
    products must not run in TF32 (PyTorch's default).
    """
    w = torch.as_tensor(w)
    device = w.device if device is None else resolve_device(device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("gptq_quantize runs float32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    W = w.to(device=device, dtype=torch.float32).clone()
    K, N = W.shape
    if K % group_size:
        raise ValueError(f"K={K} not a multiple of group_size={group_size}")
    qmin, qmax = 0, (1 << nbits) - 1
    block_size = max(block_size - block_size % group_size, group_size)

    H = torch.as_tensor(hessian).to(device=device, dtype=torch.float64)
    if tuple(H.shape) != (K, K):
        raise ValueError(f"hessian shape {tuple(H.shape)} != ({K}, {K})")
    H = H.clone()
    diag = H.diagonal()                      # a view: writes land in H
    dead = diag == 0
    diag[dead] = 1.0
    W[dead] = 0.0
    diag += percdamp * diag.mean()

    # Upper Cholesky factor U of H^{-1} (H^{-1} = U^T U): row k holds the
    # propagation weights from row k onto the rows after it.  The float32
    # copy is what every update reads.
    Hinv = torch.linalg.cholesky(torch.linalg.inv(H)).T.to(torch.float32)

    C = torch.empty_like(W)                  # the codes, as floats
    sf = torch.zeros((K // group_size, N), dtype=torch.float32,
                     device=device)
    zp = torch.zeros_like(sf)
    for i1 in range(0, K, block_size):
        i2 = min(i1 + block_size, K)
        cnt = i2 - i1
        Wb = W[i1:i2]                        # a view: updates land in W
        Hb = Hinv[i1:i2, i1:i2]
        Eb = torch.empty((cnt, N), dtype=torch.float32, device=device)
        for k in range(cnt):
            g = (i1 + k) // group_size
            if (i1 + k) % group_size == 0:
                # the group's qparams from the current rows, which carry
                # every earlier row's error feedback
                sf[g], zp[g] = _affine_qparams(Wb[k:k + group_size], qmin,
                                               qmax)
            row = Wb[k]
            c = torch.clamp(torch.round(row / sf[g] + zp[g]), qmin, qmax,
                            out=C[i1 + k])
            err = torch.div(row - (c - zp[g]) * sf[g], Hb[k, k], out=Eb[k])
            if k + 1 < cnt:
                Wb[k + 1:] -= torch.outer(Hb[k, k + 1:], err)
        if i2 < K:
            # the lazy update of every row past the block
            W[i2:] -= Hinv[i1:i2, i2:].T @ Eb
    # the dequantized weights by the same (c - zp) * sf as each row's error
    rows = torch.arange(K, device=device) // group_size
    Q = (C - zp[rows]) * sf[rows]
    return Q, C.to(torch.int32), sf, zp


def _module_path(name: str) -> str:
    """A state-dict kernel name -> its layer's module path, the key of its
    Hessian (``model.layers.0.mlp.up_proj.kernel`` ->
    ``model.layers_0.mlp.up_proj``)."""
    parts = name[:-len(".kernel")].split(".")
    out = []
    for part in parts:
        if part.isdigit() and out and out[-1] == "layers":
            out[-1] = f"layers_{part}"
        else:
            out.append(part)
    return ".".join(out)


def build_storage_gptq(params: Mapping[str, torch.Tensor],
                       hessians: Optional[Mapping[str, torch.Tensor]],
                       fmt: str, group: int = 64, percdamp: float = 0.01,
                       block_size: int = 128, *, device="cuda"):
    """GPTQ's :func:`~quantized_training_torch.quantize.build_storage`:
    (params, hessians) -> (storage, slim_params) on ``device``, the same
    names, layouts and dtypes.  Eligible kernels with a Hessian (keyed by
    module path, as :func:`collect_hessians` gives them) get GPTQ codes,
    eligible kernels without one the RTN packing; the rest stay dense."""
    if fmt not in ("w4a16", "w2a16"):
        raise ValueError(
            f"GPTQ targets the group-affine formats, got {fmt!r} (posit8 "
            "storage is exact; mx8 has no zero-point to absorb error "
            "feedback into)")
    device = resolve_device(device)
    nbits = 4 if fmt == "w4a16" else 2
    hessians = hessians or {}
    storage, slim = {}, {}
    for name, value in params.items():
        value = value.to(device)
        if not _eligible(name, tuple(value.shape), fmt, group):
            slim[name] = value
            continue
        prefix = name[:-len("kernel")]
        H = hessians.get(_module_path(name))
        if H is None:
            packed = _pack_kernel(value.to(torch.float32), fmt, group)
        else:
            _, c, s, z = gptq_quantize(value, H, nbits, group, percdamp,
                                       block_size, device=device)
            packed = dict(zip(("codes", "scales", "zero_points"),
                              plane_pack(c, s, z, nbits, group)))
        for key, arr in packed.items():
            storage[prefix + key] = arr
    return storage, slim
