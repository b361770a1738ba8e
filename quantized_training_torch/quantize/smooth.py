"""Activation smoothing (SmoothQuant, Xiao et al. 2022) and its per-layer
search (AWQ, Lin et al. 2023) for LLaMA post-training quantization.

Divide each activation channel by ``s_j`` and fold ``s_j`` into the rows
of every kernel that consumes it:

    y = act(x) @ W  ==  (act(x) / s) @ (diag(s) W)

exact in full precision; afterwards the activation quantizes with less
error (it feeds the w8a8 storage format's dynamic int8 activations) while
the scaled weights stay easy.  In LLaMA the activations feeding q/k/v and
gate/up are RMSNorm outputs ``(x / rms) * g``, so the division folds into
the norm's gain ``g / s``: no op is added.  ``s_j = amax_act_j ** alpha /
amax_w_j ** (1 - alpha)`` from per-channel calibration amaxes, which
:func:`calibrate_llama_amax` reads with forward hooks on the two norms.

Params are the port's state dicts ({dotted name: tensor}); amaxes, scales
and alphas are keyed ``layers_i.attn`` / ``layers_i.mlp``.  A fused
``qkv_proj`` kernel takes the place of q/k/v: its columns are theirs.
"""

from typing import Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from ..qspec import QuantizationSpec
from .fake_quant import fake_quantize

__all__ = ["awq_search_llama", "calibrate_llama_amax", "smooth_llama",
           "smoothing_scales"]

_NORMS = (("input_layernorm", "attn"), ("post_attention_layernorm", "mlp"))


def smoothing_scales(act_amax, w_amax, alpha: float = 0.5) -> torch.Tensor:
    """Per-channel migration scales, float32; clamped so that dead
    channels stay put."""
    act = torch.clamp_min(torch.as_tensor(act_amax, dtype=torch.float32),
                          1e-5)
    w = torch.clamp_min(torch.as_tensor(w_amax, dtype=torch.float32), 1e-5)
    s = act ** alpha / w ** (1.0 - alpha)
    return torch.clamp(s, 1e-3, 1e3)


def _norm_outputs(model, ids) -> Dict[str, torch.Tensor]:
    """{``layers_i.attn`` / ``layers_i.mlp``: the norm's output} of one
    forward of ``model`` on ``ids``, through forward hooks."""
    out, handles = {}, []
    for i, layer in enumerate(model.model.layers):
        for norm, key in _NORMS:
            def hook(mod, args, y, key=f"layers_{i}.{key}"):
                out[key] = y
            handles.append(getattr(layer, norm).register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(ids)
    finally:
        for h in handles:
            h.remove()
    return out


def calibrate_llama_amax(model, batches) -> Dict[str, torch.Tensor]:
    """Per-channel amax of each decoder layer's two norm outputs over
    ``batches`` (input_ids tensors): {``layers_i.attn``: (d,),
    ``layers_i.mlp``: (d,)}, the activations feeding q/k/v and gate/up."""
    amax: Dict[str, torch.Tensor] = {}
    for ids in batches:
        for key, y in _norm_outputs(model, ids).items():
            a = y.to(torch.float32).abs().reshape(-1, y.shape[-1]).amax(0)
            amax[key] = torch.maximum(amax[key], a) if key in amax else a
    return amax


def _projections(params: Mapping[str, torch.Tensor], i: int, side: str):
    """(norm scale name, the kernel names its output feeds) of layer i."""
    base = f"model.layers.{i}."
    if side == "mlp":
        return (base + "post_attention_layernorm.scale",
                [base + f"mlp.{p}.kernel" for p in ("gate_proj", "up_proj")])
    fused = base + "self_attn.qkv_proj.kernel"
    projs = ([fused] if fused in params else
             [base + f"self_attn.{p}.kernel"
              for p in ("q_proj", "k_proj", "v_proj")])
    return base + "input_layernorm.scale", projs


def smooth_llama(params: Mapping[str, torch.Tensor],
                 act_amax: Mapping[str, torch.Tensor],
                 alpha: Union[float, Mapping[str, float]] = 0.5):
    """Fold smoothing scales into a ``LlamaForCausalLM`` state dict.

    Each decoder layer's ``input_layernorm.scale /= s_attn`` with
    ``s_attn`` multiplied into the rows of the q/k/v kernels, and
    ``post_attention_layernorm.scale /= s_mlp`` into gate/up's.  The float
    forward is unchanged (an exact linear identity).  ``alpha`` is one
    migration strength or one per site (``{"layers_i.attn": a, ...}``, as
    :func:`awq_search_llama` gives them).  Returns (smoothed params,
    scales)."""
    out = dict(params)
    scales = {}
    for key in sorted(act_amax):
        layer, side = key.split(".")
        norm, projs = _projections(params, int(layer[len("layers_"):]), side)
        a = alpha.get(key, 0.5) if isinstance(alpha, Mapping) else alpha
        w_amax = torch.cat([params[p] for p in projs], dim=1).abs().amax(1)
        s = smoothing_scales(act_amax[key].to(w_amax.device), w_amax, a)
        scales[key] = s
        out[norm] = (params[norm] / s).to(params[norm].dtype)
        for p in projs:
            out[p] = (params[p] * s[:, None]).to(params[p].dtype)
    return out, scales


def awq_search_llama(
    model, batch,
    weight_spec: str = "uint4,qs=group_wise_affine,bs=64,ax=0",
    alphas: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0),
) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """AWQ-style search of the migration strength per layer and side.

    For each decoder layer's two projection groups, the ``alpha`` of the
    grid that minimizes ``sum over the group's kernels of
    ||(X / s) @ Q(diag(s) W) - X @ W||_F^2``, with ``Q`` the target weight
    format's fake-quant (by default the w4a16 storage format's spec) and
    ``X`` the norm output on one calibration batch.  Returns (alphas,
    act_amax), both keyed ``layers_i.attn`` / ``layers_i.mlp``: feed them
    to :func:`smooth_llama`, then build storage from the smoothed params.
    """
    spec = QuantizationSpec.from_str(weight_spec)
    params = model.state_dict()
    best: Dict[str, float] = {}
    amaxes: Dict[str, torch.Tensor] = {}
    for key, y in _norm_outputs(model, batch).items():
        layer, side = key.split(".")
        _, projs = _projections(params, int(layer[len("layers_"):]), side)
        X = y.to(torch.float32).reshape(-1, y.shape[-1])
        act_amax = X.abs().amax(0)
        kernels = [params[p].to(torch.float32) for p in projs]
        w_amax = torch.cat(kernels, dim=1).abs().amax(1)
        ref = [X @ w for w in kernels]
        errs = []
        for a in alphas:
            s = smoothing_scales(act_amax, w_amax, a)
            Xs = X / s[None, :]
            e = 0.0
            for w, r in zip(kernels, ref):
                wq, _ = fake_quantize(w * s[:, None], spec, None,
                                      observe=False)
                e = e + torch.sum((Xs @ wq - r) ** 2)
            errs.append(float(e))
        best[key] = float(alphas[int(np.argmin(errs))])
        amaxes[key] = act_amax
    return best, amaxes
