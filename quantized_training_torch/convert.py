"""Weights for the port's modules: from a JAX-side param tree, or random.

``params_from_jax`` maps the nested param / storage trees of the JAX
package's LLaMA (as numpy arrays) onto this package's state-dict names, so
both packages can compute with identical weights:

    sd = params_from_jax(params_np, storage_np)
    model.load_state_dict(sd)

``random_params`` builds seeded random weights directly on the device,
leaf by leaf, packing each eligible kernel as soon as it exists, so the
dense float32 model never exists whole (the 7B lm_head, 0.5 GB in f32, is
the largest transient).
"""

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .models.layers import Embed, QDense, QRMSNorm
from .models.llama import LlamaConfig, LlamaForCausalLM
from .quantize.config import QuantConfig
from .quantize.storage import _pack_kernel
from .utils import resolve_device

__all__ = ["params_from_jax", "random_params"]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if key.startswith("layers_") and key[7:].isdigit():
            key = f"layers.{key[7:]}"      # flax layers_i -> ModuleList index
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # exact through float32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))    # a writable copy


def params_from_jax(params_np: Mapping,
                    storage_np: Optional[Mapping] = None
                    ) -> Dict[str, torch.Tensor]:
    """Nested JAX ``params`` (and optional ``storage``) trees of numpy
    arrays -> {state-dict name: CPU tensor}.  Kernels keep the (in, out)
    layout; packed codes and qparams keep their storage layout."""
    flat = _flatten(params_np)
    if storage_np:
        flat.update(_flatten(storage_np))
    return {name: _to_torch(val) for name, val in flat.items()}


@torch.no_grad()
def random_params(cfg: LlamaConfig, fmt: Optional[str] = "w4a16",
                  group: int = 64, seed: int = 0,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Seeded random weights for ``LlamaForCausalLM(cfg, qc)`` with
    ``qc = QuantConfig().with_storage(fmt, group)`` (or no qconfig when
    ``fmt`` is None): kernels ~ N(0, 1/fan_in), packed where eligible;
    embedding ~ N(0, 0.02^2); norm scales one.  Load with
    ``model.load_state_dict(params, assign=True)``."""
    device = resolve_device(device)
    qc = QuantConfig().with_storage(fmt, group) if fmt else None
    skeleton = LlamaForCausalLM(cfg, qc, device="meta")
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, mod in skeleton.named_modules():
        if isinstance(mod, QDense):
            w = torch.randn((mod.in_features, mod.features), generator=gen,
                            device=device) / math.sqrt(mod.in_features)
            if mod.storage:
                for key, arr in _pack_kernel(w, fmt, group).items():
                    out[f"{name}.{key}"] = arr
            else:
                out[f"{name}.kernel"] = w
            del w
        elif isinstance(mod, Embed):
            out[f"{name}.embedding"] = torch.randn(
                mod.embedding.shape, generator=gen, device=device) * 0.02
        elif isinstance(mod, QRMSNorm):
            out[f"{name}.scale"] = torch.ones(mod.scale.shape, device=device)
    return out
