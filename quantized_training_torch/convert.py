"""Weights for the port's modules: from a JAX-side param tree, or random.

``params_from_jax`` maps the nested param / storage trees of the JAX
package's LLaMA (as numpy arrays) onto this package's state-dict names, so
both packages can compute with identical weights:

    sd = params_from_jax(params_np, storage_np)
    model.load_state_dict(sd)

``cache_from_jax`` turns one layer of a JAX cache into the port's (a
``QuantizedKVCache``, or the full-precision ring's ``cache_k``/``cache_v``
variables), so both packages can decode from one state.

``adam8bit_state_from_jax`` maps the JAX package's 8-bit Adam state onto
an :class:`~training.optim8bit.Adam8bit` of the same parameters, so both
packages can step from one non-zero state.

``random_params`` builds seeded random weights directly on the device,
leaf by leaf, packing each eligible kernel as soon as it exists, so the
dense float32 model never exists whole (the 7B lm_head, 0.5 GB in f32, is
the largest transient).  ``bert_random_params`` does the same for a BERT
model (dense kernels, LoRA adapters where the config asks for them).

``params_from_jax`` serves both families: the BERT tree's module names
(``layer_0``, ``attention_self``, ...) are the port's attribute names.
"""

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .models.bert import BertConfig, BertForSequenceClassification
from .models.layers import Embed, QDense, QRMSNorm
from .models.llama import LlamaConfig, LlamaForCausalLM
from .quantize.config import QuantConfig
from .quantize.storage import _pack_kernel
from .serving.kv_cache import FullPrecisionCache, QuantizedKVCache
from .utils import resolve_device

__all__ = ["adam8bit_state_from_jax", "bert_random_params", "cache_from_jax",
           "params_from_jax", "random_params"]


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


def cache_from_jax(cache_np):
    """One layer's JAX cache (fields as numpy arrays) -> the port's, as CPU
    tensors of the same dtypes and layouts: a ``QuantizedKVCache`` from the
    two-tier cache, a :class:`FullPrecisionCache` from the full-precision
    ring's ``{"cache_k": ..., "cache_v": ...}`` (the attention module's
    cache variables)."""
    if isinstance(cache_np, Mapping):
        return FullPrecisionCache(_to_torch(cache_np["cache_k"]),
                                  _to_torch(cache_np["cache_v"]))
    return QuantizedKVCache(*(_to_torch(a) for a in cache_np))


def adam8bit_state_from_jax(jax_state, optimizer: torch.optim.Optimizer,
                            model: torch.nn.Module) -> dict:
    """A JAX ``ScaleByAdam8bitState`` (``count``, and ``mu``/``nu`` trees
    of ``(codes, scale)`` pairs over the param tree, as numpy arrays) ->
    a state dict for ``optimizer.load_state_dict``.  ``optimizer`` is an
    ``Adam8bit`` over parameters of ``model``; each takes the moments of
    its state-dict name.  Codes, words and scales keep their layouts and
    dtypes (f32 exact, int32 packed, int8/uint8 unpacked)."""
    names = {id(p): n for n, p in model.named_parameters()}
    mu, nu = _flatten(jax_state.mu), _flatten(jax_state.nu)
    count = int(np.asarray(jax_state.count))
    state, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            state[index] = dict(
                count=count,
                mu_codes=_to_torch(mu[name].codes),
                mu_scale=_to_torch(mu[name].scale),
                nu_codes=_to_torch(nu[name].codes),
                nu_scale=_to_torch(nu[name].scale))
            index += 1
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


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


@torch.no_grad()
def bert_random_params(cfg: BertConfig, qconfig: Optional[QuantConfig] = None,
                       seed: int = 0, device="cuda"
                       ) -> Dict[str, torch.Tensor]:
    """Seeded random weights for ``BertForSequenceClassification(cfg,
    qconfig)``, as the reference initializes them: kernels ~ N(0,
    1/fan_in), embeddings and ``lora_a`` ~ N(0, 0.02^2), ``lora_b`` and
    biases zero, LayerNorm scales one.  Load with
    ``model.load_state_dict(params)``."""
    device = resolve_device(device)
    skeleton = BertForSequenceClassification(cfg, qconfig, device="meta")
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, p in skeleton.named_parameters():
        kind = name.rsplit(".", 1)[-1]
        if kind == "kernel":
            t = torch.randn(p.shape, generator=gen, device=device) / math.sqrt(
                p.shape[0])
        elif kind in ("embedding", "lora_a"):
            t = torch.randn(p.shape, generator=gen, device=device) * 0.02
        elif kind == "scale":
            t = torch.ones(p.shape, device=device)
        else:                                   # bias, lora_b
            t = torch.zeros(p.shape, device=device)
        out[name] = t
    return out
