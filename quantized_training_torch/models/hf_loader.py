"""HuggingFace checkpoint conversion: an HF state dict (numpy arrays or
torch tensors, keyed by HF names) -> this package's state dicts
(reference: models/hf_loader.py).

Loading is a name and layout mapping: torch Linear weights (out, in)
transpose to kernels (in, out); LayerNorm weight/bias become scale/bias;
embeddings stay as they are.  Every value comes out as a float32 CPU
tensor under the port's state-dict name (the reference's param path with
``.`` for ``/``), ready for ``model.load_state_dict``.  A directory of
``.safetensors`` shards is read by :func:`load_state_dict_dir`, which parses
the format itself (the ``safetensors`` package is not needed).
"""

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["convert_bert", "convert_llama", "convert_phi3",
           "load_state_dict_dir", "maybe_fuse_qkv"]

_SAFETENSORS_DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16,
                       "F16": torch.float16}


def _read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header of {name: {dtype, shape, data_offsets}}, then the raw
    little-endian tensor bytes, offsets counted from the end of the
    header.  The tensors are views of one buffer holding the file."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']} (F32, BF16 and F16 are read)")
        begin, end = info["data_offsets"]
        count = (end - begin) // dtype.itemsize
        flat = (torch.frombuffer(data, dtype=dtype, count=count,
                                 offset=base + begin) if count
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def load_state_dict_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every ``.safetensors`` shard of a directory, in name order, as one
    {HF name: CPU tensor} dict (F32, BF16 and F16 tensors)."""
    state = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors"):
            state.update(_read_safetensors(os.path.join(path, fname)))
    if not state:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return state


def _np(t) -> np.ndarray:
    """A torch tensor or numpy array -> numpy (f32 for bf16 storage)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _set(out: Dict, name: str, value) -> None:
    out[name] = torch.from_numpy(np.array(value, dtype=np.float32))


def _dense(out: Dict, ours: str, state: Mapping, theirs: str) -> None:
    _set(out, f"{ours}.kernel", _np(state[f"{theirs}.weight"]).T)
    if f"{theirs}.bias" in state:
        _set(out, f"{ours}.bias", _np(state[f"{theirs}.bias"]))


def _norm_(out: Dict, ours: str, state: Mapping, theirs: str) -> None:
    _set(out, f"{ours}.scale", _np(state[f"{theirs}.weight"]))
    if f"{theirs}.bias" in state:
        _set(out, f"{ours}.bias", _np(state[f"{theirs}.bias"]))


def _embed(out: Dict, ours: str, state: Mapping, theirs: str) -> None:
    _set(out, f"{ours}.embedding", _np(state[f"{theirs}.weight"]))


def convert_bert(state: Mapping, num_layers: int, prefix: str = "bert",
                 heads=("qa_outputs", "classifier")) -> Dict[str, torch.Tensor]:
    """HF BertFor* state dict -> the state dict of this package's BertFor*
    (also RoBERTa with prefix="roberta")."""
    p: Dict[str, torch.Tensor] = {}
    emb = f"{prefix}.embeddings"
    _embed(p, "bert.embeddings.word_embeddings", state,
           f"{emb}.word_embeddings")
    _embed(p, "bert.embeddings.position_embeddings", state,
           f"{emb}.position_embeddings")
    if f"{emb}.token_type_embeddings.weight" in state:
        _embed(p, "bert.embeddings.token_type_embeddings", state,
               f"{emb}.token_type_embeddings")
    _norm_(p, "bert.embeddings.layernorm", state, f"{emb}.LayerNorm")

    for i in range(num_layers):
        hf = f"{prefix}.encoder.layer.{i}"
        ours = f"bert.layer_{i}"
        for proj in ("query", "key", "value"):
            _dense(p, f"{ours}.attention_self.{proj}", state,
                   f"{hf}.attention.self.{proj}")
        _dense(p, f"{ours}.attention_output_dense", state,
               f"{hf}.attention.output.dense")
        _norm_(p, f"{ours}.attention_output_layernorm", state,
               f"{hf}.attention.output.LayerNorm")
        _dense(p, f"{ours}.intermediate_dense", state,
               f"{hf}.intermediate.dense")
        _dense(p, f"{ours}.output_dense", state, f"{hf}.output.dense")
        _norm_(p, f"{ours}.output_layernorm", state,
               f"{hf}.output.LayerNorm")

    if f"{prefix}.pooler.dense.weight" in state:
        _dense(p, "bert.pooler_dense", state, f"{prefix}.pooler.dense")
    for head in heads:
        if f"{head}.weight" in state:
            _dense(p, head, state, head)
    return p


def convert_llama(state: Mapping, num_layers: int,
                  tie_word_embeddings: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """HF LlamaForCausalLM state dict -> the state dict of this package's
    LlamaForCausalLM (unfused q/k/v)."""
    p: Dict[str, torch.Tensor] = {}
    _embed(p, "model.embed_tokens", state, "model.embed_tokens")
    for i in range(num_layers):
        hf, ours = f"model.layers.{i}", f"model.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _dense(p, f"{ours}.self_attn.{proj}", state,
                   f"{hf}.self_attn.{proj}")
        for proj in ("gate_proj", "up_proj", "down_proj"):
            _dense(p, f"{ours}.mlp.{proj}", state, f"{hf}.mlp.{proj}")
        _norm_(p, f"{ours}.input_layernorm", state, f"{hf}.input_layernorm")
        _norm_(p, f"{ours}.post_attention_layernorm", state,
               f"{hf}.post_attention_layernorm")
    _norm_(p, "model.norm", state, "model.norm")
    if not tie_word_embeddings and "lm_head.weight" in state:
        _dense(p, "lm_head", state, "lm_head")
    return p


def convert_phi3(state: Mapping, num_layers: int, num_heads: int,
                 num_kv_heads: int, head_dim: int) -> Dict[str, torch.Tensor]:
    """HF Phi3ForCausalLM state dict -> the state dict of this package's
    LlamaForCausalLM (unfused q/k/v).

    Phi-3 is LLaMA with fused projections: ``qkv_proj`` (rows q, then k,
    then v: ``num_heads * head_dim`` and twice ``num_kv_heads * head_dim``)
    splits into q/k/v, and ``gate_up_proj`` into gate and up at half its
    rows.  ``maybe_fuse_qkv`` then builds the group-interleaved fused
    layout when the config asks for it."""
    p: Dict[str, torch.Tensor] = {}
    _embed(p, "model.embed_tokens", state, "model.embed_tokens")
    q_rows = num_heads * head_dim
    kv_rows = num_kv_heads * head_dim
    for i in range(num_layers):
        hf, ours = f"model.layers.{i}", f"model.layers.{i}"
        qkv = _np(state[f"{hf}.self_attn.qkv_proj.weight"])
        _set(p, f"{ours}.self_attn.q_proj.kernel", qkv[:q_rows].T)
        _set(p, f"{ours}.self_attn.k_proj.kernel",
             qkv[q_rows:q_rows + kv_rows].T)
        _set(p, f"{ours}.self_attn.v_proj.kernel", qkv[q_rows + kv_rows:].T)
        _dense(p, f"{ours}.self_attn.o_proj", state, f"{hf}.self_attn.o_proj")
        gate_up = _np(state[f"{hf}.mlp.gate_up_proj.weight"])
        inter = gate_up.shape[0] // 2
        _set(p, f"{ours}.mlp.gate_proj.kernel", gate_up[:inter].T)
        _set(p, f"{ours}.mlp.up_proj.kernel", gate_up[inter:].T)
        _dense(p, f"{ours}.mlp.down_proj", state, f"{hf}.mlp.down_proj")
        _norm_(p, f"{ours}.input_layernorm", state, f"{hf}.input_layernorm")
        _norm_(p, f"{ours}.post_attention_layernorm", state,
               f"{hf}.post_attention_layernorm")
    _norm_(p, "model.norm", state, "model.norm")
    if "lm_head.weight" in state:
        _dense(p, "lm_head", state, "lm_head")
    return p


def maybe_fuse_qkv(params: Mapping[str, torch.Tensor], cfg) -> Dict:
    """The fused-qkv layout when ``cfg.fused_qkv`` is set (checkpoints
    store q/k/v unfused; see ``llama.fuse_qkv_params``)."""
    if getattr(cfg, "fused_qkv", False):
        from .llama import fuse_qkv_params
        return fuse_qkv_params(params, cfg)
    return dict(params)
