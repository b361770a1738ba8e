"""HuggingFace checkpoint conversion: an HF state dict (numpy arrays or
torch tensors, keyed by HF names) -> this package's state dicts
(reference: models/hf_loader.py).

Loading is a name and layout mapping: torch Linear weights (out, in)
transpose to kernels (in, out); LayerNorm weight/bias become scale/bias;
embeddings stay as they are.  Every value comes out as a float32 CPU
tensor under the port's state-dict name (the reference's param path with
``.`` for ``/``), ready for ``model.load_state_dict``.  Reading
checkpoint files from disk is not ported yet.
"""

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["convert_bert"]


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
