"""BERT family with quantization sites (reference: models/bert.py, after
modules/quantizable/modeling_bert.py and the module swap table at
quantization_mappings.py:27-43).

Self-attention with quantized q.k and p.v inputs, attention scaling
(scaling category), softmax (activation), residual adds wrapped in quant
sites, LayerNorm inputs (layernorm category) and the exact-erf gelu input
(activation).  Heads: question answering (SQuAD), sequence classification
(GLUE, with the pooler), masked LM.

Module names follow the reference's param tree, so a state-dict name is
its JAX path with ``.`` for ``/`` (``bert.layer_0.attention_self.query.
lora_a``); ``convert.params_from_jax`` and ``models/hf_loader.py`` map
weights onto them.  Every module is built on ``device``, CUDA unless the
caller asks for the CPU.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..quantize.config import OpCategory, QuantConfig
from ..utils import resolve_device
from .layers import Embed, QDense, QLayerNorm, QSoftmax, QuantMixin

__all__ = ["BertConfig", "BertModel", "BertForQuestionAnswering",
           "BertForSequenceClassification", "BertForMaskedLM",
           "extended_attention_mask", "gelu_exact"]

_SQRT_HALF = float(np.float32(np.sqrt(0.5)))


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    position_offset: int = 0  # RoBERTa uses 2
    hidden_act: str = "gelu"
    dtype: str = "bfloat16"
    num_labels: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        d = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=64, type_vocab_size=2)
        d.update(kw)
        return BertConfig(**d)

    @staticmethod
    def bert_base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def bert_large() -> "BertConfig":
        return BertConfig(hidden_size=1024, num_hidden_layers=24,
                          num_attention_heads=16, intermediate_size=4096)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The exact-erf gelu in the reference's form, 0.5 * x * erfc(-x *
    sqrt(1/2)) (jax.nn.gelu(approximate=False))."""
    return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF)


def extended_attention_mask(attention_mask: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    """(B, S) 1/0 mask -> additive (B, 1, 1, S), filled with the bf16
    minimum where the mask is 0."""
    mask_value = float(torch.finfo(torch.bfloat16).min)
    add = (1.0 - attention_mask.to(torch.float32)) * mask_value
    return add[:, None, None, :].to(dtype)


def _join(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


class BertSelfAttention(nn.Module, QuantMixin):
    def __init__(self, cfg: BertConfig, qconfig, path: str, device):
        super().__init__()
        self.config, self.qconfig, self.path = cfg, qconfig, path
        width = cfg.num_attention_heads * cfg.head_dim
        dense = lambda name: QDense(
            cfg.hidden_size, width, qconfig=qconfig, path=_join(path, name),
            dtype=cfg.torch_dtype, device=device)
        self.query, self.key, self.value = (dense("query"), dense("key"),
                                            dense("value"))
        self.softmax = QSoftmax(qconfig=qconfig,
                                path=_join(path, "softmax"),
                                dtype=cfg.torch_dtype)

    def forward(self, hidden, attention_mask):
        cfg = self.config
        dtype, f32 = cfg.torch_dtype, torch.float32
        B, S, _ = hidden.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        q = self.query(hidden).reshape(B, S, H, D)
        k = self.key(hidden).reshape(B, S, H, D)
        v = self.value(hidden).reshape(B, S, H, D)
        qq = self.quant_input(q, "matmul", OpCategory.GEMM, 0)
        kk = self.quant_input(k, "matmul", OpCategory.GEMM, 1)
        scores = torch.einsum("bshd,bthd->bhst", qq.to(f32), kk.to(f32))
        scale = (1.0 / torch.sqrt(torch.tensor(float(D)))).to(dtype)
        scores = self.quant_mul(scores.to(dtype),
                                scale.to(hidden.device)).to(f32)
        if attention_mask is not None:
            scores = scores + attention_mask.to(f32)
        probs = self.softmax(scores.to(dtype))
        pp = self.quant_input(probs, "matmul", OpCategory.GEMM, 0,
                              hook="av_pre_process")
        vv = self.quant_input(v, "matmul", OpCategory.GEMM, 1,
                              hook="av_pre_process")
        ctx = torch.einsum("bhst,bthd->bshd", pp.to(f32), vv.to(f32))
        return ctx.to(dtype).reshape(B, S, H * D)


class BertLayer(nn.Module, QuantMixin):
    def __init__(self, cfg: BertConfig, qconfig, path: str, device):
        super().__init__()
        self.config, self.qconfig, self.path = cfg, qconfig, path
        dt = cfg.torch_dtype
        dense = lambda fin, fout, name: QDense(
            fin, fout, qconfig=qconfig, path=_join(path, name), dtype=dt,
            device=device)
        norm = lambda name: QLayerNorm(
            cfg.hidden_size, epsilon=cfg.layer_norm_eps, qconfig=qconfig,
            path=_join(path, name), dtype=dt, device=device)
        width = cfg.num_attention_heads * cfg.head_dim
        self.attention_self = BertSelfAttention(
            cfg, qconfig, _join(path, "attention_self"), device)
        self.attention_output_dense = dense(width, cfg.hidden_size,
                                            "attention_output_dense")
        self.attention_output_layernorm = norm("attention_output_layernorm")
        self.intermediate_dense = dense(cfg.hidden_size,
                                        cfg.intermediate_size,
                                        "intermediate_dense")
        self.output_dense = dense(cfg.intermediate_size, cfg.hidden_size,
                                  "output_dense")
        self.output_layernorm = norm("output_layernorm")

    def forward(self, hidden, attention_mask):
        attn_out = self.attention_output_dense(
            self.attention_self(hidden, attention_mask))
        hidden = self.quant_residual(attn_out, hidden, hook="attn_residual")
        hidden = self.attention_output_layernorm(hidden)
        inter = self.intermediate_dense(hidden)
        inter = self.quant_activation_input(inter, "gelu")
        inter = gelu_exact(inter.to(torch.float32)).to(self.config.torch_dtype)
        out = self.output_dense(inter)
        hidden = self.quant_residual(out, hidden, hook="ffn_residual")
        return self.output_layernorm(hidden)


class BertEmbeddings(nn.Module, QuantMixin):
    def __init__(self, cfg: BertConfig, qconfig, path: str, device):
        super().__init__()
        self.config, self.qconfig, self.path = cfg, qconfig, path
        emb = lambda n: Embed(n, cfg.hidden_size, dtype=cfg.torch_dtype,
                              device=device)
        self.word_embeddings = emb(cfg.vocab_size)
        self.position_embeddings = emb(cfg.max_position_embeddings
                                       + cfg.position_offset)
        self.token_type_embeddings = (emb(cfg.type_vocab_size)
                                      if cfg.type_vocab_size > 0 else None)
        self.layernorm = QLayerNorm(
            cfg.hidden_size, epsilon=cfg.layer_norm_eps, qconfig=qconfig,
            path=_join(path, "layernorm"), dtype=cfg.torch_dtype,
            device=device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        cfg = self.config
        S = input_ids.shape[1]
        if position_ids is None:
            position_ids = (torch.arange(S, device=input_ids.device)[None, :]
                            + cfg.position_offset)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids))
        if self.token_type_embeddings is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.layernorm(emb)


class BertModel(nn.Module, QuantMixin):
    """Embeddings, ``num_hidden_layers`` encoder layers (``layer_{i}``) and,
    with ``add_pooler``, the tanh pooler over the first token.
    ``forward(input_ids, attention_mask=None, token_type_ids=None,
    position_ids=None) -> (hidden, pooled or None)``."""

    def __init__(self, config: BertConfig,
                 qconfig: Optional[QuantConfig] = None, *, add_pooler=False,
                 path: str = "", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.qconfig, self.path = config, qconfig, path
        self.embeddings = BertEmbeddings(config, qconfig,
                                         _join(path, "embeddings"), device)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(
                config, qconfig, _join(path, f"layer_{i}"), device))
        self.pooler_dense = (QDense(
            config.hidden_size, config.hidden_size, qconfig=qconfig,
            path=_join(path, "pooler_dense"), dtype=config.torch_dtype,
            device=device) if add_pooler else None)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None):
        mask = (extended_attention_mask(attention_mask)
                if attention_mask is not None else None)
        hidden = self.embeddings(input_ids, token_type_ids, position_ids)
        for i in range(self.config.num_hidden_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, mask)
        pooled = None
        if self.pooler_dense is not None:
            pooled = self.pooler_dense(hidden[:, 0])
            pooled = torch.tanh(pooled.to(torch.float32)).to(hidden.dtype)
        return hidden, pooled


class BertForQuestionAnswering(nn.Module, QuantMixin):
    """SQuAD head: ``forward(...) -> (start_logits, end_logits)``, f32."""

    def __init__(self, config: BertConfig,
                 qconfig: Optional[QuantConfig] = None, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.qconfig, self.path = config, qconfig, ""
        self.bert = BertModel(config, qconfig, path="bert", device=device)
        self.qa_outputs = QDense(config.hidden_size, 2, qconfig=qconfig,
                                 path="qa_outputs", dtype=config.torch_dtype,
                                 device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        hidden, _ = self.bert(input_ids, attention_mask, token_type_ids)
        logits = self.qa_outputs(hidden).to(torch.float32)
        start, end = logits.split(1, dim=-1)
        return start.squeeze(-1), end.squeeze(-1)


class BertForSequenceClassification(nn.Module, QuantMixin):
    """GLUE head over the pooler: ``forward(...) -> logits`` (B,
    num_labels), f32."""

    def __init__(self, config: BertConfig,
                 qconfig: Optional[QuantConfig] = None, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.qconfig, self.path = config, qconfig, ""
        self.bert = BertModel(config, qconfig, add_pooler=True, path="bert",
                              device=device)
        self.classifier = QDense(config.hidden_size, config.num_labels,
                                 qconfig=qconfig, path="classifier",
                                 dtype=config.torch_dtype, device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids)
        return self.classifier(pooled).to(torch.float32)


class BertForMaskedLM(nn.Module, QuantMixin):
    """Masked-LM head: ``forward(...) -> logits`` (B, S, vocab), f32."""

    def __init__(self, config: BertConfig,
                 qconfig: Optional[QuantConfig] = None, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.qconfig, self.path = config, qconfig, ""
        dt = config.torch_dtype
        self.bert = BertModel(config, qconfig, path="bert", device=device)
        self.transform_dense = QDense(
            config.hidden_size, config.hidden_size, qconfig=qconfig,
            path="transform_dense", dtype=dt, device=device)
        self.transform_layernorm = QLayerNorm(
            config.hidden_size, epsilon=config.layer_norm_eps,
            qconfig=qconfig, path="transform_layernorm", dtype=dt,
            device=device)
        self.decoder = QDense(config.hidden_size, config.vocab_size,
                              qconfig=qconfig, path="decoder", dtype=dt,
                              device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        dt = self.config.torch_dtype
        hidden, _ = self.bert(input_ids, attention_mask, token_type_ids)
        x = self.transform_dense(hidden)
        x = gelu_exact(x.to(torch.float32)).to(dt)
        x = self.transform_layernorm(x)
        return self.decoder(x).to(torch.float32)
