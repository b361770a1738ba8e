"""Models with quantization sites: LLaMA, BERT, and their building blocks."""

from .bert import (BertConfig, BertForMaskedLM, BertForQuestionAnswering,
                   BertForSequenceClassification, BertModel)
from .hf_loader import (convert_bert, convert_llama, convert_phi3,
                        load_state_dict_dir, maybe_fuse_qkv)
from .layers import (Embed, FakeQuant, NoNorm, QDense, QLayerNorm,
                     QLoRADense, QRMSNorm, QSoftmax, QuantMixin,
                     bwd_quantize)
from .llama import LlamaConfig, LlamaForCausalLM, fuse_qkv_params

__all__ = [
    "BertConfig", "BertForMaskedLM", "BertForQuestionAnswering",
    "BertForSequenceClassification", "BertModel", "Embed", "FakeQuant",
    "LlamaConfig", "LlamaForCausalLM", "NoNorm", "QDense", "QLayerNorm",
    "QLoRADense", "QRMSNorm", "QSoftmax", "QuantMixin", "bwd_quantize",
    "convert_bert", "convert_llama", "convert_phi3", "fuse_qkv_params",
    "load_state_dict_dir", "maybe_fuse_qkv",
]
