"""WikiText perplexity under quantization, the reference's headline LLM
benchmark (reference: examples/wikitext.py of the JAX package and
examples/language_modeling/wikitext.py; protocol: max_length 1024, stride
512 sliding windows, bf16 model, README.md:96-106).

Usage (a local checkpoint and a local token stream, no network):

    python -m quantized_training_torch.examples.wikitext \\
        --model_path /path/to/llama-2-7b \\
        --token_file /path/to/wiki.test.npy \\
        --activation posit8_1 --weight posit8_1 --quantize_forward gemm

``--model_path`` is an HF directory with ``config.json`` and
``*.safetensors`` shards; ``--token_file`` a pre-tokenized ``.npy`` stream
(``--data_file``, raw text, needs ``transformers`` and the checkpoint's
tokenizer).  The model runs on ``--device`` (``cuda`` unless ``cpu`` is
asked for).  The last line is the JSON line of the JAX package's script
(``examples/wikitext.py``).
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..cli import add_qspec_args, quant_config_from_args
from ..models.hf_loader import convert_llama, load_state_dict_dir
from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..utils import resolve_device
from ..utils.evaluation import sliding_window_perplexity


def load_model(path: str, qconfig, use_flash: bool, device="cuda"):
    """(model, cfg) from an HF checkpoint directory, the weights loaded."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    if hf.get("model_type") == "gpt2":
        raise NotImplementedError("GPT-2 is not ported yet")
    cfg = LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads"),
        max_position_embeddings=hf["max_position_embeddings"],
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        use_flash_attention=use_flash,
    )
    params = convert_llama(load_state_dict_dir(path), cfg.num_hidden_layers,
                           cfg.tie_word_embeddings)
    model = LlamaForCausalLM(cfg, qconfig, device=device)
    model.load_state_dict(params)
    return model, cfg


def load_tokens(args) -> np.ndarray:
    if args.token_file:
        return np.load(args.token_file)
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(args.model_path)
    if args.data_file:
        with open(args.data_file) as f:
            text = f.read()
    else:
        from datasets import load_dataset

        ds = load_dataset("wikitext", args.dataset_config, split="test")
        text = "\n\n".join(ds["text"])
    return np.asarray(tok(text, return_tensors="np").input_ids[0])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--data_file", type=str, default=None,
                        help="raw text file (e.g. wiki.test.tokens)")
    parser.add_argument("--token_file", type=str, default=None,
                        help="pre-tokenized .npy file of token ids")
    parser.add_argument("--dataset_config", type=str,
                        default="wikitext-103-raw-v1")
    parser.add_argument("--max_length", type=int, default=1024)
    parser.add_argument("--stride", type=int, default=512)
    parser.add_argument("--max_tokens", type=int, default=None,
                        help="truncate the eval stream (smoke runs)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "PyTorch versions)")
    add_qspec_args(parser)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        # QDense sums in f32 on CUDA, as the reference's dots do
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    qconfig = quant_config_from_args(args)
    model, cfg = load_model(args.model_path, qconfig,
                            args.use_flash_attention, device)
    tokens = load_tokens(args)
    if args.max_tokens:
        tokens = tokens[: args.max_tokens]
    print(f"model: {args.model_path} ({cfg.num_hidden_layers} layers), "
          f"eval tokens: {len(tokens)}", file=sys.stderr)

    ppl = sliding_window_perplexity(
        lambda ids: model(ids)[0], tokens, max_length=args.max_length,
        stride=args.stride, device=device)
    print(json.dumps({
        "perplexity": round(ppl, 4),
        "activation": args.activation,
        "weight": args.weight,
        "quantize_forward": args.quantize_forward,
        "max_length": args.max_length,
        "stride": args.stride,
    }))


if __name__ == "__main__":
    main()
