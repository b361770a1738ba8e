"""CLI flag system: the reference's qspec argument surface for training
scripts (reference: quantized_training_tpu/cli.py).

Mirrors ``add_qspec_args`` (reference: training_args.py:36-256) so command
lines written for the reference framework carry over: --activation /
--weight / --error take QuantizationSpec strings, --quantize_forward /
--quantize_backprop select fusion-ladder categories, plus LoRA, posit
softmax, histogram, and run-management flags.  ``quant_config_from_args``
turns parsed args into the framework's QuantConfig.
"""

import argparse
from typing import Optional

from .quantize.config import QConfig, QuantConfig

__all__ = ["add_qspec_args", "quant_config_from_args"]


def add_qspec_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group("quantization")
    group.add_argument("--activation", type=str, default=None,
                       help='Activation qspec string, e.g. "posit8_1" or '
                            '"int8,qs=per_tensor_symmetric"')
    group.add_argument("--weight", type=str, default=None,
                       help="Weight qspec string")
    group.add_argument("--error", type=str, default=None,
                       help="Gradient (error) qspec string, e.g. "
                            '"posit8_1,qs=per_tensor_symmetric,qmax=64"')
    group.add_argument("--quantize_forward", type=str, default=None,
                       help="Comma list of op categories to quantize forward: "
                            "gemm,activation,layernorm,residual,scaling")
    group.add_argument("--quantize_backprop", type=str, default=None,
                       help="Comma list of op categories to quantize backward")
    group.add_argument("--op_fusion", type=str, default=None,
                       help="Comma list of module-name substrings excluded "
                            "from quantization")
    group.add_argument("--force_scale_power_of_two", action="store_true")
    group.add_argument("--record_histogram", action="store_true")
    group.add_argument("--posit_exp", action="store_true",
                       help="Posit16-approximated softmax exp")
    group.add_argument("--posit_exp_shifted", action="store_true")
    group.add_argument("--posit_reciprocal", action="store_true",
                       help="Posit16-approximated softmax reciprocal")
    group.add_argument("--bf16", action="store_true", default=True)
    group.add_argument("--use_flash_attention", action="store_true")

    train = parser.add_argument_group("training")
    train.add_argument("--learning_rate", type=float, default=5e-5)
    train.add_argument("--num_train_epochs", type=int, default=3)
    train.add_argument("--per_device_train_batch_size", type=int, default=8)
    train.add_argument("--per_device_eval_batch_size", type=int, default=8)
    train.add_argument("--max_seq_length", type=int, default=384)
    train.add_argument("--seed", type=int, default=0)
    train.add_argument("--output_dir", type=str, default="output")
    train.add_argument("--resume_from_checkpoint", type=str, default=None)
    train.add_argument("--lora_rank", type=int, default=0)
    train.add_argument("--lora_alpha", type=float, default=16.0)
    train.add_argument("--lora_target_modules", type=str,
                       default=r"\.(query|key|value|q_proj|k_proj|v_proj)$")

    run = parser.add_argument_group("run management")
    run.add_argument("--log_file", type=str, default=None)
    run.add_argument("--project", type=str, default=None,
                     help="W&B project (logging no-ops if wandb is absent)")
    run.add_argument("--run_name", type=str, default=None)
    run.add_argument("--run_id", type=str, default=None)
    run.add_argument("--sweep_id", type=str, default=None)
    return parser


def quant_config_from_args(args) -> Optional[QuantConfig]:
    """QuantConfig from parsed args; None when nothing is quantized.

    ``--lora_target_modules`` is one regex, as in the reference: a comma
    list such as run_quantized_training.py's ``query,value`` matches no
    module path (a fault of the reference, kept so both packages agree;
    pass ``\\.(query|value)$``)."""
    if not (args.activation or args.weight or args.error):
        return None

    qc = QConfig.from_strs(
        activation=args.activation,
        weight=args.weight,
        error=args.error,
        force_scale_power_of_two=getattr(
            args, "force_scale_power_of_two", False),
    )
    cfg = QuantConfig(global_qconfig=qc)

    # Reference semantics (quantize.py:83-87): no activation spec disables
    # forward category selection entirely; same for error/backward.
    fwd = args.quantize_forward if args.activation else None
    bwd = args.quantize_backprop if args.error else None
    cfg = cfg.with_fusion(
        forward=fwd if fwd is not None else
        ("gemm,activation,layernorm,residual,scaling" if args.activation else ()),
        backward=bwd if bwd is not None else (),
    )
    if getattr(args, "op_fusion", None):
        cfg = cfg.with_op_fusion(args.op_fusion.split(","))
    if getattr(args, "lora_rank", 0):
        cfg = cfg.with_lora(args.lora_rank, args.lora_alpha,
                            (args.lora_target_modules,))
    if getattr(args, "record_histogram", False):
        cfg = cfg.with_histograms()
    if (getattr(args, "posit_exp", False)
            or getattr(args, "posit_exp_shifted", False)
            or getattr(args, "posit_reciprocal", False)):
        cfg = cfg.with_posit_softmax(
            exp=getattr(args, "posit_exp", False),
            exp_shifted=getattr(args, "posit_exp_shifted", False),
            reciprocal=getattr(args, "posit_reciprocal", False),
        )
    return cfg
