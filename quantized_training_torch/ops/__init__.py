"""Kernels written by hand for Hopper (sources under ``csrc/``), each with
its plain PyTorch version.  A wrapper takes the plain version for CPU
tensors, launches its kernel for CUDA tensors and counts the launches in
``<wrapper>.launches`` (the two-pass flash kernel in
``flash_attention.two_pass_launches``).

The submodules keep their names (``ops.flash_attention`` is the module);
import the wrappers from them.
"""

from . import (affine_storage, flash_attention, int_kv_attention,
               quantize_elemwise, quantized_matmul)

# kernel (as chip_smoke.py's table names it) -> (wrapper, counter attribute)
KERNEL_COUNTERS = {
    "affine_w4_matmul": (affine_storage.affine_matmul, "launches"),
    "flash_attn_fwd": (flash_attention.flash_attention, "launches"),
    "flash_attn_fwd_two_pass": (flash_attention.flash_attention,
                                "two_pass_launches"),
    "int_kv_decode": (int_kv_attention.int_kv_decode_attention, "launches"),
    "quantize_elemwise": (quantize_elemwise.quantize_elemwise, "launches"),
    "quantized_matmul": (quantized_matmul.quantized_matmul, "launches"),
}


def launch_counts() -> dict:
    """{kernel: launches since the last reset}."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in KERNEL_COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in KERNEL_COUNTERS.values():
        setattr(fn, attr, 0)


__all__ = ["KERNEL_COUNTERS", "launch_counts", "reset_launch_counts"]
