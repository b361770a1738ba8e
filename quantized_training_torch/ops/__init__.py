"""Kernels written by hand for Hopper (sources under ``csrc/``), each with
its plain PyTorch version.  A wrapper takes the plain version for CPU
tensors, launches its kernel for CUDA tensors and counts the launches in
``<wrapper>.launches``.

The submodules keep their names (``ops.flash_attention`` is the module);
import the wrappers from them.
"""

from . import affine_storage, flash_attention, int_kv_attention

KERNEL_WRAPPERS = (affine_storage.affine_matmul,
                   flash_attention.flash_attention,
                   int_kv_attention.int_kv_decode_attention)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = ["KERNEL_WRAPPERS", "reset_launch_counts"]
