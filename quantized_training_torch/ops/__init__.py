"""Kernels written by hand for Hopper (sources under ``csrc/``), each with
its plain PyTorch version.  A wrapper takes the plain version for CPU
tensors, launches its kernel for CUDA tensors and counts the launches in
``<wrapper>.launches`` (the w4/w2 storage GEMM's launches of its
``wgmma`` form, every M > 8, also in
``affine_storage.affine_matmul.prefill_launches``; the two-pass flash
kernel in ``flash_attention.two_pass_launches``; the launches of either
flash form that also saved the logsumexp for the backward in
``flash_attention.lse_launches``; the integer-dot and K^T forms of the
int-KV decode in ``int_kv_decode_attention.tile_launches``; the rounding
kernel's NormalFloat and cast formats also in
``quantize_elemwise.nf_launches`` and ``cast_launches``, its table form in
``table_launches`` and the tables it built in ``table_builds``; the three
storage GEMMs', the packed 8-bit Adam step's and the rounding kernel's
launches also by shape in ``shape_launches``).

The submodules keep their names (``ops.flash_attention`` is the module);
import the wrappers from them.
"""

from . import (adam8bit_step, affine_storage, flash_attention, int8_matmul,
               int_kv_attention, kivi_attention, mx_storage, posit_storage,
               quantize_elemwise, quantized_matmul)

# kernel (as chip_smoke.py's table names it) -> (wrapper, counter attribute)
KERNEL_COUNTERS = {
    "affine_w4_matmul": (affine_storage.affine_matmul, "launches"),
    "affine_w4_matmul_prefill": (affine_storage.affine_matmul,
                                 "prefill_launches"),
    "affine_dequant": (affine_storage.dequant_planes, "launches"),
    "mx_storage_matmul": (mx_storage.mx_matmul, "launches"),
    "posit_storage_matmul": (posit_storage.posit_matmul, "launches"),
    "kivi_decode": (kivi_attention.kivi_decode_attention, "launches"),
    "flash_attn_fwd": (flash_attention.flash_attention, "launches"),
    "flash_attn_fwd_two_pass": (flash_attention.flash_attention,
                                "two_pass_launches"),
    "flash_attn_fwd_lse": (flash_attention.flash_attention, "lse_launches"),
    "flash_bwd_di": (flash_attention.flash_bwd_di, "launches"),
    "flash_bwd_dq": (flash_attention.flash_bwd_dq, "launches"),
    "flash_bwd_dkv": (flash_attention.flash_bwd_dkv, "launches"),
    "adam8bit_packed": (adam8bit_step.fused_adam8bit_update_packed,
                        "launches"),
    "adam8bit_unpacked": (adam8bit_step.fused_adam8bit_update, "launches"),
    "int_kv_decode": (int_kv_attention.int_kv_decode_attention, "launches"),
    "int_kv_decode_tile": (int_kv_attention.int_kv_decode_attention,
                           "tile_launches"),
    "quantize_elemwise": (quantize_elemwise.quantize_elemwise, "launches"),
    "quantize_elemwise_nf": (quantize_elemwise.quantize_elemwise,
                             "nf_launches"),
    "quantize_elemwise_cast": (quantize_elemwise.quantize_elemwise,
                               "cast_launches"),
    "quantize_elemwise_table": (quantize_elemwise.quantize_elemwise,
                                "table_launches"),
    "quantize_elemwise_table_builds": (quantize_elemwise.quantize_elemwise,
                                       "table_builds"),
    "quantized_matmul": (quantized_matmul.quantized_matmul, "launches"),
}


# kernel -> wrapper whose ``shape_launches`` tallies its launches by shape:
# (M, K, N) for the storage GEMMs, nb for the packed 8-bit Adam step,
# (elements, bytes an element) for the rounding kernel
SHAPE_COUNTERS = {"affine_w4_matmul": affine_storage.affine_matmul,
                  "mx_storage_matmul": mx_storage.mx_matmul,
                  "posit_storage_matmul": posit_storage.posit_matmul,
                  "adam8bit_packed":
                      adam8bit_step.fused_adam8bit_update_packed,
                  "quantize_elemwise": quantize_elemwise.quantize_elemwise}


def launch_counts() -> dict:
    """{kernel: launches since the last reset}."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in KERNEL_COUNTERS.items()}


def shape_launch_counts() -> dict:
    """{kernel: {shape: launches since the last reset}}."""
    return {name: dict(fn.shape_launches)
            for name, fn in SHAPE_COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in KERNEL_COUNTERS.values():
        setattr(fn, attr, 0)
    for fn in SHAPE_COUNTERS.values():
        fn.shape_launches.clear()


__all__ = ["KERNEL_COUNTERS", "SHAPE_COUNTERS", "launch_counts",
           "shape_launch_counts", "reset_launch_counts"]
