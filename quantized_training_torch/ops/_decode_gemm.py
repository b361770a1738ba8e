"""The host side of the storage GEMMs' decode forms (M <= 8): kernels 9
and 10's ``csrc/byte_storage_gemm.cuh:gemm_decode`` (``mx_storage.mx_matmul``,
``posit_storage.posit_matmul``) and kernel 5's
``csrc/affine_w4_matmul.cu:w4_gemm_decode``
(``affine_storage.affine_matmul``): the plan of a launch and the workspace
and counters a launch with split K needs.

The plan (how many blocks split K, how much workspace they need, 0 splits
where the decode form does not serve the call) is the kernel library's
own (``bsg::decode_plan``, kernel 5's ``w4_decode_plan``), exported as
``<library>_decode_plan`` and asked once a shape; the launch computes it
again and refuses a workspace smaller than it needs.  With more than one
split each block writes an f32 partial of its outputs to the workspace, and
the last block of a column tile to arrive (counted in the counters, which
it sets back to zero) adds the partials in split order: the same bits from
every call.  The workspace and counters are kept per device and stream:
launches on one stream run in order, so each may reuse them.
"""

import ctypes
from typing import Dict, Tuple

import torch

__all__ = ["decode_plan", "decode_workspace", "decode_args", "sm_count"]

_SMS: Dict[int, int] = {}
_PLANS: Dict[tuple, Tuple[int, int, int, int, int]] = {}
_WORKSPACES: Dict[tuple, tuple] = {}


def sm_count(device: torch.device) -> int:
    """The SM count of ``device``, asked once."""
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def decode_plan(plan_fn, device: torch.device, M: int, K: int, N: int,
                param: int) -> Tuple[int, int, int, int, int]:
    """(splits, workspace floats, counters, rows a stage, SMs) of an
    (M, K) x (K, N) launch on ``device``, from the library's
    ``plan_fn(M, K, N, param, sms, plan)`` (param: the MX block size, the
    posit8 es or kernel 5's group; kernel 5's "rows a stage" are its
    group, the unit its splits take); splits 0 where the decode form does
    not serve the call."""
    key = (plan_fn.__name__, device.index, M, K, N, param)
    plan = _PLANS.get(key)
    if plan is None:
        sms = sm_count(device)
        out = (ctypes.c_int * 4)()
        plan_fn(M, K, N, param, sms, out)
        plan = _PLANS[key] = (*out, sms)
    return plan


def decode_workspace(device: torch.device, stream: int, floats: int,
                     ints: int) -> tuple:
    """(workspace, counters, their pointers and sizes) kept for ``device``
    and ``stream``: uninitialized f32 of at least ``floats`` (every block
    writes its partial before any is read) and int32 zeros of at least
    ``ints`` (each launch leaves them zero); grown when a call needs
    more."""
    key = (device, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[1] < floats or ws[3] < ints:
        part = ws[4] if ws is not None and ws[1] >= floats else torch.empty(
            max(floats, 1 << 16), dtype=torch.float32, device=device)
        count = ws[5] if ws is not None and ws[3] >= ints else torch.zeros(
            max(ints, 256), dtype=torch.int32, device=device)
        ws = _WORKSPACES[key] = (part.data_ptr(), part.numel(),
                                 count.data_ptr(), count.numel(), part,
                                 count)
    return ws


def decode_args(plan_fn, device: torch.device, stream: int, M: int, K: int,
                N: int, param: int) -> tuple:
    """The launch's (workspace, its floats, counters, their ints, SMs)
    arguments: null pointers where the plan needs no workspace."""
    splits, floats, ints, _, sms = decode_plan(plan_fn, device, M, K, N,
                                               param)
    if splits <= 1:
        return None, 0, None, 0, sms
    return decode_workspace(device, stream, floats, ints)[:4] + (sms,)
