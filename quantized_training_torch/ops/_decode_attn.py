"""The host side of ``csrc/decode_attn.cuh``, shared by the two decode
attention kernels on its cluster split, kernel 8 (``kivi_attention``) and
kernel 7 (``int_kv_attention``): the block geometry and the rule that
picks how many blocks, one cluster, take each (batch, kv head) pair.

The 4 * splits warps of a pair's cluster share each tier's steps evenly and
in order (warp w of W: steps [w * n // W, (w + 1) * n // W)); a main step is
``unit`` rows of the main tier (word rows of packed codes, whose plane p
holds token p * rows + r, or one row a token), a residual step 16 ring
rows.
"""

from typing import List, Tuple

import torch

__all__ = ["WARPS", "STEP", "MAX_SPLITS", "MAX_SMEM", "aligned",
           "cluster_splits", "plan_tokens"]

WARPS = 4               # warps a block (csrc/decode_attn.cuh)
STEP = 16               # tokens a residual step
MAX_SPLITS = 8          # blocks a (batch, kv head) pair: one cluster
MAX_SMEM = 227 * 1024   # shared memory a block on an H100


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 16-byte aligned (the
    kernels' 16-byte reads and bulk copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def cluster_splits(pairs: int, steps: int, sms: int, blocks_per_sm) -> int:
    """The most blocks a pair, a power of two up to MAX_SPLITS (a portable
    cluster), that keep the grid of ``pairs`` clusters in one wave and give
    every warp at least one of the pair's ``steps`` steps (both tiers).
    ``blocks_per_sm``: the blocks an SM holds, one count, or a tuple of the
    counts at 1, 2, 4 and 8 blocks a pair (a kernel whose shared memory a
    block shrinks as the pair's blocks grow)."""
    def per_sm(splits):
        if isinstance(blocks_per_sm, int):
            return blocks_per_sm
        return blocks_per_sm[splits.bit_length() - 1]

    splits = 1
    while (splits < MAX_SPLITS
           and 2 * splits * max(1, pairs) <= per_sm(2 * splits) * sms
           and 2 * splits * WARPS <= steps):
        splits *= 2
    return splits


def plan_tokens(splits: int, rows: int, unit: int, per: int,
                main_steps: int, res_steps: int,
                R: int) -> List[List[Tuple[list, list]]]:
    """[[(main tokens, residual rows) of each warp] of each split], as a
    kernel reads them before it cuts them at main_len and res_len: every
    plane of a warp's rows."""
    W = WARPS * splits

    def steps(w, n):
        return w * n // W, (w + 1) * n // W

    out = []
    for s in range(splits):
        warps = []
        for w in range(s * WARPS, (s + 1) * WARPS):
            m0, m1 = steps(w, main_steps)
            q0, q1 = steps(w, res_steps)
            rs = range(m0 * unit, min(m1 * unit, rows))
            warps.append(([p * rows + r for r in rs for p in range(per)],
                          list(range(q0 * STEP, min(q1 * STEP, R)))))
        out.append(warps)
    return out
