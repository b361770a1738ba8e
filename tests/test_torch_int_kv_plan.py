"""The split of the int-sym decode kernel (kernel 7) over blocks,
``ops/int_kv_attention.py:int_kv_decode_plan``, held to its contract in
every form (int4 words, int8 rows with bf16 or integer dots, int8 K^T with
either) at LLaMA-2 7B's decode shape, Phi-3-medium's and the CPU tests'
tiny one: each (batch, kv head) pair's warps read its main tokens [0, P)
and residual rows [0, R) exactly once, each warp a run of whole steps; the
grid fills an H100's 132 SMs in one wave at the two timed shapes; a
block's shared memory (scores until the cluster knows the pair's max)
fits 227 KB wherever the plan takes a cache, up to P + R in the tens of
thousands at G = 8, and past the limit the plan says so, which the wrapper
turns into a ValueError on the card."""

import pytest
import torch

from quantized_training_torch.ops import int_kv_attention as ikv

torch.set_num_threads(1)

SHAPES = {"7b": dict(B=8, KV=32, G=1, D=128, P=2048, R=128),
          "phi3": dict(B=8, KV=10, G=4, D=128, P=2048, R=128),
          "tiny": dict(B=2, KV=2, G=8, D=64, P=64, R=8)}
# (bits, int_dots, k_transposed) of each form
FORMS = {"int4": (4, False, False), "int8": (8, False, False),
         "int8_kt": (8, False, True), "int8_int_dots": (8, True, False),
         "int8_int_dots_kt": (8, True, True)}


def _plan(s, form, **kw):
    return ikv.int_kv_decode_plan(s["B"], s["KV"], s["P"], s["R"], s["D"],
                                  s["G"], ikv._form(*FORMS[form]), **kw)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_covers_each_token_once(shape, form):
    s = SHAPES[shape]
    plan = _plan(s, form)
    assert plan.rows * plan.per == s["P"]
    assert 1 <= plan.splits <= ikv.MAX_SPLITS
    assert plan.smem <= ikv.MAX_SMEM
    warps = ikv.int_kv_plan_tokens(plan, s["R"])
    assert len(warps) == plan.splits
    assert all(len(w) == ikv.WARPS for w in warps)
    main = [t for split in warps for toks, _ in split for t in toks]
    res = [r for split in warps for _, rows in split for r in rows]
    assert sorted(main) == list(range(s["P"]))
    assert sorted(res) == list(range(s["R"]))
    # each warp's main tokens are whole steps of rows, in order
    for split in warps:
        for toks, rows in split:
            if toks:
                first = min(t % plan.rows for t in toks)
                assert first % plan.unit == 0
                assert len(toks) % plan.per == 0
            if rows:
                assert rows[0] % ikv.STEP == 0
                assert rows == list(range(rows[0], rows[-1] + 1))


@pytest.mark.parametrize("shape", ["7b", "phi3"])
def test_plan_fills_the_sms_in_one_wave(shape):
    s = SHAPES[shape]
    for form in FORMS:
        plan = _plan(s, form)
        # the grid is (splits, KV, B): the same split count for every pair,
        # at least a block an SM, at most the 4 an SM holds in one wave
        blocks = plan.splits * s["KV"] * s["B"]
        assert 132 <= blocks <= 4 * 132
        assert plan == _plan(s, form, sms=132)


@pytest.mark.parametrize("form", list(FORMS))
def test_scores_fit_a_block_up_to_the_refusal_limit(form):
    """At G = 8, D = 128 the plan takes P + R past the old whole-tile
    kernel's 6079 (any form) up to 32896 at 8 blocks a pair, each block
    within 227 KB; P = 65536 outgrows a block even at 8, so the plan's
    shared memory exceeds MAX_SMEM and the wrapper refuses it."""
    fid = ikv._form(*FORMS[form])
    for P in (8192, 32768):
        plan = ikv.int_kv_decode_plan(1, 2, P, 128, 128, 8, fid)
        assert plan.smem <= ikv.MAX_SMEM
        assert plan.smem == ikv.int_kv_decode_smem(fid, 128, 8, P, 128,
                                                   plan.splits)
    assert ikv.int_kv_decode_plan(1, 2, 32768, 128, 128, 8, fid).splits == 8
    big = ikv.int_kv_decode_plan(1, 2, 65536, 128, 128, 8, fid)
    assert big.splits == ikv.MAX_SPLITS and big.smem > ikv.MAX_SMEM
