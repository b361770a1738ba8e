"""The split of the KIVI decode kernel (kernel 8) over blocks,
``ops/kivi_attention.py:kivi_decode_plan``, held to its contract at
LLaMA-2 7B's decode shape, Phi-3-medium's and the CPU tests' tiny one, for
every cache form: each (batch, kv head) pair's splits cover its main tokens
[0, P) and residual rows [0, R) exactly once, each warp a run of whole
steps; every pair runs the same number of blocks, one cluster of at most 8;
and at the two timed shapes the grid holds at least one block per SM of an
H100 (132)."""

import pytest
import torch

from quantized_training_torch.ops import kivi_attention as ka

torch.set_num_threads(1)

SHAPES = {"7b": dict(B=8, KV=32, P=2048, R=128),
          "phi3": dict(B=8, KV=10, P=2048, R=128),
          "tiny": dict(B=2, KV=2, P=32, R=8)}
FORMS = {"uint2": 2, "uint4": 4, "uint8": None}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_covers_each_token_once(shape, form):
    s, bits = SHAPES[shape], FORMS[form]
    P = s["P"] if bits != 4 or shape != "tiny" else 64
    plan = ka.kivi_decode_plan(s["B"], s["KV"], P, s["R"], bits)
    per = 32 // bits if bits else 1
    assert plan.rows * per == P
    assert 1 <= plan.splits <= ka.MAX_SPLITS
    warps = ka.kivi_plan_tokens(plan, s["R"], bits)
    assert len(warps) == plan.splits
    assert all(len(w) == ka.WARPS for w in warps)
    main = [t for split in warps for toks, _ in split for t in toks]
    res = [r for split in warps for _, rows in split for r in rows]
    assert sorted(main) == list(range(P))
    assert sorted(res) == list(range(s["R"]))
    # each warp's main tokens are whole steps of rows, in order
    for split in warps:
        for toks, rows in split:
            if toks:
                first = min(t % plan.rows for t in toks)
                assert first % plan.unit == 0
                assert len(toks) % per == 0
            if rows:
                assert rows[0] % ka.STEP == 0
                assert rows == list(range(rows[0], rows[-1] + 1))


@pytest.mark.parametrize("shape", ["7b", "phi3"])
def test_plan_fills_the_sms_at_the_timed_shapes(shape):
    s = SHAPES[shape]
    for bits in FORMS.values():
        plan = ka.kivi_decode_plan(s["B"], s["KV"], s["P"], s["R"], bits)
        # the grid is (splits, KV, B): the same split count for every pair
        assert plan.splits * s["KV"] * s["B"] >= 132
        assert plan == ka.kivi_decode_plan(s["B"], s["KV"], s["P"], s["R"],
                                           bits, 132)
