"""The rounding kernel's (kernel 11's) plain-Python plan, on the CPU: its
table cache keys tell every format apart, its form rule sends only large
bf16 tensors to the table, and a table of the plain rounding over all
2^16 bf16 patterns gives the plain rounding of any bf16 tensor (what the
card's table form relies on)."""

import numpy as np
import pytest
import torch

from quantized_training_torch.numerics import quantize_fn
from quantized_training_torch.ops import quantize_elemwise as qe

FORMATS = ["posit8_1", "posit16_1", "e4m3", "e5m2", "fp6_e3m2", "int8",
           "int6", "nf3", "nf4", "nf4_6", "bfloat16", "float16"]


def test_table_keys_tell_formats_apart():
    keys = [qe.table_key(quantize_fn(f).fmt) for f in FORMATS]
    assert len(set(keys)) == len(FORMATS)
    assert keys == [qe.table_key(quantize_fn(f).fmt) for f in FORMATS]


def test_elemwise_form_sends_large_bf16_to_the_table():
    kinds = {quantize_fn(f).fmt.kind for f in FORMATS}
    assert kinds <= set(qe.TABLE_MIN_ELEMENTS)
    for kind, least in qe.TABLE_MIN_ELEMENTS.items():
        assert qe.elemwise_form(least, torch.bfloat16, kind) == "table"
        assert qe.elemwise_form(least - 1, torch.bfloat16, kind) == "arith"
        assert qe.elemwise_form(1 << 30, torch.float32, kind) == "arith"


@pytest.mark.parametrize("fmt", FORMATS)
def test_a_table_of_the_plain_rounding_rounds_like_it(fmt):
    qfn = quantize_fn(fmt)
    universe = torch.arange(2 ** 16, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    table = qfn.plain(universe).view(torch.int16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096) * np.exp2(
        rng.standard_normal(4096) * 6)).astype(np.float32)).bfloat16()
    x[:3] = torch.tensor([float("nan"), float("inf"), -0.0])
    looked = table[x.view(torch.int16).long() & 0xFFFF]
    want = qfn.plain(x)
    nan = torch.isnan(want.float())
    assert torch.equal(looked[~nan], want.view(torch.int16)[~nan])
    assert torch.isnan(looked.view(torch.bfloat16)[nan].float()).all()
