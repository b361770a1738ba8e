"""The port's flash attention backward (plain versions on the CPU) against
jax.grad of the JAX flash attention, whose custom_vjp runs the Pallas
backward kernels in interpret mode: q/k/v grads with no hooks, with the
probabilities rounded (p_qfn), with the error taps (err_qfn), with all of
p_qfn, err_qfn and out_qfn, and with GQA; that the error-tapped grads are
posit8 values; and that a port which drops the dp tap fails the
comparison."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_training_tpu.numerics import quantize_fn as jax_qfn
from quantized_training_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from quantized_training_torch.numerics import quantize_fn
from quantized_training_torch.ops import flash_attention as fa

D = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(S, T, H, KV, seed, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, H, S, d)).astype(np.float32)
    k = rng.standard_normal((1, KV, T, d)).astype(np.float32)
    v = rng.standard_normal((1, KV, T, d)).astype(np.float32)
    w = rng.standard_normal((1, H, S, d)).astype(np.float32)
    return q, k, v, w


def _grads(S, T, H, KV, dtype, hooks, causal=True, seed=0, d=D):
    """(JAX grads, port grads) of sum(o * w) for q, k, v as f32 numpy, at
    head dim d."""
    q, k, v, w = _inputs(S, T, H, KV, seed, d)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    jk = {name: jax_qfn(fmt) for name, fmt in hooks.items()}
    tk = {name: quantize_fn(fmt) for name, fmt in hooks.items()}

    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=128, block_k=128,
                      interpret=True, **jk)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    # jitted: the same bits as the eager grad, in a third of its time
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jd) for a in (q, k, v)))
    tq, tk_, tv = (torch.from_numpy(a).to(td).requires_grad_(True)
                   for a in (q, k, v))
    o = fa.flash_attention(tq, tk_, tv, causal=causal, **tk)
    (o.to(torch.float32) * torch.from_numpy(w)).sum().backward()
    got = [t.grad.to(torch.float32).numpy() for t in (tq, tk_, tv)]
    return [np.asarray(a, np.float32) for a in want], got


def _posit_step_agreement(want, got):
    """(share of elements that differ, relative Frobenius error)."""
    differ = float(np.mean(want != got))
    rel = float(np.linalg.norm(want - got) / np.linalg.norm(want))
    return differ, rel


# Tolerances, by what the two sides round differently:
#  * f32 inputs, no hooks: nothing is rounded; the sums run in other orders
#    (the JAX kernels tile by 128, the plain version takes whole rows), so
#    1e-5 (the JAX suite holds its own kernels to its oracle at 2e-4,
#    tests/test_flash_backward.py:42-44); the readings were below 1e-6.
#  * bf16 inputs, no hooks: di = rowsum(dO * o) uses the forward's output,
#    and the JAX single-pass kernel rounds p to bf16 before the running
#    rescale while the plain forward rounds after the softmax; that moves o
#    by bf16 ulps (the forward's own tolerance, 2e-2, tests/test_torch_flash
#    .py:30-45) and di with it; readings up to 1.6e-2 against |dq| ~ 2.7.
#  * p_qfn alone: both sides take p = exp(s - lse) from the two-pass form;
#    only the f32 sum orders differ (readings up to 2.4e-4): 1e-3.
#  * err_qfn: every grad leaves through a posit8 rounding, so an f32 ulp
#    before it lands on a whole posit8 step at a rounding boundary.  At
#    most 0.1% of elements may differ, and the relative Frobenius error is
#    at most 1e-2 (readings: 0 or 1 element in 65536).
CASES = {
    "causal, no hooks, f32": (256, 256, 2, 2, "f32", {}, True, 1e-5),
    "non-causal, no hooks, f32": (256, 256, 2, 2, "f32", {}, False, 1e-5),
    "causal, no hooks, bf16": (256, 256, 2, 2, "bf16", {}, True, 2e-2),
    "p_qfn posit8_1": (256, 256, 2, 2, "bf16", {"p_qfn": "posit8_1"}, True,
                       1e-3),
    "err_qfn posit8_1": (256, 256, 2, 2, "bf16", {"err_qfn": "posit8_1"},
                         True, None),
    "p_qfn, err_qfn, out_qfn posit8_1": (
        256, 256, 2, 2, "bf16", {"p_qfn": "posit8_1", "err_qfn": "posit8_1",
                                 "out_qfn": "posit8_1"}, True, None),
    "GQA H=4 KV=2, no hooks, S=128 T=256": (128, 256, 4, 2, "bf16", {}, True,
                                            2e-2),
    "GQA H=4 KV=2, err_qfn posit8_1": (128, 128, 4, 2, "bf16",
                                       {"err_qfn": "posit8_1"}, True, None),
    # the kernels' D=64 GQA form (group 4)
    "GQA H=8 KV=2 D=64, err_qfn posit8_1": (128, 128, 8, 2, "bf16",
                                            {"err_qfn": "posit8_1"}, True,
                                            None),
}
HEAD_DIM = {"GQA H=8 KV=2 D=64, err_qfn posit8_1": 64}   # else D


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_jax_flash(case):
    S, T, H, KV, dtype, hooks, causal, tol = CASES[case]
    want, got = _grads(S, T, H, KV, dtype, hooks, causal,
                       d=HEAD_DIM.get(case, D))
    for name, a, b in zip("qkv", want, got):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if tol is not None:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=f"d{name}")
        else:
            differ, rel = _posit_step_agreement(a, b)
            assert differ <= 1e-3 and rel <= 1e-2, (name, differ, rel)


def test_err_grads_are_quantized_values():
    """dq, dk and dv carry only posit8 values: the exit taps ran
    (tests/test_flash_backward.py:304-319)."""
    _, got = _grads(128, 128, 2, 2, "bf16", {"err_qfn": "posit8_1"})
    err = quantize_fn("posit8_1")
    for g in got:
        t = torch.from_numpy(g)
        assert torch.equal(err(t.to(torch.bfloat16)).to(torch.float32), t)


def test_dropped_dp_tap_fails_the_comparison(monkeypatch):
    """A port that rounds only at the exits (dp left untapped, di taken from
    the untapped dp) misses the JAX grads by far more than the error-tap
    cases' bound."""
    untapped = fa._dp
    monkeypatch.setattr(fa, "_dp", lambda do, v, err_qfn, H: untapped(
        do, v, None, H))
    want, got = _grads(256, 256, 2, 2, "bf16", {"err_qfn": "posit8_1"})
    readings = [_posit_step_agreement(a, b) for a, b in zip(want, got)]
    assert any(differ > 1e-3 or rel > 1e-2 for differ, rel in readings), \
        readings


def test_plain_backward_has_the_kernels_entry_points():
    """flash_backward on CPU tensors runs the three plain versions, from
    the training forward's lse and o_unq, and gives autograd's grads."""
    q, k, v, w = _inputs(128, 128, 4, 2, 3)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    p8 = quantize_fn("posit8_1")
    scale = 1 / np.sqrt(D)
    o, lse, o_unq = fa.attention_forward_plain(tq, tk, tv, scale=scale,
                                               p_qfn=p8)
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 128)
    assert o_unq.shape == o.shape and not torch.equal(o_unq, o)
    do = torch.from_numpy(w).to(torch.bfloat16)
    dq, dk, dv = fa.flash_backward(tq, tk, tv, lse, o_unq, do, scale=scale,
                                   p_qfn=p8, err_qfn=p8)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = fa.flash_attention(*leaves, p_qfn=p8, err_qfn=p8)
    assert torch.equal(out, o)
    out.backward(do)
    for a, b in zip((dq, dk, dv), leaves):
        assert torch.equal(a, b.grad)
    assert dk.shape == tk.shape and dv.shape == tv.shape
