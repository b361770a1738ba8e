"""The port's flash attention forward (plain version on the CPU) against the
JAX flash kernel run by the Pallas interpreter: the single-pass form, and
the two-pass form with rounded probabilities and output."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantized_training_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from quantized_training_tpu.numerics import quantize_fn as jax_qfn
from quantized_training_torch.numerics import quantize_fn
from quantized_training_torch.ops.flash_attention import (
    _kernel_format, flash_attention,
)


def _qkv(S, T, B=1, H=4, KV=2, D=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    return q, k, v


# (S, T, q_offset): a full prefill, and a query block after a 128-token
# prefix.  Tolerance 2e-2 as the JAX suite holds its own attention kernels
# (tests/test_int_kv.py:124): the kernel rounds p to bf16 before the
# running rescale, the plain version after the full softmax.
@pytest.mark.parametrize("S,T,q_offset", [(256, 256, 0), (128, 256, 128)])
def test_matches_jax_flash(S, T, q_offset):
    q, k, v = _qkv(S, T)
    want = jax_flash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), q_offset=q_offset,
                     interpret=True)
    got = flash_attention(torch.from_numpy(q).bfloat16(),
                          torch.from_numpy(k).bfloat16(),
                          torch.from_numpy(v).bfloat16(), q_offset=q_offset)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 4, S, 128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("out", [None, "e4m3", "posit8_1"])
@pytest.mark.parametrize("seed", [8, 9])
def test_two_pass_matches_jax_flash(out, seed):
    """p rounded to posit8_1 (two-pass form) and the output epilogue, with
    GQA, against the JAX kernel at the JAX suite's own tolerance between its
    kernel and its softmax-then-round oracle
    (tests/test_flash_backward.py:232-243), on its f32 inputs."""
    q, k, v = _qkv(256, 256, H=4, KV=2, seed=seed)
    jk = dict(p_qfn=jax_qfn("posit8_1"))
    tk = dict(p_qfn=quantize_fn("posit8_1"))
    if out:
        jk["out_qfn"], tk["out_qfn"] = jax_qfn(out), quantize_fn(out)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=128, block_k=128, interpret=True, **jk)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **tk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_quantization_hooks_raise():
    """The backward's error taps are not ported; on CUDA only a
    quantize_fn callable with a kernel format reaches a kernel."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(128, 128))
    with pytest.raises(NotImplementedError, match="err_qfn"):
        flash_attention(q, k, v, err_qfn=quantize_fn("posit8_1"))
    for bad in (lambda p: p, quantize_fn("nf4")):
        with pytest.raises(ValueError, match="quantize_fn callable"):
            _kernel_format(bad, "p_qfn")
    assert _kernel_format(quantize_fn("posit8_1"), "p_qfn").kind == "posit"
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(meta, meta, meta)
