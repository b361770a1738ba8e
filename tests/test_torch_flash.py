"""The port's flash attention forward (plain version on the CPU) against the
JAX flash kernel run by the Pallas interpreter."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantized_training_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash,
)
from quantized_training_torch.ops.flash_attention import flash_attention


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


def test_quantization_hooks_raise():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(128, 128))
    with pytest.raises(NotImplementedError, match="slice 2"):
        flash_attention(q, k, v, p_qfn=lambda p: p)
