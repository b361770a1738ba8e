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
    """err_qfn (the backward's error taps) is accepted and leaves the
    forward unchanged; on CUDA only a quantize_fn callable with a kernel
    format reaches a kernel."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(128, 128))
    assert torch.equal(flash_attention(q, k, v,
                                       err_qfn=quantize_fn("posit8_1")),
                       flash_attention(q, k, v))
    with pytest.raises(ValueError, match="quantize_fn callable"):
        _kernel_format(lambda p: p, "p_qfn")
    assert _kernel_format(quantize_fn("posit8_1"), "p_qfn").kind == "posit"
    # the forward kernels take every format; the backward kernels only the
    # roundings they are checked with on the card
    for fmt in ("nf4", "bfloat16"):
        assert _kernel_format(quantize_fn(fmt), "p_qfn") is not None
        with pytest.raises(ValueError, match="no checked backward form"):
            _kernel_format(quantize_fn(fmt), "err_qfn", backward=True)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(meta, meta, meta)


# ---- the two-pass form against a tile-wise simulation, bit for bit -------
def _two_pass_oracle(q, k, v, scale, block_q, block_k, p_qfn, causal=True,
                     out_qfn=None):
    """The reference's tile-by-tile account of the two-pass kernel
    (tests/test_flash_backward.py:TestExactProbabilityQuantization), in
    torch: per (batch, head, query tile), the running max and sum over the
    key tiles give lse; then round(p) @ v is added tile by tile in f32."""
    from quantized_training_torch.ops.flash_attention import NEG_INF

    B, H, S, D = q.shape
    _, KV, T, _ = k.shape
    group = H // KV
    nk = T // block_k
    f32 = torch.float32
    out = torch.zeros((B, H, S, D), dtype=q.dtype)
    for b in range(B):
        for h in range(H):
            for i in range(S // block_q):
                qt = q[b, h, i * block_q:(i + 1) * block_q]
                m = torch.full((block_q, 1), NEG_INF, dtype=f32)
                l = torch.zeros((block_q, 1), dtype=f32)
                tiles = []
                for j in range(nk):
                    if causal and j * block_k > (i + 1) * block_q - 1:
                        tiles.append(None)
                        continue
                    kt = k[b, h // group, j * block_k:(j + 1) * block_k]
                    s = torch.matmul(qt.to(f32), kt.to(f32).T) * scale
                    if causal:
                        q_pos = i * block_q + torch.arange(block_q)[:, None]
                        k_pos = j * block_k + torch.arange(block_k)[None, :]
                        s = torch.where(k_pos <= q_pos, s,
                                        torch.full_like(s, NEG_INF))
                    tiles.append(s)
                    m_new = torch.maximum(m, torch.amax(s, dim=1,
                                                        keepdim=True))
                    l = (l * torch.exp(m - m_new)
                         + torch.sum(torch.exp(s - m_new), dim=1,
                                     keepdim=True))
                    m = m_new
                lse = m + torch.log(torch.where(l == 0.0, torch.ones_like(l),
                                                l))
                acc = torch.zeros((block_q, D), dtype=f32)
                for j in range(nk):
                    if tiles[j] is None:
                        continue
                    vt = v[b, h // group, j * block_k:(j + 1) * block_k]
                    p = torch.exp(tiles[j] - lse)
                    pq = p_qfn(p.to(torch.bfloat16)).to(f32)
                    acc = acc + torch.matmul(pq.to(vt.dtype).to(f32),
                                             vt.to(f32))
                o = acc.to(q.dtype)
                if out_qfn is not None:
                    o = out_qfn(o).to(q.dtype)
                out[b, h, i * block_q:(i + 1) * block_q] = o
    return out


# (H, KV, causal, p format, out format, input dtype): the JAX suite's three
# cases (tests/test_flash_backward.py:196-218, f32 inputs, 128 x 128 tiles)
# and the bf16 operands the kernels take, with an NF probability rounding.
@pytest.mark.parametrize("H,KV,causal,p_fmt,out_fmt,dtype", [
    (2, 2, True, "posit8_1", None, torch.float32),
    (2, 2, False, "posit8_1", None, torch.float32),
    (4, 2, True, "posit8_1", "e4m3", torch.float32),
    (4, 2, True, "nf4", "posit8_1", torch.bfloat16),
])
def test_two_pass_plain_bit_equal_to_tilewise_simulation(H, KV, causal, p_fmt,
                                                         out_fmt, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(256, 256, H=H, KV=KV, seed=7))
    p_qfn = quantize_fn(p_fmt)
    out_qfn = quantize_fn(out_fmt) if out_fmt else None
    got = flash_attention(q, k, v, causal=causal, p_qfn=p_qfn,
                          out_qfn=out_qfn)
    want = _two_pass_oracle(q, k, v, 1.0 / np.sqrt(128), 128, 128, p_qfn,
                            causal=causal, out_qfn=out_qfn)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


# ---- the CUDA forward's launch plan (checked here; launched on the card) ----
def _kernel_constants():
    """BQ, BK, NSTAGE and NTHREADS as csrc/flash_attn_fwd.cu declares them."""
    import re
    from pathlib import Path
    import quantized_training_torch
    src = (Path(quantized_training_torch.__file__).parent / "csrc"
           / "flash_attn_fwd.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
            for name in ("BQ", "BK", "NSTAGE", "NTHREADS")}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("form", ["single", "single_lse", "two_pass",
                                  "two_pass_lse"])
def test_forward_launch_plan_fits_one_block(form, D):
    """Every form's tiles fit an H100 block's shared memory, and the plan
    is the kernel source's: a 128 x D Q tile and three stages of a 64-key
    K and V tile in bf16, 1024 bytes of alignment, one block per (head,
    batch) and 128-row q tile."""
    from quantized_training_torch.ops.flash_attention import (
        SMEM_PER_BLOCK, forward_plan)
    c = _kernel_constants()
    plan = forward_plan(form, D, B=3, H=8, S=1000)
    assert plan.smem_bytes <= SMEM_PER_BLOCK == 232_448
    assert (plan.block_q, plan.block_k, plan.stages, plan.threads) == (
        c["BQ"], c["BK"], c["NSTAGE"], c["NTHREADS"])
    assert plan.smem_bytes == (c["BQ"] * D * 2
                               + c["NSTAGE"] * 2 * c["BK"] * D * 2 + 1024)
    assert plan.grid == (24, 8)


def test_forward_launch_plan_refuses_other_head_dims():
    """A head dim the kernel does not take, or a form it does not have,
    raises in the launch plan (on the card the wrapper's operand check
    raises before any launch: tests/test_torch_cuda.py)."""
    from quantized_training_torch.ops.flash_attention import forward_plan
    for D in (16, 32, 96, 256):
        with pytest.raises(ValueError, match="must be 64 or 128"):
            forward_plan("single", D)
    with pytest.raises(ValueError, match="no form"):
        forward_plan("three_pass", 128)
