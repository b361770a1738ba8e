"""Parity of the port's w4a16 weight storage with the JAX package: packed
codes and qparams bit-equal, the plain storage GEMM equal to the JAX
fallback, and close to the JAX kernel body."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_training_tpu.models import LlamaConfig as JaxLlamaConfig
from quantized_training_tpu.models import LlamaForCausalLM as JaxLlama
from quantized_training_tpu.ops.pallas import affine_storage as jax_affine
from quantized_training_tpu.qspec import QuantizationSpec as JaxSpec
from quantized_training_tpu.quantize import build_storage as jax_build
from quantized_training_tpu.quantize.fake_quant import (
    fake_quantize as jax_fake_quantize,
)

from quantized_training_torch.convert import params_from_jax
from quantized_training_torch.ops import affine_storage as port_affine
from quantized_training_torch.qspec import QuantizationSpec
from quantized_training_torch.quantize import build_storage, fake_quantize

GROUP = 64


def _weights(K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)


def _pack_both(w):
    jax_out = jax_affine.pack_affine_weights(jnp.asarray(w), 4, GROUP)
    port_out = port_affine.pack_affine_weights(torch.from_numpy(w), 4, GROUP)
    return [np.asarray(a) for a in jax_out], [t.numpy() for t in port_out]


# K=192 is three groups: the small analogue of the 7B down projection's
# K=11008 = 172 groups, which no power-of-two K tile divides
@pytest.mark.parametrize("K,N", [(256, 96), (192, 64), (512, 40)])
def test_pack_bit_equal(K, N):
    (jc, js, jz), (tc, ts, tz) = _pack_both(_weights(K, N))
    assert tc.dtype == np.int32 and tc.shape == (K // 8, N)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tz, jz)


@pytest.mark.parametrize("K", [256, 192])
def test_dequant_equals_group_affine_fake_quant(K):
    """The packed codes dequantize to the uint4 group-affine fake-quant of
    the weights, bit for bit, in both packages."""
    w = _weights(K, 48, seed=1)
    spec_str = f"uint4,qs=group_wise_affine,bs={GROUP},ax=0"
    fq, _ = fake_quantize(torch.from_numpy(w),
                          QuantizationSpec.from_str(spec_str))
    jfq, _ = jax_fake_quantize(jnp.asarray(w), JaxSpec.from_str(spec_str))
    np.testing.assert_array_equal(fq.numpy(), np.asarray(jfq))
    codes, sf, zp = port_affine.pack_affine_weights(torch.from_numpy(w), 4,
                                                    GROUP)
    deq = port_affine._dequant_planes(codes, sf, zp, 4, GROUP)
    np.testing.assert_array_equal(deq.numpy(), fq.numpy())


@pytest.mark.parametrize("K,N", [(256, 96), (192, 64)])
def test_plain_matmul_equals_jax_fallback_f32(K, N):
    """f32 inputs: the identity picks out the dequantized weight, so the
    whole plain path (dequant + product) is compared bit for bit; a random
    x differs from JAX's dot only by f32 summation order (1e-6)."""
    (jc, js, jz), (tc, ts, tz) = _pack_both(_weights(K, N))
    eye = np.eye(K, dtype=np.float32)
    jy = jax_affine.affine_matmul(jnp.asarray(eye), jnp.asarray(jc),
                                  jnp.asarray(js), jnp.asarray(jz),
                                  nbits=4, group_size=GROUP)
    ty = port_affine.affine_matmul(torch.from_numpy(eye), torch.from_numpy(tc),
                                   torch.from_numpy(ts), torch.from_numpy(tz),
                                   nbits=4, group_size=GROUP)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    x = np.random.default_rng(2).standard_normal((5, K)).astype(np.float32)
    jy = jax_affine.affine_matmul(jnp.asarray(x), jnp.asarray(jc),
                                  jnp.asarray(js), jnp.asarray(jz),
                                  nbits=4, group_size=GROUP)
    ty = port_affine.affine_matmul(torch.from_numpy(x), torch.from_numpy(tc),
                                   torch.from_numpy(ts), torch.from_numpy(tz),
                                   nbits=4, group_size=GROUP)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("K,N,M", [(256, 96, 8), (192, 64, 3)])
def test_plain_matmul_matches_jax_kernel_body_bf16(K, N, M):
    """bf16 inputs against the JAX kernel body run by the Pallas
    interpreter (centered codes times scale, then the zero-point
    correction dot): the two round the weight at different points, so they
    agree to the 2e-2 the JAX suite allows (test_storage_deploy.py:284)."""
    (jc, js, jz), (tc, ts, tz) = _pack_both(_weights(K, N))
    x = np.random.default_rng(3).standard_normal((M, K)).astype(np.float32)
    jy = jax_affine.affine_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(jc), jnp.asarray(js),
        jnp.asarray(jz), nbits=4, group_size=GROUP, force_kernel=True,
        interpret=True, block_m=M, block_n=N, block_k=GROUP // 8)
    ty = port_affine.affine_matmul(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(tc),
        torch.from_numpy(ts), torch.from_numpy(tz), nbits=4,
        group_size=GROUP)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxLlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                              num_hidden_layers=2, fused_qkv=True)
    ids = jnp.zeros((1, 8), jnp.int32)
    return jax.jit(JaxLlama(cfg, None).init)(jax.random.PRNGKey(0),
                                            ids)["params"]


def test_build_storage_bit_equal(jax_params):
    """Every 2-D kernel, lm_head included, packs to the JAX codes and
    qparams; the embedding and norms stay dense params."""
    storage, slim = jax_build(jax_params, "w4a16", GROUP)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, storage))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    got, got_slim = build_storage(params, "w4a16", GROUP, device="cpu")
    assert sorted(got) == sorted(want)
    assert "lm_head.codes" in got
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)
    assert not any(n.endswith("kernel") for n in got_slim)
    assert "model.embed_tokens.embedding" in got_slim
    assert sorted(got_slim) == sorted(params_from_jax(
        jax.tree_util.tree_map(np.asarray, slim)))


def test_build_storage_unported_formats_raise():
    params = {"lm_head.kernel": torch.zeros(64, 8)}
    for fmt in ("posit8", "mx8", "w2a16", "w2x4", "w8a8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_storage(params, fmt, GROUP, device="cpu")
    with pytest.raises(ValueError):
        build_storage(params, "w3a16", GROUP, device="cpu")


def test_build_storage_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the missing-CUDA error")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_storage({"lm_head.kernel": torch.zeros(64, 8)}, "w4a16", GROUP)


def test_kernel_wrapper_rejects_other_devices():
    """The wrapper takes its plain version only for CPU tensors."""
    x = torch.zeros((2, 64), dtype=torch.bfloat16, device="meta")
    codes = torch.zeros((8, 16), dtype=torch.int32, device="meta")
    sf = torch.ones((1, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        port_affine.affine_matmul(x, codes, sf, sf, nbits=4, group_size=64)
