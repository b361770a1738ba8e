"""The port's int4 per-token-symmetric KV cache and its decode attention
against the JAX package: cache codes and scales bit-equal, the plain decode
close to the JAX kernel run by the Pallas interpreter."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quantized_training_tpu.ops.pallas.int_kv_attention import (
    int_kv_decode_attention as jax_decode,
)
from quantized_training_tpu.serving import kv_cache as jkv
from quantized_training_torch.ops.int_kv_attention import (
    int_kv_decode_attention,
)
from quantized_training_torch.serving import kv_cache as tkv

B, P, R, KV, D = 3, 32, 8, 2, 64


def _kv(S, seed, n=B):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, S, KV, D)).astype(np.float32)
            for _ in range(2)]


def _both_prefill(length):
    k, v = _kv(P, seed=7)
    jcfg = jkv.KVCacheConfig.int_sym(P, R, bits=4)
    tcfg = tkv.KVCacheConfig.int_sym(P, R, bits=4)
    jc = jkv.prefill_cache(jkv.init_cache(jcfg, B, KV, D), jcfg,
                           jnp.asarray(k, jnp.bfloat16),
                           jnp.asarray(v, jnp.bfloat16), length=length)
    tc = tkv.prefill_cache(tkv.init_cache(tcfg, B, KV, D, device="cpu"), tcfg,
                           torch.from_numpy(k).bfloat16(),
                           torch.from_numpy(v).bfloat16(), length=length)
    return jcfg, jc, tcfg, tc


def _assert_same(tensor, array, name=""):
    a = np.asarray(array.astype(jnp.float32)) if array.dtype == jnp.bfloat16 \
        else np.asarray(array)
    t = tensor.float().numpy() if tensor.dtype == torch.bfloat16 \
        else tensor.numpy()
    assert t.shape == a.shape, (name, t.shape, a.shape)
    np.testing.assert_array_equal(t, a, err_msg=name)


FIELDS = ("k_codes", "k_scale", "v_codes", "v_scale", "k_res", "v_res",
          "main_len", "res_len")


@pytest.mark.parametrize("length", [20, P])
def test_prefill_cache_bit_equal(length):
    _, jc, _, tc = _both_prefill(length)
    assert tc.k_codes.dtype == torch.int32
    for name in FIELDS:
        _assert_same(getattr(tc, name), getattr(jc, name), name)


def test_pack_tokens_planar_bit_equal_and_round_trips():
    codes = np.random.default_rng(1).integers(0, 16, (2, 3, 64, 16))
    jp = jkv.pack_tokens_planar(jnp.asarray(codes, jnp.int32), 4)
    tp = tkv.pack_tokens_planar(torch.from_numpy(codes).int(), 4)
    _assert_same(tp, jp)
    back = tkv.unpack_tokens_planar(tp, 4)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), codes)
    _assert_same(back, jkv.unpack_tokens_planar(jp, 4))


def test_append_per_slot_bit_equal():
    """Per-slot residual appends at each slot's own index; a slot whose
    ring is full is left unwritten."""
    jcfg, jc, tcfg, tc = _both_prefill(20)
    res_len = np.array([0, 3, R], np.int32)
    jc = jc._replace(main_len=jnp.full((B,), 20, jnp.int32),
                     res_len=jnp.asarray(res_len))
    tc = tc._replace(main_len=torch.full((B,), 20, dtype=torch.int32),
                     res_len=torch.from_numpy(res_len))
    for step in range(2):
        kn, vn = _kv(1, seed=10 + step)
        jc = jkv.append_per_slot(jc, jnp.asarray(kn, jnp.bfloat16),
                                 jnp.asarray(vn, jnp.bfloat16))
        tc = tkv.append_per_slot(tc, torch.from_numpy(kn).bfloat16(),
                                 torch.from_numpy(vn).bfloat16())
    for name in FIELDS:
        _assert_same(getattr(tc, name), getattr(jc, name), name)
    jk, jv = jkv.cache_kv(jc, jcfg)
    tk, tv = tkv.cache_kv(tc, tcfg)
    _assert_same(tk, jk, "k")
    _assert_same(tv, jv, "v")
    _assert_same(tkv.per_slot_mask(tcfg, tc.main_len, tc.res_len - 1),
                 jkv.per_slot_mask(jcfg, jc.main_len, jc.res_len - 1))


def test_append_to_cache_bit_equal():
    _, jc, _, tc = _both_prefill(20)
    for step in range(3):
        kn, vn = _kv(1, seed=20 + step)
        jc = jkv.append_to_cache(jc, jnp.asarray(kn, jnp.bfloat16),
                                 jnp.asarray(vn, jnp.bfloat16))
        tc = tkv.append_to_cache(tc, torch.from_numpy(kn).bfloat16(),
                                 torch.from_numpy(vn).bfloat16())
    for name in ("k_res", "v_res", "res_len"):
        _assert_same(getattr(tc, name), getattr(jc, name), name)


# per-slot main_len < P, residual empty or partly filled.  Tolerance 2e-2 as
# the JAX suite's own int-kv kernel test (tests/test_int_kv.py:124).
@pytest.mark.parametrize("res_len", [(0, 0, 0), (1, 5, R)])
def test_decode_matches_jax_kernel(res_len):
    jcfg, jc, tcfg, tc = _both_prefill(P)
    H = 4
    rng = np.random.default_rng(5)
    k_res, v_res = (rng.standard_normal((B, KV, R, D)).astype(np.float32)
                    for _ in range(2))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    ml = np.array([20, 9, P], np.int32)
    rl = np.array(res_len, np.int32)
    want = jax_decode(jnp.asarray(q, jnp.bfloat16), jc.k_codes, jc.k_scale,
                      jc.v_codes, jc.v_scale, jnp.asarray(k_res, jnp.bfloat16),
                      jnp.asarray(v_res, jnp.bfloat16), jnp.asarray(ml),
                      jnp.asarray(rl), bits=4, int_dots=False,
                      k_transposed=False, interpret=True)
    got = int_kv_decode_attention(
        torch.from_numpy(q).bfloat16(), tc.k_codes, tc.k_scale, tc.v_codes,
        tc.v_scale, torch.from_numpy(k_res).bfloat16(),
        torch.from_numpy(v_res).bfloat16(), torch.from_numpy(ml),
        torch.from_numpy(rl), bits=4, int_dots=False, k_transposed=False)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kw", [dict(bits=8), dict(int_dots=True),
                                dict(k_transposed=True)])
def test_unported_variants_raise(kw):
    _, _, _, tc = _both_prefill(P)
    q = torch.zeros((B, KV, D), dtype=torch.bfloat16)
    lens = torch.zeros((B,), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        int_kv_decode_attention(q, tc.k_codes, tc.k_scale, tc.v_codes,
                                tc.v_scale, tc.k_res, tc.v_res, lens, lens,
                                **kw)
