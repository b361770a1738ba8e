"""The port's KIVI group-affine KV cache, its fused decode attention and the
int8 per-token-symmetric cache against the JAX package, at the geometry of
the JAX suite's KIVI kernel test (H=4, KV=2, D=64, P=32, R=8): cache codes,
qparams and packed words bit-equal; the plain decode against the JAX kernel
run by the Pallas interpreter; a 2-layer model's decode logits and greedy
tokens (generate and the engine) against JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_training_tpu.models import LlamaConfig as JaxLlamaConfig
from quantized_training_tpu.models import LlamaForCausalLM as JaxLlama
from quantized_training_tpu.ops.pallas.int_kv_attention import (
    int_kv_decode_attention as jax_int_kv_decode,
)
from quantized_training_tpu.ops.pallas.kivi_attention import (
    kivi_decode_attention as jax_kivi_decode,
)
from quantized_training_tpu.serving import kv_cache as jkv
from quantized_training_tpu.serving.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from quantized_training_tpu.serving.generate import generate as jax_generate

import quantized_training_torch as qt
from quantized_training_torch.convert import cache_from_jax
from quantized_training_torch.ops.int_kv_attention import (
    int_kv_decode_attention,
)
from quantized_training_torch.ops.kivi_attention import (
    kivi_decode_attention, kivi_decode_plain,
)
from quantized_training_torch.serving import kv_cache as tkv

B, P, R, KV, H, D = 2, 32, 8, 2, 4, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the tier-1 run puts several test processes on the
    cores, and these tests are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(bits, ax, bs=32):
    return f"uint{bits},qs=group_wise_affine,bs={bs},ax={ax}"


def _configs(bits, pack):
    args = (P, R, _spec(bits, -2), _spec(bits, -1), pack)
    return jkv.KVCacheConfig.kivi(*args), tkv.KVCacheConfig.kivi(*args)


def _kv(n, S, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, S, KV, D)).astype(np.float32)
            for _ in range(2)]


def _bf(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _assert_same(tensor, array, name=""):
    a = np.asarray(array.astype(jnp.float32)) if array.dtype == jnp.bfloat16 \
        else np.asarray(array)
    t = tensor.float().numpy() if tensor.dtype == torch.bfloat16 \
        else tensor.numpy()
    assert t.shape == a.shape, (name, t.shape, a.shape)
    assert str(t.dtype) == str(a.dtype), (name, t.dtype, a.dtype)
    np.testing.assert_array_equal(t, a, err_msg=name)


def _assert_caches_same(tc, jc):
    for name in tkv.QuantizedKVCache._fields:
        _assert_same(getattr(tc, name), getattr(jc, name), name)


def _both_prefill(jcfg, tcfg, length=20, steps=3, seed=7):
    """One short prompt (``length`` < P) prefilled into both caches, then
    ``steps`` decode tokens appended."""
    k, v = _kv(B, P, seed)
    (jk, tk), (jv, tv) = _bf(k), _bf(v)
    jc = jkv.prefill_cache(jkv.init_cache(jcfg, B, KV, D), jcfg, jk, jv,
                           length=length)
    tc = tkv.prefill_cache(tkv.init_cache(tcfg, B, KV, D, device="cpu"),
                           tcfg, tk, tv, length=length)
    for step in range(steps):
        kn, vn = _kv(B, 1, seed + 1 + step)
        (jkn, tkn), (jvn, tvn) = _bf(kn), _bf(vn)
        jc = jkv.append_to_cache(jc, jkn, jvn)
        tc = tkv.append_to_cache(tc, tkn, tvn)
    return jc, tc


# ---- the cache ----------------------------------------------------------

@pytest.mark.parametrize("bits,pack", [(2, True), (2, False), (4, True),
                                       (4, False)])
def test_kivi_cache_bit_equal(bits, pack):
    """Codes (packed words or bytes), bf16 scales and zero points, the
    residual ring and the lengths; and the dequantized [main; residual]."""
    jcfg, tcfg = _configs(bits, pack)
    jc, tc = _both_prefill(jcfg, tcfg)
    assert tc.k_codes.dtype == (torch.int32 if pack else torch.uint8)
    _assert_caches_same(tc, jc)
    for t, j in zip(tkv.cache_kv(tc, tcfg), jkv.cache_kv(jc, jcfg)):
        _assert_same(t, j)
    _assert_same(tkv.per_slot_mask(tcfg, tc.main_len.expand(B),
                                   tc.res_len.expand(B)),
                 jkv.per_slot_mask(jcfg, jnp.broadcast_to(jc.main_len, (B,)),
                                   jnp.broadcast_to(jc.res_len, (B,))))


@pytest.mark.parametrize("pack", [True, False])
def test_prefill_slot_bit_equal(pack):
    """A request's full-length prefill written into slot 1 of a per-slot
    cache, after a first request in slot 0."""
    jcfg, tcfg = _configs(2, pack)
    lens = dict(main_len=np.zeros(B, np.int32), res_len=np.zeros(B, np.int32))
    jc = jkv.init_cache(jcfg, B, KV, D)._replace(
        **{n: jnp.asarray(a) for n, a in lens.items()})
    tc = tkv.init_cache(tcfg, B, KV, D, device="cpu")._replace(
        **{n: torch.from_numpy(a.copy()) for n, a in lens.items()})
    for slot in (0, 1):
        k, v = _kv(1, P, seed=30 + slot)
        (jk, tk), (jv, tv) = _bf(k), _bf(v)
        jc = jkv.prefill_slot(jc, jcfg, jk, jv, jnp.asarray(slot))
        tc = tkv.prefill_slot(tc, tcfg, tk, tv, slot)
    _assert_caches_same(tc, jc)


def test_int8_sym_cache_bit_equal():
    jcfg = jkv.KVCacheConfig.int_sym(P, R, bits=8)
    tcfg = tkv.KVCacheConfig.int_sym(P, R, bits=8)
    jc, tc = _both_prefill(jcfg, tcfg)
    assert tc.k_codes.dtype == torch.int8
    _assert_caches_same(tc, jc)
    for t, j in zip(tkv.cache_kv(tc, tcfg), jkv.cache_kv(jc, jcfg)):
        _assert_same(t, j)


@pytest.mark.parametrize("bits,signed", [(2, False), (4, False), (4, True),
                                         (1, False)])
def test_pack_codes_bit_equal_and_round_trip(bits, signed):
    rng = np.random.default_rng(bits)
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed \
        else (0, 1 << bits)
    codes = rng.integers(lo, hi, (3, 5, 32)).astype(np.int8)
    jp = jkv.pack_codes(jnp.asarray(codes), bits)
    tp = tkv.pack_codes(torch.from_numpy(codes), bits)
    _assert_same(tp, jp)
    back = tkv.unpack_codes(tp, bits, signed=signed)
    np.testing.assert_array_equal(back.numpy(), codes)
    _assert_same(back, jkv.unpack_codes(jp, bits, signed=signed))


def test_full_precision_cache_still_raises():
    """The unquantized main tier (a config without specs), which the port
    refused until speculative decoding came: now ported, its empty and
    prefilled caches (raw bf16 K/V, (1,) qparam placeholders) are JAX's
    bit for bit."""
    jcfg, tcfg = jkv.KVCacheConfig(P, R), tkv.KVCacheConfig(P, R)
    k, v = _kv(B, 20, 4)
    (jk, tk), (jv, tv) = _bf(k), _bf(v)
    jc = jkv.init_cache(jcfg, B, KV, D)
    tc = tkv.init_cache(tcfg, B, KV, D, device="cpu")
    for name, got, want in zip(tc._fields, tc, jc):
        _assert_same(got, want, name)
    jc = jkv.prefill_cache(jc, jcfg, jk, jv, length=17)
    tc = tkv.prefill_cache(tc, tcfg, tk, tv, length=17)
    for name, got, want in zip(tc._fields, tc, jc):
        _assert_same(got, want, name)


# ---- the decode kernels' plain versions ----------------------------------

def _decode_inputs(seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, np.array([20, 13], np.int32), np.array([3, 1], np.int32)


def _naive(q, k, v, ml, rl):
    """softmax(q k^T / sqrt(D)) v over the dequantized [main; residual],
    f32 (the JAX suite's reference, tests/test_serving.py:126)."""
    k, v = (np.repeat(np.asarray(x, np.float32), H // KV, axis=2)
            for x in (k, v))
    s = np.einsum("bhd,bthd->bht", q, k) / np.sqrt(D)
    t = np.arange(P + R)[None, None, :]
    vis = np.where(t < P, t < ml[:, None, None], (t - P) < rl[:, None, None])
    s = np.where(vis, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bht,bthd->bhd", p, v)


@pytest.mark.parametrize("bits,pack", [(2, True), (2, False), (4, True)])
def test_kivi_decode_plain_matches_jax_kernel(bits, pack):
    """The plain version rounds at the TPU kernel's points: on these inputs
    it equals the JAX kernel body (Pallas interpreter) bit for bit
    (tolerance 0: both sum the same products in f32, and every reading on
    the CPU was exact).  It also matches the naive attention over the
    dequantized cache at the JAX suite's 2e-2."""
    jcfg, tcfg = _configs(bits, pack)
    jc, tc = _both_prefill(jcfg, tcfg)
    q, ml, rl = _decode_inputs()
    jq, tq = _bf(q)
    bk = jcfg._pack_bits(jcfg.k_spec)
    want = jax_kivi_decode(jq, *jc[:8], jnp.asarray(ml), jnp.asarray(rl),
                           bits_k=bk, bits_v=bk, interpret=True)
    got = kivi_decode_attention(tq, *tc[:8], torch.from_numpy(ml),
                                torch.from_numpy(rl), bits_k=bk, bits_v=bk)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, D)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    k, v = tkv.cache_kv(tc, tcfg, torch.float32)
    ref = _naive(np.asarray(jq, np.float32), k.numpy(), v.numpy(), ml, rl)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2,
                               rtol=2e-2)


def test_kivi_decode_plain_sees_the_zero_points():
    """Dropping the K zero-point constant (the fault chip_smoke.py plants)
    moves the output far outside the bound above."""
    jcfg, tcfg = _configs(2, True)
    _, tc = _both_prefill(jcfg, tcfg)
    q, ml, rl = _decode_inputs()
    args = (torch.from_numpy(q).bfloat16(), *tc[:8], torch.from_numpy(ml),
            torch.from_numpy(rl))
    kw = dict(bits_k=2, bits_v=2, scale=D ** -0.5)
    got = kivi_decode_plain(*args, **kw)
    no_zp = list(args)
    no_zp[3] = torch.full_like(tc.k_zp, 2.0)        # mid - kz == 0
    faulted = kivi_decode_plain(*no_zp, **kw)
    assert float((got.float() - faulted.float()).abs().max()) > 0.1


@pytest.mark.parametrize("res_len", [(0, 0), (3, R)])
def test_int8_decode_matches_jax_kernel(res_len):
    """bits=8 with bf16 dots against the JAX kernel body at the JAX suite's
    2e-2 (tests/test_int_kv.py:124)."""
    jcfg = jkv.KVCacheConfig.int_sym(P, R, bits=8)
    tcfg = tkv.KVCacheConfig.int_sym(P, R, bits=8)
    jc, tc = _both_prefill(jcfg, tcfg, length=P, steps=0)
    q, ml, _ = _decode_inputs(seed=6)
    rl = np.array(res_len, np.int32)
    k_res, v_res = _kv(B, R, seed=9)
    k_res, v_res = k_res.transpose(0, 2, 1, 3), v_res.transpose(0, 2, 1, 3)
    (jq, tq), (jkr, tkr), (jvr, tvr) = _bf(q), _bf(k_res), _bf(v_res)
    want = jax_int_kv_decode(jq, jc.k_codes, jc.k_scale, jc.v_codes,
                             jc.v_scale, jkr, jvr, jnp.asarray(ml),
                             jnp.asarray(rl), bits=8, int_dots=False,
                             k_transposed=False, interpret=True)
    got = int_kv_decode_attention(tq, tc.k_codes, tc.k_scale, tc.v_codes,
                                  tc.v_scale, tkr, tvr, torch.from_numpy(ml),
                                  torch.from_numpy(rl), bits=8,
                                  int_dots=False, k_transposed=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


# ---- the model ------------------------------------------------------------

ARCH = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=H, num_key_value_heads=KV,
            max_position_embeddings=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    """Seeded numpy weights in the JAX model's param tree: kernels
    N(0, 1/fan_in), embedding N(0, 0.02^2), norm scales one."""
    shapes = jax.eval_shape(JaxLlama(JaxLlamaConfig(**ARCH), None).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)

    def leaf(path, sd):
        name = path[-1].key
        if name == "scale":
            return np.ones(sd.shape, np.float32)
        std = 0.02 if name == "embedding" else sd.shape[0] ** -0.5
        return (rng.standard_normal(sd.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(params, kcfg_args, fused=True, layers=2):
    arch = dict(ARCH, num_hidden_layers=layers)
    jmodel = JaxLlama(JaxLlamaConfig(
        **arch, kv_cache=jkv.KVCacheConfig.kivi(*kcfg_args),
        use_fused_kivi=fused), None)
    tmodel = qt.LlamaForCausalLM(qt.LlamaConfig(
        **arch, kv_cache=tkv.KVCacheConfig.kivi(*kcfg_args),
        use_fused_kivi=fused), device="cpu")
    tmodel.load_state_dict(qt.params_from_jax(_np(params)))
    return jmodel, tmodel


def _prompt(S, seed=0, n=1):
    return np.random.default_rng(seed).integers(0, 256, (n, S)).astype(
        np.int32)


UINT2_PACKED = (P, R, _spec(2, -2), _spec(2, -1), True)


# The JAX suite's bound between its fused and naive decode paths
# (tests/test_serving.py:177-205).
ATOL, RTOL = 0.15, 0.05


@pytest.mark.parametrize("kcfg_args", [UINT2_PACKED], ids=["uint2_packed"])
def test_model_fused_decode_logits_match_jax(params, kcfg_args):
    """Both packages decode from one quantized state (the JAX prefill's
    cache, converted), so the comparison measures the decode and not the
    quantizer's boundaries; the port's fused decode also stays within the
    same bound of its own naive path (use_fused_kivi=False)."""
    jmodel, tmodel = _pair(params, kcfg_args)
    _, naive = _pair(params, kcfg_args, fused=False)
    ids = _prompt(10, seed=8, n=2)
    _, upd = jax.jit(lambda v, i: jmodel.apply(
        v, i, use_cache=True, cache_index=0, prompt_len=10,
        mutable=["cache"]))({"params": params}, jnp.asarray(ids))
    jcache = upd["cache"]
    caches = [cache_from_jax(_np(jcache["model"][f"layers_{i}"]["self_attn"]
                                 ["kivi"])) for i in range(2)]
    decode = jax.jit(lambda v, t, i: jmodel.apply(
        v, t, use_cache=True, cache_index=i, mutable=["cache"]))
    tok = np.full((2, 1), 7, np.int32)
    for step in range(2):
        jl, upd = decode({"params": params, "cache": jcache},
                         jnp.asarray(tok), jnp.asarray(10 + step))
        jcache = upd["cache"]
        tl, new = tmodel(torch.from_numpy(tok).long(), use_cache=True,
                         caches=[c._replace(k_res=c.k_res.clone(),
                                            v_res=c.v_res.clone())
                                 for c in caches],
                         cache_index=10 + step)
        nl, caches = naive(torch.from_numpy(tok).long(), use_cache=True,
                           caches=caches, cache_index=10 + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {step}")
        np.testing.assert_allclose(tl.numpy(), nl.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"naive, step {step}")
        tok = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)


@pytest.fixture(scope="module")
def uint2_pair(params):
    """One layer of the model above (generate and the engine compile the
    JAX model whole; one layer keeps the file within its time)."""
    one = {k: v for k, v in params.items() if k != "model"}
    one["model"] = {k: v for k, v in params["model"].items()
                    if k != "layers_1"}
    return one, _pair(one, UINT2_PACKED, layers=1)


def test_greedy_generate_tokens_equal_jax(uint2_pair):
    """ROADMAP A8: greedy tokens over the packed uint2 KIVI cache, from a
    short prompt (the engine test below takes a full-length one)."""
    params, (jmodel, tmodel) = uint2_pair
    ids = _prompt(20, seed=1, n=2)
    want = np.asarray(jax_generate(jmodel, {"params": params},
                                   jnp.asarray(ids), max_new_tokens=4))
    got = qt.generate(tmodel, torch.from_numpy(ids).long(), 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_tokens_equal_jax(uint2_pair):
    """Continuous batching over the packed uint2 cache: three requests on
    two slots (a slot refilled mid-run) give the JAX engine's tokens."""
    params, (jmodel, tmodel) = uint2_pair
    prompts = [_prompt(S, seed=2 + i)[0] for i, S in enumerate((P, 17, 5))]
    jengine = JaxEngine(jmodel, {"params": params}, batch_slots=2)
    tengine = qt.ContinuousBatchingEngine(tmodel, batch_slots=2)
    jids = [jengine.submit(p, max_new_tokens=4) for p in prompts]
    tids = [tengine.submit(p, max_new_tokens=4) for p in prompts]
    want, got = jengine.run(), tengine.run()
    for j, t in zip(jids, tids):
        assert got[t] == [int(x) for x in want[j]], t
