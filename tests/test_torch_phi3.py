"""Phi-3 serving in the port against the JAX package: ``convert_phi3`` on a
seeded HF-layout state dict, a tiny Phi-3-shaped model (GQA group 4: H=8
over KV=2, D=32) with w4a16 storage built through convert_phi3,
maybe_fuse_qkv and build_storage, decoding over the int4 and the packed
uint2 KIVI caches, and the plain versions of both decode kernels at the
GQA groups 4 and 8 against the JAX kernels run by the Pallas interpreter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_training_tpu.models import LlamaConfig as JaxLlamaConfig
from quantized_training_tpu.models import LlamaForCausalLM as JaxLlama
from quantized_training_tpu.models import hf_loader as jhf
from quantized_training_tpu.ops.pallas.int_kv_attention import (
    int_kv_decode_attention as jax_int_kv_decode,
)
from quantized_training_tpu.ops.pallas.kivi_attention import (
    kivi_decode_attention as jax_kivi_decode,
)
from quantized_training_tpu.quantize import QuantConfig as JaxQuantConfig
from quantized_training_tpu.serving import kv_cache as jkv

import quantized_training_torch as qt
from quantized_training_torch.convert import cache_from_jax
from quantized_training_torch.models import hf_loader as thf
from quantized_training_torch.ops.int_kv_attention import int_kv_decode_plain
from quantized_training_torch.ops.kivi_attention import kivi_decode_plain
from quantized_training_torch.serving import kv_cache as tkv

# Phi-3-medium-4k's shape cut to size: the same GQA group (4) and w4 group
# (64), D a multiple of the KIVI V block (32).
ARCH = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
            max_position_embeddings=64, fused_qkv=True,
            use_flash_attention=True, use_fused_kivi=True)
H, KV, D, L = 8, 2, 32, 2
P, R = 32, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the tier-1 run puts several test processes on the
    cores, and these tests are many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _hf_state(seed=0):
    """A seeded Phi3ForCausalLM state dict in numpy: torch Linear (out, in)
    weights ~ N(0, 1/fan_in), the fused qkv_proj (q, k, v rows) and
    gate_up_proj (gate, up rows), embedding N(0, 0.02^2), norm weights
    near one."""
    rng = np.random.default_rng(seed)
    hid, inter, vocab = (ARCH["hidden_size"], ARCH["intermediate_size"],
                         ARCH["vocab_size"])

    def lin(out, cin):
        return (rng.standard_normal((out, cin)) / np.sqrt(cin)).astype(
            np.float32)

    def norm():
        return (1 + 0.1 * rng.standard_normal(hid)).astype(np.float32)

    state = {"model.embed_tokens.weight": (
        0.02 * rng.standard_normal((vocab, hid))).astype(np.float32)}
    for i in range(L):
        pre = f"model.layers.{i}"
        state[f"{pre}.self_attn.qkv_proj.weight"] = lin((H + 2 * KV) * D, hid)
        state[f"{pre}.self_attn.o_proj.weight"] = lin(hid, H * D)
        state[f"{pre}.mlp.gate_up_proj.weight"] = lin(2 * inter, hid)
        state[f"{pre}.mlp.down_proj.weight"] = lin(hid, inter)
        state[f"{pre}.input_layernorm.weight"] = norm()
        state[f"{pre}.post_attention_layernorm.weight"] = norm()
    state["model.norm.weight"] = norm()
    state["lm_head.weight"] = lin(vocab, hid)
    return state


@pytest.mark.parametrize("fused", [False, True])
def test_convert_phi3_bit_equal_to_jax(fused):
    """convert_phi3 (then maybe_fuse_qkv, the group-interleaved layout) in
    both packages: the same names and bits; q/k/v and gate/up are the rows
    of the fused HF weights, transposed."""
    state = _hf_state()
    cfg = dict(ARCH, fused_qkv=fused)
    want = qt.params_from_jax(_np(jhf.maybe_fuse_qkv(
        jhf.convert_phi3(state, L, H, KV, D), JaxLlamaConfig(**cfg))))
    got = thf.maybe_fuse_qkv(qt.convert_phi3(state, L, H, KV, D),
                             qt.LlamaConfig(**cfg))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    if not fused:
        qkv = state["model.layers.1.self_attn.qkv_proj.weight"]
        assert torch.equal(got["model.layers.1.self_attn.v_proj.kernel"],
                           torch.from_numpy(qkv[(H + KV) * D:].T.copy()))
        gate_up = state["model.layers.0.mlp.gate_up_proj.weight"]
        assert torch.equal(got["model.layers.0.mlp.up_proj.kernel"],
                           torch.from_numpy(gate_up[512:].T.copy()))


def _kivi_args():
    spec = "uint2,qs=group_wise_affine,bs=32,ax={}"
    return (P, R, spec.format(-2), spec.format(-1), True)


CACHES = {"int4": (lambda: jkv.KVCacheConfig.int_sym(P, R, 4),
                   lambda: tkv.KVCacheConfig.int_sym(P, R, 4)),
          "kivi2": (lambda: jkv.KVCacheConfig.kivi(*_kivi_args()),
                    lambda: tkv.KVCacheConfig.kivi(*_kivi_args()))}


def _tree(flat):
    """{state-dict name: tensor} -> the JAX param tree of numpy arrays
    (``layers.i`` -> ``layers_i``); the inverse of params_from_jax."""
    tree = {}
    for name, t in flat.items():
        keys = name.replace("layers.", "layers_").split(".")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.numpy()
    return tree


@pytest.fixture(scope="module")
def weights():
    """One HF state dict through the port's convert_phi3, maybe_fuse_qkv
    and build_storage("w4a16", 64), for both models (build_storage is held
    bit-equal to JAX's in tests/test_torch_storage.py; the fused params
    here are JAX's, bit for bit)."""
    state = _hf_state(seed=1)
    params = thf.maybe_fuse_qkv(qt.convert_phi3(state, L, H, KV, D),
                                qt.LlamaConfig(**ARCH))
    want = qt.params_from_jax(_np(jhf.maybe_fuse_qkv(
        jhf.convert_phi3(state, L, H, KV, D), JaxLlamaConfig(**ARCH))))
    assert all(torch.equal(params[k], want[k]) for k in want)
    storage, slim = qt.build_storage(params, "w4a16", 64, device="cpu")
    assert "model.layers.0.self_attn.qkv_proj.codes" in storage
    return ({"params": _tree(slim), "storage": _tree(storage)},
            {**slim, **storage})


def _pair(weights, cache):
    jvars, tstate = weights
    jcfg, tcfg = CACHES[cache]
    qc = "w4a16", 64
    jmodel = JaxLlama(JaxLlamaConfig(**ARCH, kv_cache=jcfg()),
                      JaxQuantConfig().with_storage(*qc))
    tmodel = qt.LlamaForCausalLM(qt.LlamaConfig(**ARCH, kv_cache=tcfg()),
                                 qt.QuantConfig().with_storage(*qc),
                                 device="cpu")
    tmodel.load_state_dict(tstate)
    return jmodel, jvars, tmodel


# The JAX suite's bound between its fused and naive decode paths
# (tests/test_int_kv.py:174, tests/test_serving.py:177-205), as in
# tests/test_torch_llama.py: the packages round bf16 at the same points
# but sum in another order.
ATOL, RTOL = 0.15, 0.05
PROMPTS = [np.random.default_rng(2 + i).integers(0, 256, S).astype(np.int32)
           for i, S in enumerate((P, 17, 5))]
NEW = 4


@pytest.fixture(scope="module", params=["int4", "kivi2"])
def reference(request, weights):
    """The JAX model's greedy decode of each prompt alone, as its engine
    runs a request: a prefill padded to P with the true length, then NEW
    - 1 decode steps (one compile each).  Holds the logits, tokens and the
    prefill caches (converted) of every prompt."""
    cache = request.param
    jmodel, jvars, tmodel = _pair(weights, cache)
    prefill = jax.jit(lambda v, ids, n: jmodel.apply(
        v, ids, use_cache=True, cache_index=0, prompt_len=n,
        mutable=["cache"]))
    decode = jax.jit(lambda v, t, i: jmodel.apply(
        v, t, use_cache=True, cache_index=i, mutable=["cache"]))
    runs = []
    for ids in PROMPTS:
        S = len(ids)
        padded = np.zeros((1, P), np.int32)
        padded[0, :S] = ids
        jl, upd = prefill(jvars, jnp.asarray(padded), jnp.asarray(S))
        logits = [np.asarray(jl)[0, S - 1]]
        caches = [cache_from_jax(_np(upd["cache"]["model"][f"layers_{i}"]
                                     ["self_attn"]["kivi"]))
                  for i in range(L)]
        jcache, tokens = upd["cache"], []
        for step in range(NEW):
            tokens.append(int(np.argmax(logits[-1])))
            if step == NEW - 1:
                break
            jl, upd = decode({**jvars, "cache": jcache},
                             jnp.asarray([[tokens[-1]]], jnp.int32),
                             jnp.asarray(S + step))
            jcache = upd["cache"]
            logits.append(np.asarray(jl)[0, -1])
        runs.append(dict(logits=logits, tokens=tokens, caches=caches))
    return cache, tmodel, runs


def test_prefill_and_decode_logits_match_jax(reference):
    """Each prompt's prefill logits, then its decode steps from the JAX
    prefill's cache (converted), so that the comparison measures the GQA
    decode and not the quantizer's boundaries; the port decodes its own
    state from there, fed JAX's greedy tokens."""
    cache, tmodel, runs = reference
    for ids, run in zip(PROMPTS, runs):
        S = len(ids)
        tl, _ = tmodel(torch.from_numpy(ids[None]).long(), use_cache=True,
                       prompt_len=S)
        np.testing.assert_allclose(tl[0, -1].numpy(), run["logits"][0],
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"{cache} prefill S={S}")
        caches = run["caches"]
        for step, tok in enumerate(run["tokens"][:-1]):
            tl, caches = tmodel(torch.tensor([[tok]]), use_cache=True,
                                caches=caches, cache_index=S + step)
            np.testing.assert_allclose(
                tl[0, -1].numpy(), run["logits"][step + 1], atol=ATOL,
                rtol=RTOL, err_msg=f"{cache} S={S} decode step {step}")


def _tie_step(logits):
    """The first step whose two largest logits lie within one bf16 step of
    each other (None if none does): there a last-bit difference in any sum
    may pick either token, and XLA's own paths differ (this file's int4
    prompt 3 takes token 105 at step 2 under jit, 228 op by op: 2.765625
    against 2.78125)."""
    for step, row in enumerate(logits):
        lo, hi = np.sort(row)[-2:]
        if hi - lo <= 2.0 ** (np.floor(np.log2(abs(hi))) - 7):
            return step
    return None


def test_engine_tokens_equal_jax(reference):
    """Continuous batching over the GQA cache: three requests on two slots
    (a slot refilled mid-run, one full-length prompt) give the JAX model's
    greedy tokens of each request alone, up to the first step where the
    JAX logits tie within one bf16 step; at that step the port's token is
    one of the two tied."""
    cache, tmodel, runs = reference
    engine = qt.ContinuousBatchingEngine(tmodel, batch_slots=2)
    rids = [engine.submit(ids, max_new_tokens=NEW) for ids in PROMPTS]
    got = engine.run()
    for rid, run in zip(rids, runs):
        tie = _tie_step(run["logits"])
        n = NEW if tie is None else tie
        assert len(got[rid]) == NEW
        assert got[rid][:n] == run["tokens"][:n], (cache, rid)
        if tie is not None:
            assert got[rid][tie] in np.argsort(run["logits"][tie])[-2:], (
                cache, rid)


# ---- the decode kernels' plain versions at GQA groups 4 and 8 -------------

DB, DP, DR = 2, 64, 8


def _decode_common(G, Dh, seed):
    """q, residual ring and lengths for one (G, D): slot 0 part-filled in
    both tiers, slot 1 a full main tier and one residual token."""
    rng = np.random.default_rng(seed)
    bf = lambda a: (jnp.asarray(a, jnp.bfloat16),
                    torch.from_numpy(a).bfloat16())
    q = bf(rng.standard_normal((DB, KV * G, Dh)).astype(np.float32))
    k_res, v_res = (bf(rng.standard_normal((DB, KV, DR, Dh)).astype(
        np.float32)) for _ in range(2))
    lens = [(jnp.asarray(a), torch.from_numpy(a))
            for a in (np.array([37, DP], np.int32),
                      np.array([5, 1], np.int32))]
    return rng, q, k_res, v_res, lens


def _assert_bits(got, want):
    """Bit for bit, but where a last-bit difference of exp or of an f32 row
    sum (torch and XLA compute both differently on the CPU: about one exp
    in ten differs in its last bit) moves an output across a bf16 rounding
    boundary: there one bf16 step, in at most 1 of 512 outputs (the
    reading at G=4, D=64 with integer dots was 1 of 1024)."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    off = g != w
    assert off.sum() <= g.size // 512, (int(off.sum()), g.size)
    step = 2.0 ** (np.floor(np.log2(np.abs(w[off]))) - 7)
    assert (np.abs(g[off] - w[off]) <= step).all()


# (G, D, form): every form at Phi-3's group and head dim; at the widest
# group the kernels take and the narrower head dim, the served int4 form
# and the reference's defaults (each JAX interpreter call costs 0.5-1.5 s
# on one core, which bounds the count).
INT_KV_CASES = [(4, 128, 4, False, False), (4, 128, 8, False, False),
                (4, 128, 8, False, True), (4, 128, 8, True, False),
                (4, 128, 8, True, True), (8, 64, 4, False, False),
                (8, 64, 8, True, True)]
KIVI_CASES = [(4, 128, 2), (4, 128, 4), (4, 128, None), (8, 64, 2),
              (8, 64, None)]


@pytest.mark.parametrize("G,Dh,bits,int_dots,k_transposed", INT_KV_CASES)
def test_int_kv_plain_bit_equal_to_jax_kernel(G, Dh, bits, int_dots,
                                              k_transposed):
    """Every form of kernel 7 (int4 and int8 bf16 dots over untransposed K;
    int8 with K^T, integer dots, or both): the plain version equals the JAX
    kernel body bit for bit (both take one q scale over the (G, D) tile and
    one p scale over the (G, P) tile), as _assert_bits states."""
    rng, (jq, tq), (jkr, tkr), (jvr, tvr), lens = _decode_common(
        G, Dh, seed=10 * G + Dh)
    if bits == 4:
        k, v = (rng.integers(-2 ** 31, 2 ** 31, (DB, KV, DP // 8, Dh),
                             dtype=np.int64).astype(np.int32)
                for _ in range(2))
    else:
        k, v = (rng.integers(-127, 128, (DB, KV, DP, Dh)).astype(np.int8)
                for _ in range(2))
    if k_transposed:
        k = np.ascontiguousarray(k.transpose(0, 1, 3, 2))
    ks, vs = ((rng.random((DB, KV, 1, DP)) * 0.05 + 1e-3).astype(np.float32)
              for _ in range(2))
    form = dict(bits=bits, int_dots=int_dots, k_transposed=k_transposed)
    want = jax_int_kv_decode(jq, jnp.asarray(k), jnp.asarray(ks),
                             jnp.asarray(v), jnp.asarray(vs), jkr, jvr,
                             *(j for j, _ in lens), interpret=True, **form)
    got = int_kv_decode_plain(tq, *(torch.from_numpy(a) for a in
                                    (k, ks, v, vs)), tkr, tvr,
                              *(t for _, t in lens), scale=Dh ** -0.5,
                              **form)
    assert got.shape == (DB, KV * G, Dh) and got.dtype == torch.bfloat16
    _assert_bits(got, want)


@pytest.mark.parametrize("G,Dh,bits", KIVI_CASES)
def test_kivi_plain_bit_equal_to_jax_kernel(G, Dh, bits):
    """Kernel 8 over packed uint2 and uint4 words and uint8 codes: the plain
    version equals the JAX kernel body bit for bit (each query head's K
    zero-point constants against its kv head's one kz/ks), as _assert_bits
    states."""
    rng, (jq, tq), (jkr, tkr), (jvr, tvr), lens = _decode_common(
        G, Dh, seed=10 * G + Dh + (bits or 0))
    nb = bits or 2
    if bits:
        k, v = (rng.integers(-2 ** 31, 2 ** 31, (DB, KV, DP * bits // 32, Dh),
                             dtype=np.int64).astype(np.int32)
                for _ in range(2))
    else:
        k, v = (rng.integers(0, 4, (DB, KV, DP, Dh)).astype(np.uint8)
                for _ in range(2))
    gP, gD = DP // 32, Dh // 32

    def qp(shape):
        s = (rng.random(shape) * 0.3 + 0.01).astype(np.float32)
        z = rng.integers(0, 2 ** nb, shape).astype(np.float32)
        return [(jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16())
                for a in (s, z)]

    (jks, tks), (jkz, tkz) = qp((DB, KV, gP, Dh))
    (jvs, tvs), (jvz, tvz) = qp((DB, KV, DP, gD))
    want = jax_kivi_decode(jq, jnp.asarray(k), jks, jkz, jnp.asarray(v), jvs,
                           jvz, jkr, jvr, *(j for j, _ in lens), bits_k=bits,
                           bits_v=bits, interpret=True)
    got = kivi_decode_plain(tq, torch.from_numpy(k), tks, tkz,
                            torch.from_numpy(v), tvs, tvz, tkr, tvr,
                            *(t for _, t in lens), bits_k=bits, bits_v=bits,
                            scale=Dh ** -0.5)
    assert got.shape == (DB, KV * G, Dh) and got.dtype == torch.bfloat16
    _assert_bits(got, want)
