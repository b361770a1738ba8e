"""The port's serving slice end to end against the JAX package, on a 2-layer
LLaMA at hidden 256 (H=2, KV=1, D=128), w4a16 storage (group 64), an int4
per-token-symmetric cache (P=128, R=8) and fused qkv.  P=128 makes the flash
gate fire on a full-bucket prefill; shorter prompts take the masked naive
path."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_training_tpu.models import LlamaConfig as JaxLlamaConfig
from quantized_training_tpu.models import LlamaForCausalLM as JaxLlama
from quantized_training_tpu.models.llama import (
    fuse_qkv_params as jax_fuse_qkv_params,
)
from quantized_training_tpu.quantize import QuantConfig as JaxQuantConfig
from quantized_training_tpu.quantize import build_storage as jax_build
from quantized_training_tpu.serving.generate import generate as jax_generate
from quantized_training_tpu.serving.kv_cache import (
    KVCacheConfig as JaxKVCacheConfig,
)

import quantized_training_torch as qt
from quantized_training_torch.models.llama import fuse_qkv_params
from quantized_training_torch.serving.generate import fast_argmax, sample_batch

P, R = 128, 8
ARCH = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
            max_position_embeddings=256, fused_qkv=True,
            use_flash_attention=True, use_fused_kivi=True)


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


@pytest.fixture(scope="module")
def pair():
    """The same weights in both packages: JAX init -> build_storage -> the
    port's state dict."""
    jcfg = JaxLlamaConfig(**ARCH, kv_cache=JaxKVCacheConfig.int_sym(P, R, 4))
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(JaxLlama(jcfg, None).init)(jax.random.PRNGKey(0),
                                               ids)["params"]
    storage, slim = jax_build(params, "w4a16", 64)
    jmodel = JaxLlama(jcfg, JaxQuantConfig().with_storage("w4a16", 64))
    tcfg = qt.LlamaConfig(**ARCH, kv_cache=qt.KVCacheConfig.int_sym(P, R, 4))
    tmodel = qt.LlamaForCausalLM(
        tcfg, qt.QuantConfig().with_storage("w4a16", 64), device="cpu")
    tmodel.load_state_dict(qt.params_from_jax(_np(slim), _np(storage)))
    return jmodel, {"params": slim, "storage": storage}, tmodel


@pytest.fixture(scope="module")
def jax_steps(pair):
    """The JAX model's prefill (compiled once a prompt length) and decode
    step (compiled once, the position traced), jitted as the reference's
    own generate() jits its decode step, and shared by the cases."""
    jmodel = pair[0]

    def prefill(variables, ids, S):
        return jmodel.apply(variables, ids, use_cache=True, cache_index=0,
                            prompt_len=S, mutable=["cache"])

    def step(variables, cache, tok, pos):
        logits, upd = jmodel.apply({**variables, "cache": cache}, tok,
                                   use_cache=True, cache_index=pos,
                                   mutable=["cache"])
        return logits, upd["cache"]

    return jax.jit(prefill, static_argnums=2), jax.jit(step)


def _prompt(S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, S)).astype(
        np.int32)


# Logit tolerance: the JAX suite's own bound between fused and naive decode
# paths (tests/test_int_kv.py:174).  The packages round bf16 at the same
# points but sum in another order, and the flash kernel rounds p before the
# running rescale while the plain version rounds it after the softmax.
ATOL, RTOL = 0.15, 0.05


@pytest.mark.parametrize("S", [128, 40])
def test_prefill_and_decode_logits_match_jax(pair, jax_steps, S):
    _, jvars, tmodel = pair
    jprefill, jstep = jax_steps
    ids = _prompt(S)
    jl, upd = jprefill(jvars, jnp.asarray(ids), S)
    tl, caches = tmodel(torch.from_numpy(ids).long(), use_cache=True,
                        prompt_len=S)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    jcache = upd["cache"]
    tok = 7
    for step in range(4):
        jl, jcache = jstep(jvars, jcache, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray(S + step, jnp.int32))
        tl, caches = tmodel(torch.tensor([[tok]]), use_cache=True,
                            caches=caches, cache_index=S + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL, err_msg=f"decode step {step}")
        tok = int(np.argmax(np.asarray(jl)[0, -1]))


@pytest.mark.parametrize("S", [128, 40])
def test_greedy_generate_tokens_equal_jax(pair, S):
    jmodel, jvars, tmodel = pair
    ids = _prompt(S, seed=1)
    want = np.asarray(jax_generate(jmodel, jvars, jnp.asarray(ids),
                                   max_new_tokens=6))
    got = qt.generate(tmodel, torch.from_numpy(ids).long(), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_matches_generate(pair):
    """Continuous batching over the int4 cache: three requests of different
    lengths (one per prefill bucket, more requests than slots) give the
    tokens generate() gives each alone."""
    _, _, tmodel = pair
    prompts = [_prompt(S, seed=2 + i)[0] for i, S in enumerate((128, 50, 9))]
    engine = qt.ContinuousBatchingEngine(tmodel, batch_slots=2)
    rids = [engine.submit(p, max_new_tokens=5) for p in prompts]
    results = engine.run()
    for rid, p in zip(rids, prompts):
        ref = qt.generate(tmodel, torch.from_numpy(p[None]).long(), 5)
        assert results[rid] == ref[0, len(p):].tolist(), rid


def test_engine_stop_sequence_trims(pair):
    """A stop sequence ends the request at its first match in the decoded
    tail and is trimmed from the output."""
    _, _, tmodel = pair
    prompt = _prompt(30, seed=6)[0]
    ref = qt.generate(tmodel, torch.from_numpy(prompt[None]).long(), 6)
    ref = ref[0, len(prompt):].tolist()
    stop = ref[3]
    end = next(i for i in range(1, len(ref)) if ref[i] == stop)
    engine = qt.ContinuousBatchingEngine(tmodel, batch_slots=1)
    rid = engine.submit(prompt, max_new_tokens=6, stop=[[stop]])
    assert engine.run()[rid] == ref[:end]


def test_engine_sampled_request_leaves_greedy_slot_unchanged(pair):
    """Per-request sampling params: a temperature-1 request in one slot
    draws in-vocab tokens from the engine's generator, and the greedy
    request beside it still gives generate()'s tokens."""
    _, _, tmodel = pair
    greedy, sampled = _prompt(40, seed=8)[0], _prompt(25, seed=9)[0]
    engine = qt.ContinuousBatchingEngine(
        tmodel, batch_slots=2, generator=torch.Generator().manual_seed(1))
    rg = engine.submit(greedy, max_new_tokens=5)
    rs = engine.submit(sampled, max_new_tokens=5, temperature=1.0, top_k=8)
    results = engine.run()
    ref = qt.generate(tmodel, torch.from_numpy(greedy[None]).long(), 5)
    assert results[rg] == ref[0, len(greedy):].tolist()
    assert len(results[rs]) == 5
    assert all(0 <= t < ARCH["vocab_size"] for t in results[rs])


def test_fuse_qkv_params_matches_jax():
    cfg = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2)
    rng = np.random.default_rng(4)
    attn = {name: {"kernel": rng.standard_normal((64, n)).astype(np.float32)}
            for name, n in (("q_proj", 64), ("k_proj", 32), ("v_proj", 32),
                            ("o_proj", 64))}
    tree = {"model": {"layers_0": {"self_attn": attn}}}
    want = qt.params_from_jax(_np(jax_fuse_qkv_params(
        tree, JaxLlamaConfig.tiny(**cfg))))
    got = fuse_qkv_params(qt.params_from_jax(tree), qt.LlamaConfig.tiny(**cfg))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy())


def test_random_params_load_and_are_seeded():
    cfg = qt.LlamaConfig(**ARCH, kv_cache=qt.KVCacheConfig.int_sym(P, R, 4))
    qc = qt.QuantConfig().with_storage("w4a16", 64)
    a = qt.random_params(cfg, "w4a16", 64, seed=3, device="cpu")
    b = qt.random_params(cfg, "w4a16", 64, seed=3, device="cpu")
    model = qt.LlamaForCausalLM(cfg, qc, device="cpu")
    model.load_state_dict(a, assign=True)           # strict: names match
    assert "lm_head.codes" in a and "model.embed_tokens.embedding" in a
    for name in a:
        assert torch.equal(a[name], b[name]), name
    logits, _ = model(torch.zeros((1, 4), dtype=torch.long))
    assert torch.isfinite(logits).all()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the missing-CUDA error")
    cfg = qt.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        qt.random_params(cfg, None)


def test_sampling():
    logits = torch.tensor([[0.0, 3.0, 3.0, -1.0],
                           [float("nan"), 1.0, 2.0, float("nan")],
                           [5.0, 4.0, 0.0, 1.0]])
    assert fast_argmax(logits).tolist() == [1, 0, 0]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((6, 50), generator=gen)
    greedy = fast_argmax(x)
    zeros = torch.zeros(6)
    ones = torch.ones(6)
    k0 = torch.zeros(6, dtype=torch.long)
    assert torch.equal(sample_batch(x, gen, zeros, k0, ones), greedy)
    assert torch.equal(sample_batch(x, gen, ones, k0 + 1, ones), greedy)
    drawn = sample_batch(x, gen, ones, k0 + 5, ones)
    top5 = torch.topk(x, 5).indices
    assert all(int(t) in top5[i].tolist() for i, t in enumerate(drawn))
