"""The port's speculative decoding and the caches it runs on, against the
JAX package: the full-precision ring and the unquantized two-tier cache
(prefill and decode logits, greedy tokens, the engine), the verify block's
mask and logits and the cache after a rewind over the KIVI, int-sym and
full-precision targets, greedy ``speculative_generate`` token for token
(tests/test_speculative.py, test_int_kv.py:237, test_serving.py:504), the
refusals, the rejection rule, and the flash gate's refusal of the
full-precision ring."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_training_tpu.models import LlamaConfig as JaxLlamaConfig
from quantized_training_tpu.models import LlamaForCausalLM as JaxLlama
from quantized_training_tpu.serving import kv_cache as jkv
from quantized_training_tpu.serving.generate import generate as jax_generate
from quantized_training_tpu.serving.speculative import (
    _spec_accept as jax_spec_accept,
)
from quantized_training_tpu.serving.speculative import (
    speculative_generate as jax_speculative,
)

import quantized_training_torch as qt
from quantized_training_torch.convert import cache_from_jax
from quantized_training_torch.models import llama as tllama
from quantized_training_torch.serving import kv_cache as tkv
from quantized_training_torch.serving.speculative import (
    _accept_terms, _spec_accept,
)

KIVI = dict(max_prefill=16, max_decode=32,
            k_spec="uint4,qs=group_wise_affine,bs=8,ax=-2",
            v_spec="uint4,qs=group_wise_affine,bs=8,ax=-1", pack=True)


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


_PARAMS = {}


def _params(seed, layers, **arch):
    """JAX init of the tiny LLaMA (shared by every cache mode; the
    weights do not depend on max_position_embeddings)."""
    arch = {k: v for k, v in arch.items() if k in WIDTHS}
    key = (seed, layers, tuple(sorted(arch.items())))
    if key not in _PARAMS:
        model = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=layers,
                                             **arch), None)
        _PARAMS[key] = jax.jit(model.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return _PARAMS[key]


WIDTHS = ("hidden_size", "num_attention_heads", "num_key_value_heads")


def _pair(seed=0, layers=3, jax_kcfg=None, torch_kcfg=None, fused=True,
          **arch):
    """The tiny model in both packages with the same weights and cache;
    ``fused`` is the port's use_fused_kivi (JAX's is off)."""
    params = _params(seed, layers, **arch)
    jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=layers,
                                      kv_cache=jax_kcfg,
                                      use_fused_kivi=False, **arch), None)
    tm = qt.LlamaForCausalLM(
        qt.LlamaConfig.tiny(num_hidden_layers=layers, kv_cache=torch_kcfg,
                            use_fused_kivi=fused, **arch), None, device="cpu")
    tm.load_state_dict(qt.params_from_jax(_np(params)))
    return jm, {"params": params}, tm


INT_SYM = (16, 16, 4)
# Each pair once a file; every JAX call of one pair takes one prompt length
# (the reference's prefill runs eagerly, and its ops compile a shape).
# The JAX two-tier models decode on the naive path (use_fused_kivi=False):
# their target-alone decode then takes the verify block's path, as
# tests/test_speculative.py:157 does, and no Pallas interpreter runs; the
# port's int-sym target (``int_sym``) keeps its fused decode for generate.
BUILD = {
    "target": lambda: _pair(0, 3),
    "draft": lambda: _pair(7, 1),
    "two_tier": lambda: _pair(0, 3, jkv.KVCacheConfig(16, 16),
                              tkv.KVCacheConfig(16, 16)),
    "kivi": lambda: _pair(0, 3, jkv.KVCacheConfig.kivi(**KIVI),
                          tkv.KVCacheConfig.kivi(**KIVI), fused=False),
    "int_sym": lambda: _pair(0, 2, jkv.KVCacheConfig.int_sym(*INT_SYM),
                             tkv.KVCacheConfig.int_sym(*INT_SYM),
                             max_position_embeddings=64),
    "int_sym_naive": lambda: _pair(0, 2, jkv.KVCacheConfig.int_sym(*INT_SYM),
                                   tkv.KVCacheConfig.int_sym(*INT_SYM),
                                   fused=False, max_position_embeddings=64),
    "draft_64": lambda: _pair(0, 2, max_position_embeddings=64),
}
_PAIRS = {}


def pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = BUILD[name]()
    return _PAIRS[name]


_JIT = {}


def _apply(jm):
    """``jm.apply`` with use_cache and the cache mutable, jitted once a
    model (a shape compiles once; the reference's eager ops compile one
    by one, several times slower on the CPU)."""
    if id(jm) not in _JIT:
        _JIT[id(jm)] = jax.jit(
            functools.partial(jm.apply, use_cache=True, mutable=["cache"]),
            static_argnames=("decode_append",))
    return _JIT[id(jm)]


def _jax_generate(jm, jv, ids, n, **kw):
    """The reference's generate under one jit, as its benchmarks call it."""
    return np.asarray(jax.jit(lambda v, i: jax_generate(jm, v, i, n, **kw))(
        jv, jnp.asarray(ids)))


# the prompt length each target's JAX calls take
PROMPT_LEN = {"target": 11, "two_tier": 11, "kivi": 10, "int_sym": 8,
              "int_sym_naive": 8}


def _prompt(seed=3, S=11):
    return np.random.default_rng(seed).integers(0, 256, (1, S)).astype(
        np.int32)


def _ids(a):
    return torch.from_numpy(a).long()


def _assert_logits(got, want, what=""):
    """Logits equal up to one bf16 step in a few outputs: XLA and torch sum
    f32 in other orders, so a rounded value can land a step apart."""
    got, want = got.numpy(), np.asarray(want)
    step = np.abs(want) * 2.0 ** -7 + 2.0 ** -20
    off = got != want
    assert (np.abs(got - want) <= step).all() and off.mean() <= 0.01, (
        what, off.sum(), np.abs(got - want).max())


# ---- the full-precision caches -------------------------------------------

@pytest.mark.parametrize("mode", ["target", "two_tier"])
def test_full_precision_caches_match_jax(mode):
    """The full-precision ring (``target``) and the unquantized two-tier
    cache: prefill and decode logits equal JAX's, the caches too (through
    cache_from_jax), and greedy generate's tokens."""
    jm, jv, tm = pair(mode)
    ids = _prompt(3, 11)
    plen = 11 if mode == "two_tier" else None
    jl, upd = _apply(jm)(jv, jnp.asarray(ids), cache_index=0,
                         prompt_len=plen)
    tl, caches = tm(_ids(ids), use_cache=True, prompt_len=plen)
    _assert_logits(tl, jl, "prefill")
    jcache = upd["cache"]
    tok = 5
    for step in range(3):
        jl, upd = _apply(jm)({**jv, "cache": jcache},
                             jnp.asarray([[tok]], jnp.int32),
                             cache_index=11 + step)
        jcache = upd["cache"]
        tl, caches = tm(torch.tensor([[tok]]), use_cache=True,
                        caches=caches, cache_index=11 + step)
        _assert_logits(tl, jl, f"decode step {step}")
        tok = int(np.argmax(np.asarray(jl)[0, -1]))
    _assert_caches(caches, jcache, mode == "target")
    want = _jax_generate(jm, jv, ids, 9)
    np.testing.assert_array_equal(qt.generate(tm, _ids(ids), 9).numpy(),
                                  want)


def _layer_cache(jcache, i, ring):
    """Layer i of a JAX cache tree as the port's cache."""
    attn = _np(jcache["model"][f"layers_{i}"]["self_attn"])
    return cache_from_jax(attn if ring else attn["kivi"])


def _assert_caches(caches, jcache, ring):
    """The port's per-layer caches equal JAX's."""
    for i, got in enumerate(caches):
        want = _layer_cache(jcache, i, ring)
        assert type(got) is type(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.float().numpy(),
                                          b.float().numpy())


def test_engine_on_unquantized_two_tier_matches_jax_generate():
    """tests/test_serving.py:504: one request through the engine over the
    unquantized main tier == generate's tokens (JAX's)."""
    jm, jv, tm = pair("two_tier")
    prompt = _prompt(8, 11)[0]
    want = _jax_generate(jm, jv, prompt[None], 4)
    engine = qt.ContinuousBatchingEngine(tm, batch_slots=2)
    rid = engine.submit(prompt, max_new_tokens=4)
    assert engine.run()[rid] == want[0, 11:].tolist()


def test_generate_refuses_past_the_ring():
    _, _, tm = pair("target")
    with pytest.raises(ValueError, match="ring"):
        qt.generate(tm, _ids(_prompt(S=100)), 29)   # max_position 128


# ---- the verify block ----------------------------------------------------

@pytest.mark.parametrize("q_len,main_len,res_len",
                         [(1, 16, 0), (5, 11, 3), (3, 16, 29), (5, 0, 0)])
def test_residual_causal_mask_bit_equal(q_len, main_len, res_len):
    jcfg, tcfg = jkv.KVCacheConfig.kivi(**KIVI), tkv.KVCacheConfig.kivi(**KIVI)
    want = jkv.residual_causal_mask(jcfg, 2, q_len, jnp.int32(main_len),
                                    jnp.int32(res_len))
    got = tkv.residual_causal_mask(
        tcfg, 2, q_len, torch.tensor(main_len, dtype=torch.int32),
        torch.tensor(res_len, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rewind(node, n):
    """A JAX cache tree with every two-tier layer's res_len lowered by n,
    as the reference's speculative loop rewinds it."""
    if isinstance(node, dict):
        return {key: _rewind(val, n) for key, val in node.items()}
    return node._replace(res_len=node.res_len - n)


@pytest.mark.parametrize("mode", ["kivi", "int_sym_naive", "target"])
def test_verify_block_and_rewind_match_jax(mode):
    """From JAX's prefill cache (shared state), a 5-token verify block at
    the prompt's end (the two-tier caches take it through decode_append),
    a rewind of its 3 rejected slots, a second block from the rewound
    length: logits equal JAX's at each block, and the caches after each
    block and each rewind equal JAX's (the full-precision ring rewinds by
    its index)."""
    jm, jv, tm = pair(mode)
    ring = mode == "target"
    S = PROMPT_LEN[mode]
    ids = _prompt(11, S)
    _, upd = _apply(jm)(jv, jnp.asarray(ids), cache_index=0,
                        prompt_len=None if ring else S)
    jcache = upd["cache"]
    caches = [_layer_cache(jcache, i, ring)
              for i in range(tm.config.num_hidden_layers)]
    p = S
    for block in ([[9, 200, 33, 7, 81]], [[5, 17, 42, 250, 0]]):
        block = np.asarray(block, np.int32)
        jl, upd = _apply(jm)({**jv, "cache": jcache}, jnp.asarray(block),
                             cache_index=p, decode_append=True)
        jcache = upd["cache"]
        tl, caches = tm(_ids(block), use_cache=True, caches=caches,
                        cache_index=p, decode_append=True)
        _assert_logits(tl, jl, f"verify block at {p}")
        _assert_caches(caches, jcache, ring)
        # keep [t_last, d_1]: 3 slots rejected
        if not ring:
            caches = [c._replace(res_len=c.res_len - 3) for c in caches]
            jcache = _rewind(jcache, 3)
            _assert_caches(caches, jcache, False)
        p += 2


def test_engine_cache_refuses_a_verify_block():
    """A per-slot (engine) cache decodes one token a step, as in JAX."""
    _, _, tm = pair("kivi")
    engine = qt.ContinuousBatchingEngine(tm, batch_slots=2)
    engine.submit(_prompt(1, 8)[0], max_new_tokens=2)
    engine._fill_slots()
    with pytest.raises(ValueError, match="one token"):
        tm(torch.zeros((2, 3), dtype=torch.long), use_cache=True,
           caches=engine.caches, decode_append=True)


# ---- greedy speculative decoding -----------------------------------------

# name: (target, draft, prompt seed, max_new, k, eos, JAX's case) of a
# case of tests/test_speculative.py (TestKiviSpeculative at :148) or
# tests/test_int_kv.py:237.  Cases of one target, prompt and length share
# JAX's tokens: the JAX side runs (and compiles its loop for) one of them.
GREEDY = {
    "perfect": ("target", "target", 3, 17, 4, None, "perfect"),
    "disagree_k1": ("target", "draft", 5, 21, 1, None, "disagree_k3"),
    "disagree_k3": ("target", "draft", 5, 21, 3, None, "disagree_k3"),
    "disagree_k6": ("target", "draft", 5, 21, 6, None, "disagree_k3"),
    "single": ("target", "draft", 9, 1, 4, None, "single"),
    "eos": ("target", "draft", 4, 19, 4, 5, "eos"),
    "kivi_k2": ("kivi", "draft", 11, 12, 2, None, "kivi_k2"),
    "kivi_k4": ("kivi", "draft", 11, 12, 4, None, "kivi_k2"),
    "int_sym_k2": ("int_sym", "draft_64", 12, 6, 2, None, "int_sym_k2"),
}
_JAX_TOKENS = {}


def _jax_speculative(name):
    t_name, d_name, seed, n, k, eos, _ = GREEDY[name]
    if name not in _JAX_TOKENS:
        (jt, jtv, _), (jd, jdv, _) = pair(t_name), pair(d_name)
        ids = _prompt(seed, PROMPT_LEN[t_name])
        # under one jit, as the reference's benchmark calls it
        run = jax.jit(lambda tv, dv, i: jax_speculative(
            jt, tv, jd, dv, i, n, k=k, eos_token_id=eos))
        _JAX_TOKENS[name] = np.asarray(run(jtv, jdv, jnp.asarray(ids)))
    return _JAX_TOKENS[name]


@pytest.mark.parametrize("name", sorted(GREEDY))
def test_greedy_speculative_equals_jax_and_target_alone(name):
    t_name, d_name, seed, n, k, eos, jax_case = GREEDY[name]
    tt, td = pair(t_name)[2], pair(d_name)[2]
    ids = _prompt(seed, PROMPT_LEN[t_name])
    got, stats = qt.speculative_generate(tt, td, _ids(ids), n, k=k,
                                         eos_token_id=eos, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), _jax_speculative(jax_case))
    alone = qt.generate(tt, _ids(ids), n, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), alone.numpy())
    if name == "perfect":
        # the draft is the target: every proposal accepted, 1 + 4 x 4 tokens
        assert stats == {"rounds": 4, "accept_rate": 1.0}


def test_refusals():
    tt, td, kivi = (pair(name)[2] for name in ("target", "draft", "kivi"))
    with pytest.raises(ValueError, match="draft"):
        qt.speculative_generate(tt, kivi, _ids(_prompt()), 4)
    with pytest.raises(ValueError, match="max_decode"):
        # max_new + k > max_decode (32)
        qt.speculative_generate(kivi, td, _ids(_prompt(1, 8)), 30, k=4)
    with pytest.raises(ValueError, match="B must be 1"):
        qt.speculative_generate(tt, td, _ids(np.zeros((2, 8), np.int32)), 4)
    with pytest.raises(ValueError, match="ring"):
        qt.speculative_generate(tt, td, _ids(_prompt(S=100)), 24, k=4)


# ---- the rejection rule --------------------------------------------------

def test_spec_accept_matches_jax():
    """The port's acceptance terms decide as JAX's _spec_accept does on
    JAX's own uniform and Gumbel draws, and its probabilities are JAX's
    formulas' within f32 rounding."""
    V, n, T = 8, 256, 0.7
    rng = np.random.default_rng(0)
    p_np = (rng.standard_normal((1, V)) * 2).astype(np.float32)
    q_np = (rng.standard_normal((1, V)) * 2).astype(np.float32)
    x_np = rng.integers(0, V, n).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    acc, repl = jax.vmap(lambda xi, key: jax_spec_accept(
        jnp.asarray(p_np), jnp.asarray(q_np), xi[None], key, T))(
            jnp.asarray(x_np), keys)
    log_ratio, probs = _accept_terms(
        torch.from_numpy(p_np).expand(n, V), torch.from_numpy(q_np).expand(
            n, V), torch.from_numpy(x_np), T)
    # JAX's draws: k_u -> the uniform, k_r -> the categorical's Gumbels
    k_u, k_r = jax.vmap(jax.random.split, out_axes=1)(keys)
    u = np.asarray(jax.vmap(lambda key: jax.random.uniform(key, (1,)))(k_u))
    gumbel = np.asarray(jax.vmap(lambda key: jax.random.gumbel(key, (1, V)))(
        k_r))[:, 0]
    np.testing.assert_array_equal(np.log(u[:, 0]) < log_ratio.numpy(),
                                  np.asarray(acc)[:, 0])
    logp = np.log(np.maximum(probs.numpy(), 1e-38))
    np.testing.assert_array_equal(np.argmax(logp + gumbel, axis=-1),
                                  np.asarray(repl)[:, 0])
    lp = jax.nn.log_softmax(jnp.asarray(p_np) / T)
    lq = jax.nn.log_softmax(jnp.asarray(q_np) / T)
    resid = np.maximum(np.exp(np.asarray(lp)) - np.exp(np.asarray(lq)), 0)
    np.testing.assert_allclose(probs[0].numpy(), (resid / resid.sum())[0],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(log_ratio.numpy(),
                               np.asarray(lp - lq)[0, x_np],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [0.7, 1.0])
def test_spec_accept_marginal_is_target_dist(T):
    """Exact enumeration of the rule: propose x ~ q, accept with min(1,
    p(x)/q(x)), else draw from the residual; the emitted marginal is p."""
    V = 8
    rng = np.random.default_rng(int(T * 10))
    p_log = torch.from_numpy((rng.standard_normal((1, V)) * 2).astype(
        np.float32))
    q_log = torch.from_numpy((rng.standard_normal((1, V)) * 2).astype(
        np.float32))
    x = torch.arange(V)
    log_ratio, probs = _accept_terms(p_log.expand(V, V), q_log.expand(V, V),
                                     x, T)
    q = torch.softmax(q_log[0].double() / T, dim=-1)
    a = torch.clamp(log_ratio.double().exp(), max=1.0)
    emitted = q * a + (q * (1 - a)).sum() * probs[0].double()
    want = torch.softmax(p_log[0].double() / T, dim=-1)
    np.testing.assert_allclose(emitted.numpy(), want.numpy(), atol=1e-6)
    # and the draws: a generator makes them, one accept and one
    # replacement per proposal
    acc, repl = _spec_accept(p_log, q_log, torch.tensor([3]),
                             torch.Generator().manual_seed(0), T)
    assert acc.shape == (1,) and 0 <= int(repl[0]) < V


def test_sampled_draft_equal_to_target_accepts_everything():
    _, _, tm = pair("target")
    out, stats = qt.speculative_generate(
        tm, tm, _ids(_prompt(6)), 15, k=4, temperature=0.8,
        generator=torch.Generator().manual_seed(3), return_stats=True)
    assert stats["accept_rate"] == 1.0
    assert out.shape == (1, 11 + 15)


def test_sampled_varies_with_the_generator():
    tt, td, kivi = (pair(name)[2] for name in ("target", "draft", "kivi"))
    outs = [qt.speculative_generate(
        tt, td, _ids(_prompt(8)), 12, k=3, temperature=1.0,
        generator=torch.Generator().manual_seed(s)).numpy() for s in range(3)]
    assert any(not np.array_equal(outs[0], o) for o in outs[1:])
    for o in outs:
        assert o.shape == (1, 23) and ((o >= 0) & (o < 256)).all()
    o = qt.speculative_generate(kivi, td, _ids(_prompt(2, 9)), 10, k=3,
                                temperature=0.9,
                                generator=torch.Generator().manual_seed(1))
    assert o.shape == (1, 19) and ((o >= 0) & (o < 256)).all()


# ---- the flash gate ------------------------------------------------------

def test_flash_gate_refuses_the_full_precision_ring(monkeypatch):
    """JAX refuses flash whenever a cache is in use except a two-tier
    prefill: a full-precision-ring prefill at S % 128 == 0 takes the naive
    path (its logits JAX's), while a two-tier prefill and a cacheless
    forward of the same shape take flash."""
    arch = dict(hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
                max_position_embeddings=256, use_flash_attention=True)
    jm, jv, tm = _pair(0, 1, **arch)
    calls = []
    real = tllama.flash_attention
    monkeypatch.setattr(tllama, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ids = _prompt(2, 128)
    tl, caches = tm(_ids(ids), use_cache=True)
    assert calls == [] and isinstance(caches[0], tkv.FullPrecisionCache)
    jl, _ = _apply(jm)(jv, jnp.asarray(ids), cache_index=0)
    # hidden 256: the two packages' f32 sums part by a bf16 step or two
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.02,
                               rtol=0.02)
    tm(_ids(ids))
    assert len(calls) == 1
    two_tier = qt.LlamaForCausalLM(
        qt.LlamaConfig.tiny(num_hidden_layers=1, kv_cache=tkv.KVCacheConfig(
            max_prefill=128, max_decode=8), **arch), None, device="cpu")
    two_tier.load_state_dict(tm.state_dict())
    two_tier(_ids(ids), use_cache=True, prompt_len=128)
    assert len(calls) == 2
