"""The port's GPTQ (quantize/gptq.py) and SmoothQuant/AWQ smoothing
(quantize/smooth.py) against the JAX package: GPTQ's codes and qparams bit
for bit (tests/test_gptq.py's cases), the calibrated Hessians (fused and
separate q/k/v), the GPTQ storage bit for bit and served, the smoothing
scales, amaxes, folded params and AWQ's alphas (tests/test_smooth.py), and
a smoothed w8a8 model served."""

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
from quantized_training_tpu.quantize import gptq as jgptq
from quantized_training_tpu.quantize import smooth as jsmooth

import quantized_training_torch as qt
from quantized_training_torch.ops.affine_storage import (
    pack_affine_weights, plane_pack,
)
from quantized_training_torch.quantize import gptq as tgptq
from quantized_training_torch.quantize import smooth as tsmooth

ARCH = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2)
GROUP = 64
AWQ_SPEC = "uint4,qs=group_wise_affine,bs=16,ax=0"


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


def _flat(tree, prefix=""):
    """A nested JAX tree -> {dotted module path: leaf}."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flat(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


# ---- gptq_quantize, tests/test_gptq.py:TestGptqCore ----------------------

def _correlated(rng, K, rows, scale=0.3):
    mix = scale * rng.standard_normal((K, K)).astype(np.float32) \
        + np.eye(K, dtype=np.float32)
    return rng.standard_normal((rows, K)).astype(np.float32) @ mix


def _assert_gptq_equal(w, H, nbits, G, **kw):
    want = jgptq.gptq_quantize(w, np.asarray(H), nbits, G, **kw)
    got = tgptq.gptq_quantize(torch.from_numpy(w), H, nbits, G, **kw)
    for name, a, b in zip(("wq", "codes", "sf", "zp"), got, want):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    return got


@pytest.mark.parametrize("nbits", [4, 2])
def test_identity_hessian_is_rtn_and_jax(nbits):
    rng = np.random.default_rng(0)
    K, N, G = 256, 32, 64
    w = rng.standard_normal((K, N)).astype(np.float32)
    _, codes, sf, zp = _assert_gptq_equal(w, torch.eye(K), nbits, G)
    packed, sfp, zpp = plane_pack(codes, sf, zp, nbits, G)
    ref = pack_affine_weights(torch.from_numpy(w), nbits, G)
    for a, b in zip((packed, sfp, zpp), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("nbits", [4, 2])
def test_correlated_inputs_bit_equal_to_jax(nbits):
    rng = np.random.default_rng(1)
    K, N, G = 256, 64, 64
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = _correlated(rng, K, 512)
    H = tgptq.hessian_from_inputs(torch.from_numpy(x))
    np.testing.assert_array_equal(H.numpy(), jgptq.hessian_from_inputs(x))
    wq, _, _, _ = _assert_gptq_equal(w, H, nbits, G)
    # and it beats RTN on these inputs (tests/test_gptq.py:58)
    rtn = torch.from_numpy(w)
    from quantized_training_torch.ops.affine_storage import _dequant_planes
    rtn = _dequant_planes(*pack_affine_weights(rtn, nbits, G), nbits, G)
    err = lambda wq: float(np.linalg.norm(x @ w - x @ wq.numpy()))
    assert err(wq) < 0.9 * err(rtn)


def test_dead_input_rows_zeroed_bit_equal():
    rng = np.random.default_rng(3)
    K, N, G = 128, 16, 64
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((256, K)).astype(np.float32)
    x[:, 5] = 0.0                       # input feature 5 never fires
    wq, _, _, _ = _assert_gptq_equal(w, tgptq.hessian_from_inputs(x), 4, G)
    assert np.isfinite(wq.numpy()).all()


@pytest.mark.parametrize("block_size", [32, 256])
def test_block_sizes_bit_equal(block_size):
    rng = np.random.default_rng(4)
    K, N, G = 256, 24, 32
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((300, K)).astype(np.float32)
    _assert_gptq_equal(w, tgptq.hessian_from_inputs(x), 4, G,
                       block_size=block_size)


def test_shape_validation():
    w = torch.zeros((100, 8))
    with pytest.raises(ValueError, match="group_size"):
        tgptq.gptq_quantize(w, torch.eye(100), 4, 64)
    with pytest.raises(ValueError, match="hessian shape"):
        tgptq.gptq_quantize(torch.zeros((128, 8)), torch.eye(64), 4, 64)


# ---- the model pipeline ----------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """The tiny LLaMA of both packages with one activation-outlier channel
    (40x one gain, as tests/test_smooth.py makes it), calibration
    batches and the JAX Hessians."""
    jcfg = JaxLlamaConfig.tiny(**ARCH)
    jm = JaxLlama(jcfg, None)
    ids = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
    params = jax.tree_util.tree_map(np.array, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    params["model"]["layers_0"]["input_layernorm"]["scale"][7] *= 40.0
    tm = qt.LlamaForCausalLM(qt.LlamaConfig.tiny(**ARCH), None, device="cpu")
    tm.load_state_dict(qt.params_from_jax(params))
    batches = [np.random.default_rng(s).integers(0, 256, (4, 16)).astype(
        np.int32) for s in (1, 2)]
    return jcfg, jm, params, tm, ids, batches


def _jax_hessians(jm, params, batches):
    """The sown Hessians, op by op as the reference's pipeline runs them
    (under jit XLA keeps silu(gate) * up in f32, so down_proj's operand
    is not the bf16 product the model asks for)."""
    total = None
    for b in batches:
        _, col = jm.apply({"params": params}, jnp.asarray(b),
                          mutable=["gptq"])
        total = jgptq.accumulate_gptq(total, col["gptq"])
    return total


def _torch_hessians(tm, batches):
    total = None
    for b in batches:
        with tgptq.collect_hessians(tm) as col:
            tm(torch.from_numpy(b).long())
        total = tgptq.accumulate_gptq(total, col)
    return total


@pytest.mark.parametrize("fused", [False, True])
def test_calibrated_hessians_equal_jax(setup, fused):
    """Every QDense's Hessian, keyed by its JAX module path, equals the one
    the JAX model sows; with fused q/k/v one Hessian for qkv_proj.
    down_proj's operand bf16(silu(gate)) * up can sit a bf16 step apart
    in a few entries (torch's and XLA's exp part in the last f32 bit), so
    its Hessian is held to 1e-5 of its largest entry."""
    jcfg, jm, params, tm, _, batches = setup
    if fused:
        from dataclasses import replace
        params = _np(jax_fuse_qkv_params(params, jcfg))
        jm = JaxLlama(replace(jcfg, fused_qkv=True), None)
        tm = qt.LlamaForCausalLM(qt.LlamaConfig.tiny(**ARCH, fused_qkv=True),
                                 None, device="cpu")
        tm.load_state_dict(qt.params_from_jax(params))
    want = {k[:-len(".hessian")]: v for k, v in
            _flat(_jax_hessians(jm, params, batches)).items()}
    got = _torch_hessians(tm, batches)
    assert set(got) == set(want)
    assert ("model.layers_0.self_attn.qkv_proj" in got) == fused
    for key, h in got.items():
        if key.endswith("down_proj"):
            np.testing.assert_allclose(h.numpy(), want[key], rtol=0,
                                       atol=1e-5 * np.abs(want[key]).max(),
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(h.numpy(), want[key], err_msg=key)
    # a forward outside the context computes none
    assert all(m.hessians is None for m in tm.modules()
               if isinstance(m, qt.models.layers.QDense))


@pytest.mark.parametrize("fmt", ["w4a16", "w2a16"])
def test_build_storage_gptq_bit_equal_and_served(setup, fmt):
    """From the same Hessians, the GPTQ storage equals JAX's bit for bit
    (block size 64, so that 128-row kernels take the lazy update), and the
    served logits equal JAX's at the JAX suite's logit tolerance."""
    jcfg, jm, params, _, ids, batches = setup
    jh = _jax_hessians(jm, params, batches)
    storage, slim = jgptq.build_storage_gptq(params, jh, fmt, GROUP,
                                             block_size=64)
    want = qt.params_from_jax(_np(slim), _np(storage))
    hessians = {k[:-len(".hessian")]: torch.from_numpy(v)
                for k, v in _flat(jh).items()}
    st, sl = tgptq.build_storage_gptq(qt.params_from_jax(params), hessians,
                                      fmt, GROUP, block_size=64,
                                      device="cpu")
    got = {**sl, **st}
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.dtype == want[name].dtype, name
        np.testing.assert_array_equal(t.numpy(), want[name].numpy(),
                                      err_msg=name)
    qc = qt.QuantConfig().with_storage(fmt, GROUP)
    model = qt.LlamaForCausalLM(qt.LlamaConfig.tiny(**ARCH), qc, device="cpu")
    model.load_state_dict(got)
    jmodel = JaxLlama(jcfg, JaxQuantConfig().with_storage(fmt, GROUP))
    jl = jax.jit(jmodel.apply)({"params": slim, "storage": storage},
                               jnp.asarray(ids))
    tl, _ = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.15,
                               rtol=0.05)


def test_missing_hessian_falls_back_to_rtn(setup):
    _, _, params, _, _, _ = setup
    sd = qt.params_from_jax(params)
    st, sl = tgptq.build_storage_gptq(sd, {}, "w4a16", GROUP, device="cpu")
    st_rtn, sl_rtn = qt.build_storage(sd, "w4a16", GROUP, device="cpu")
    assert set(st) == set(st_rtn) and set(sl) == set(sl_rtn)
    for name, t in st.items():
        np.testing.assert_array_equal(t.numpy(), st_rtn[name].numpy())


def test_rejects_non_affine_formats():
    with pytest.raises(ValueError, match="group-affine"):
        tgptq.build_storage_gptq({}, {}, "posit8", 64, device="cpu")


# ---- smoothing, tests/test_smooth.py ---------------------------------------

def test_smoothing_scales_match_jax():
    rng = np.random.default_rng(1)
    act = np.concatenate([np.abs(rng.standard_normal(61)) * 50,
                          [100.0, 1.0, 0.0]]).astype(np.float32)
    w = np.abs(rng.standard_normal(64)).astype(np.float32)
    w[-1] = 0.0
    for alpha in (0.0, 0.25, 0.5, 0.75, 1.0):
        want = np.asarray(jsmooth.smoothing_scales(jnp.asarray(act),
                                                   jnp.asarray(w), alpha))
        got = tsmooth.smoothing_scales(torch.from_numpy(act),
                                       torch.from_numpy(w), alpha)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)
    s = tsmooth.smoothing_scales(torch.tensor([100.0, 1.0, 0.0]),
                                 torch.ones(3))
    assert float(s[0]) == pytest.approx(10.0, rel=1e-4)
    assert float(s[2]) > 0              # a dead channel clamped


@pytest.fixture(scope="module")
def smoothed(setup):
    """amax calibration, smooth_llama and the AWQ search on both sides."""
    jcfg, jm, params, tm, ids, batches = setup
    variables = {"params": params}
    jamax = jax.jit(lambda v, a, b: jsmooth.calibrate_llama_amax(
        jm, v, [a, b]))(variables, *map(jnp.asarray, batches))
    tamax = tsmooth.calibrate_llama_amax(
        tm, [torch.from_numpy(b).long() for b in batches])
    jalphas, jawq_amax = jsmooth.awq_search_llama(
        jm, variables, jnp.asarray(ids), weight_spec=AWQ_SPEC)
    talphas, tawq_amax = tsmooth.awq_search_llama(
        tm, torch.from_numpy(ids).long(), weight_spec=AWQ_SPEC)
    return dict(jamax=_np(jamax), tamax=tamax, jalphas=jalphas,
                talphas=talphas, jawq_amax=_np(jawq_amax),
                tawq_amax=tawq_amax)


def test_calibrated_amax_and_awq_match_jax(smoothed):
    keys = {f"layers_{i}.{k}" for i in range(2) for k in ("attn", "mlp")}
    for jkey, tkey in (("jamax", "tamax"), ("jawq_amax", "tawq_amax")):
        assert set(smoothed[tkey]) == keys
        for key, a in smoothed[tkey].items():
            np.testing.assert_array_equal(a.numpy(), smoothed[jkey][key],
                                          err_msg=key)
    assert smoothed["talphas"] == smoothed["jalphas"]
    assert set(smoothed["talphas"].values()) <= {0.0, 0.25, 0.5, 0.75, 1.0}


@pytest.mark.parametrize("which", ["alpha", "awq"])
def test_smooth_llama_matches_jax(setup, smoothed, which):
    """The folded params and scales equal JAX's (alpha 0.5, or AWQ's
    alphas), and the float forward stays within tests/test_smooth.py's
    tolerance of the unsmoothed one."""
    _, jm, params, tm, ids, _ = setup
    if which == "alpha":
        jamax, tamax, jalpha, talpha = (smoothed["jamax"], smoothed["tamax"],
                                        0.5, 0.5)
    else:
        jamax, tamax = smoothed["jawq_amax"], smoothed["tawq_amax"]
        jalpha, talpha = smoothed["jalphas"], smoothed["talphas"]
    jp, jscales = jsmooth.smooth_llama(params, jamax, jalpha)
    tp, tscales = tsmooth.smooth_llama(qt.params_from_jax(params), tamax,
                                       talpha)
    want = qt.params_from_jax(_np(jp))
    assert set(tp) == set(want) and set(tscales) == set(jscales)
    for key, s in tscales.items():
        np.testing.assert_allclose(s.numpy(), np.asarray(jscales[key]),
                                   rtol=2e-7, atol=0)
    for name, t in tp.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=5e-7,
                                   atol=0, err_msg=name)
    assert float(tscales["layers_0.attn"][7]) > 3.0   # the outlier channel
    ref, _ = tm(torch.from_numpy(ids).long())
    model = qt.LlamaForCausalLM(qt.LlamaConfig.tiny(**ARCH), None,
                                device="cpu")
    model.load_state_dict(tp)
    out, _ = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=6e-2,
                               atol=8e-2)


def test_smoothed_w8a8_served_matches_jax(setup, smoothed):
    """SmoothQuant then w8a8 storage: the port's logits against JAX's on
    storage built from the same smoothed params (the JAX suite's logit
    tolerance)."""
    jcfg, jm, params, _, ids, _ = setup
    jp, _ = jsmooth.smooth_llama(params, smoothed["jamax"], 0.5)
    storage, slim = jax_build(jp, "w8a8", GROUP)
    jmodel = JaxLlama(jcfg, JaxQuantConfig().with_storage("w8a8", GROUP))
    jl = jax.jit(jmodel.apply)({"params": slim, "storage": storage},
                               jnp.asarray(ids))
    tp, _ = tsmooth.smooth_llama(qt.params_from_jax(params),
                                 smoothed["tamax"], 0.5)
    st, sl = qt.build_storage(tp, "w8a8", GROUP, device="cpu")
    model = qt.LlamaForCausalLM(qt.LlamaConfig.tiny(**ARCH),
                                qt.QuantConfig().with_storage("w8a8", GROUP),
                                device="cpu")
    model.load_state_dict({**sl, **st})
    tl, _ = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.15,
                               rtol=0.05)
