"""The port's fake quantization, folding, presets, posit softmax, gradient
taps and fused quantize-matmul against the JAX package, on the CPU, with
inputs made by numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_training_tpu import quantize as jq
from quantized_training_tpu.models.layers import bwd_quantize as jax_bwd
from quantized_training_tpu.numerics import quantize_fn as jax_qfn
from quantized_training_tpu.ops.pallas.quantized_matmul import (
    quantized_matmul as jax_qmm,
)
from quantized_training_tpu.ops.softmax import posit_softmax as jax_psm
from quantized_training_tpu.qspec import QuantizationSpec as JaxSpec
from quantized_training_tpu.quantize import presets as jpresets

from quantized_training_torch import quantize as tq
from quantized_training_torch.models.layers import bwd_quantize
from quantized_training_torch.numerics import quantize_fn
from quantized_training_torch.ops.quantized_matmul import quantized_matmul
from quantized_training_torch.ops.softmax import posit_softmax
from quantized_training_torch.qspec import QuantizationSpec


def _x(shape, seed, scale=3.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    x.flat[:3] = [0.0, -0.0, 1e-40]
    return x


def _pair(x, dtype):
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x, getattr(jnp, dtype)))


def _eq(t, j):
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j, np.float32))


STATELESS = [
    "posit8_1", "e4m3", "fp6_e3m2", "int4",
    "int8,qs=microscaling,bs=32,ax=-1",
    "fp8_e4m3,qs=microscaling,bs=16,ax=-1,scale=fp8_e5m3",
    "int6,qs=microscaling,bs=64,ax=-2",
    "uint4,qs=group_wise_affine,bs=32,ax=-1",
    "uint4,qs=group_wise_affine,bs=16,ax=-2,scale=fp8_e4m3",
    "int8,qs=microscaling,bs=32,ax=-1,outlier=4.0",
]


@pytest.mark.parametrize("spec", STATELESS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stateless_schemes_bit_equal(spec, dtype):
    x = _x((8, 96), seed=len(spec))
    t, j = _pair(x, dtype)
    got, _ = tq.fake_quantize(t, QuantizationSpec.from_str(spec))
    want, _ = jq.fake_quantize(j, JaxSpec.from_str(spec))
    _eq(got, want)


def test_mx_power_of_two_scales_bit_equal():
    spec = "int8,qs=microscaling,bs=32,ax=-1"
    t, j = _pair(_x((4, 64), seed=9), "float32")
    got, _ = tq.fake_quantize(
        t, QuantizationSpec.from_str(spec).replace(force_scale_power_of_two=True))
    want, _ = jq.fake_quantize(
        j, JaxSpec.from_str(spec).replace(force_scale_power_of_two=True))
    _eq(got, want)


@pytest.mark.parametrize("spec", [
    "int8,qs=per_tensor_symmetric,ahl=4",
    "e4m3,qs=per_tensor_symmetric",
    "int8,qs=per_channel_symmetric,ax=-1,ahl=3",
    "posit8_1,qs=per_tensor_symmetric,ahl=2,outlier=5.0",
])
def test_delayed_scaling_values_and_state_over_steps(spec):
    tspec, jspec = QuantizationSpec.from_str(spec), JaxSpec.from_str(spec)
    tstate, jstate = None, None
    for step in range(5):
        t, j = _pair(_x((6, 32), seed=20 + step, scale=1.0 + step), "float32")
        got, tstate = tq.fake_quantize(t, tspec, tstate,
                                       observe=step != 3)
        want, jstate = jq.fake_quantize(j, jspec, jstate,
                                        observe=step != 3)
        _eq(got, want)
        for a, b in zip(tstate, jstate):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _bench_params(seed=0):
    """A JAX-layout param tree of a 2-layer LLaMA (hidden 64)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.3
    layer = {"self_attn": {n: {"kernel": mk(64, 64)} for n in
                           ("q_proj", "k_proj", "v_proj", "o_proj")},
             "mlp": {"gate_proj": {"kernel": mk(64, 96)},
                     "up_proj": {"kernel": mk(64, 96)},
                     "down_proj": {"kernel": mk(96, 64)}},
             "input_layernorm": {"scale": np.ones(64, np.float32)},
             "post_attention_layernorm": {"scale": np.ones(64, np.float32)}}
    return {"model": {"embed_tokens": {"embedding": mk(128, 64)},
                      "layers_0": layer,
                      "layers_1": jax.tree_util.tree_map(lambda a: a * 1.5,
                                                         layer),
                      "norm": {"scale": np.ones(64, np.float32)}},
            "lm_head": {"kernel": mk(64, 128)}}


@pytest.mark.parametrize("wspec", ["posit8_1",
                                   "int4,qs=microscaling,bs=32,ax=-2"])
def test_fold_quantized_weights_bit_equal(wspec):
    import quantized_training_torch as qt
    params = _bench_params()
    rules = (("lm_head", None),)       # lm_head left unquantized
    jqc = jq.QuantConfig(global_qconfig=jq.QConfig.from_strs(
        activation="posit8_1", weight=wspec))
    tqc = tq.QuantConfig(global_qconfig=tq.QConfig.from_strs(
        activation="posit8_1", weight=wspec))
    for pattern, qc in rules:
        jqc, tqc = jqc.set_module_name(pattern, qc), tqc.set_module_name(
            pattern, qc)
    want = qt.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jq.fold_quantized_weights(params, jqc)))
    got = tq.fold_quantized_weights(qt.params_from_jax(params), tqc)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)
    orig = qt.params_from_jax(params)
    assert torch.equal(got["lm_head.kernel"], orig["lm_head.kernel"])
    assert not torch.equal(got["model.layers.1.mlp.up_proj.kernel"],
                           orig["model.layers.1.mlp.up_proj.kernel"])
    stripped = tq.strip_weight_specs(tqc)
    assert stripped.weight_spec("model.layers_0.mlp.up_proj") is None
    assert stripped.activation_spec(
        "model.layers_0.mlp.up_proj", "linear", tq.OpCategory.GEMM) == \
        tqc.activation_spec("model.layers_0.mlp.up_proj", "linear",
                            tq.OpCategory.GEMM)


def test_spec_parsing_ladder_and_presets_equal_jax():
    for s in ["posit8_1", "int6,qs=microscaling,bs=64,ax=-1,scale=fp8_e5m3",
              "uint2,qs=group_wise_affine,bs=32,ax=-2",
              "e4m3,qs=per_tensor_symmetric,ahl=16",
              "int8,qs=per_channel_symmetric,ax=(0,1),outlier=3.5",
              "nf4_6,qmin=-3,qmax=3"]:
        a, b = QuantizationSpec.from_str(s), JaxSpec.from_str(s)
        for field in ("dtype", "quant_min", "quant_max", "amax_history_len",
                      "ch_axis", "block_size", "scale_dtype",
                      "outlier_threshold", "force_scale_power_of_two"):
            assert getattr(a, field) == getattr(b, field), (s, field)
        assert (a.qscheme and a.qscheme.value) == (b.qscheme and b.qscheme.value)
    assert [(r, [c.value for c in cs]) for r, cs in tq.FUSION_LADDER] == \
        [(r, [c.value for c in cs]) for r, cs in jq.FUSION_LADDER]
    assert tq.QUANTIZATION_CONFIGS == jpresets.QUANTIZATION_CONFIGS
    sites = [("model.layers_0.mlp.up_proj", "linear", 0),
             ("model.layers_0.self_attn", "matmul", 1),
             ("lm_head", "linear", 0)]
    for name in tq.QUANTIZATION_CONFIGS:
        tc, jc = tq.build_preset(name), jpresets.build_preset(name)
        for path, op, idx in sites:
            for cat in (tq.OpCategory.GEMM,):
                ta = tc.activation_spec(path, op, cat, idx)
                ja = jc.activation_spec(path, op, jq.OpCategory(cat.value),
                                        idx)
                assert str(ta) == str(ja), (name, path)
            assert str(tc.weight_spec(path, op)) == str(jc.weight_spec(path, op))


@pytest.mark.parametrize("spec", ["posit8_1", "e5m2,qs=per_tensor_symmetric",
                                  "int8,qs=microscaling,bs=16,ax=-1"])
def test_bwd_quantize_rounds_the_gradient_as_jax_grad(spec):
    x = _x((4, 32), seed=5, scale=1.0)
    w = _x((4, 32), seed=6, scale=2.0)
    want = jax.grad(lambda a: jnp.sum(
        jax_bwd(a, JaxSpec.from_str(spec)) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    y = bwd_quantize(t, QuantizationSpec.from_str(spec))
    assert torch.equal(y, t)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_exp,use_recip", [(True, False), (False, True),
                                               (True, True)])
def test_posit_softmax_forward_and_backward_match_jax(use_exp, use_recip):
    x = _x((3, 40), seed=11, scale=2.0)
    g = _x((3, 40), seed=12, scale=1.0)
    jx = jnp.asarray(x)
    want, vjp = jax.vjp(lambda a: jax_psm(a, use_exp, use_recip), jx)
    (want_g,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_(True)
    got = posit_softmax(t, use_exp, use_recip)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)


def test_quantized_matmul_plain_matches_jax():
    """The JAX suite's own check (tests/test_fake_quant.py:284-296) and its
    straight-through gradient (:298-312)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    w = rng.standard_normal((128, 32)).astype(np.float32)
    want = jax_qmm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                   x_qfn=jax_qfn("posit8_1"))
    got = quantized_matmul(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(w).bfloat16(),
                           x_qfn=quantize_fn("posit8_1"))
    _eq(got, want)
    p8j, p8t = jax_qfn("posit8_1"), quantize_fn("posit8_1")
    gx = jax.grad(lambda a: jnp.sum(jax_qmm(a, jnp.asarray(w), x_qfn=p8j,
                                            w_qfn=p8j)))(jnp.asarray(x[:16, :]))
    t = torch.from_numpy(x[:16].copy()).requires_grad_(True)
    quantized_matmul(t, torch.from_numpy(w), x_qfn=p8t, w_qfn=p8t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5)
