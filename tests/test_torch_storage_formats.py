"""The storage formats beyond w4a16 against the JAX package: posit8, mx8,
w2a16, w2x4 and w8a8.  Packed codes and qparams bit-equal to JAX
``build_storage``; each storage model's logits bit-equal to the port's dense
model on the dequantized weights (as tests/test_storage_deploy.py:54,71
holds the JAX package) and close to JAX's storage model; the plane-major
streaming dequant equal to the plain dequant; w8a8's integer accumulation
exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quantized_training_tpu.models import LlamaConfig as JaxLlamaConfig
from quantized_training_tpu.models import LlamaForCausalLM as JaxLlama
from quantized_training_tpu.ops import int8_matmul as jax_int8
from quantized_training_tpu.ops.pallas import affine_storage as jax_affine
from quantized_training_tpu.ops.pallas import mx_storage as jax_mx
from quantized_training_tpu.ops.pallas import posit_storage as jax_posit
from quantized_training_tpu.quantize import QuantConfig as JaxQuantConfig
from quantized_training_tpu.quantize import build_storage as jax_build

import quantized_training_torch as qt
from quantized_training_torch.numerics.posit import decode_posit
from quantized_training_torch.ops import affine_storage as aff
from quantized_training_torch.ops import int8_matmul, mx_storage, \
    posit_storage
from quantized_training_torch.quantize import build_storage

GROUP = 64
FORMATS = ("posit8", "mx8", "w2a16", "w2x4", "w8a8")
# hidden 256, intermediate 512: every contraction dim is a whole number of
# w2 words per group (the JAX suite's geometry, test_storage_deploy.py:20)
ARCH = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    """Seeded numpy weights in the JAX model's param tree."""
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


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(1).integers(0, 256, (2, 12)).astype(
        np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the tier-1 run puts several test processes on the
    cores, and the packing of the posit8 weights is many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def built(params):
    """fmt -> both packages' storage from the same weights, built once per
    format: (JAX storage, JAX slim params, the port's storage, the port's
    slim params)."""
    cache = {}

    def get(fmt):
        if fmt not in cache:
            storage, slim = jax_build(params, fmt, GROUP)
            got, got_slim = build_storage(qt.params_from_jax(_np(params)),
                                          fmt, GROUP, device="cpu")
            cache[fmt] = storage, slim, got, got_slim
        return cache[fmt]

    return get


@pytest.mark.parametrize("fmt", FORMATS)
def test_build_storage_bit_equal(built, fmt):
    """Every 2-D kernel, lm_head included, packs to JAX's codes and qparams
    (dtype, shape and bits); the embedding and norms stay dense."""
    storage, slim, got, got_slim = built(fmt)
    want = qt.params_from_jax(_np(storage))
    assert sorted(got) == sorted(want)
    assert "lm_head.codes" in got
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        if got[name].dtype == torch.bfloat16:
            assert torch.equal(got[name].view(torch.int16),
                               want[name].view(torch.int16)), name
        else:
            np.testing.assert_array_equal(got[name].numpy(),
                                          want[name].numpy(), err_msg=name)
    assert sorted(got_slim) == sorted(qt.params_from_jax(_np(slim)))


def _dequantized(fmt, sd):
    """The dense kernel a storage layer's buffers stand for, in f32."""
    codes = sd["codes"]
    if fmt == "posit8":
        return decode_posit(codes, 8, 1)
    if fmt == "mx8":
        return mx_storage.mx_dequant(codes, sd["scales"], GROUP, torch.float32)
    if fmt == "w8a8":
        return codes.to(torch.float32) * sd["scales"][None, :]
    nbits = 2 if fmt == "w2a16" else 4
    return aff._dequant_planes(codes, sd["scales"], sd["zero_points"], nbits,
                               GROUP)


def _model(fmt):
    qc = qt.QuantConfig().with_storage(fmt, GROUP) if fmt else None
    return qt.LlamaForCausalLM(qt.LlamaConfig(**ARCH), qc, device="cpu")


@pytest.mark.parametrize("fmt", ["posit8", "mx8", "w2a16", "w2x4"])
def test_storage_logits_bit_equal_dense_on_dequantized(built, ids, fmt):
    """The storage model equals the port's dense model whose kernels are
    the packed dequant, bit for bit (tests/test_storage_deploy.py:54,71).
    (w2x4 is not bit-equal to w2a16: its zero points are shifted by +6 in
    f32, and the group-affine zero point is not an integer.)"""
    _, _, got, got_slim = built(fmt)
    model = _model(fmt)
    model.load_state_dict({**got_slim, **got})
    dense = dict(got_slim)
    for name in got:
        if name.endswith(".codes"):
            prefix = name[:-len("codes")]
            bufs = {k[len(prefix):]: v for k, v in got.items()
                    if k.startswith(prefix)}
            dense[prefix + "kernel"] = _dequantized(fmt, bufs)
    ref = _model(None)
    ref.load_state_dict(dense)
    x = torch.from_numpy(ids).long()
    out, _ = model(x)
    np.testing.assert_array_equal(out.numpy(), ref(x)[0].numpy())


@pytest.mark.parametrize("fmt", FORMATS)
def test_storage_logits_match_jax(built, ids, fmt):
    """The port's storage model against JAX's on the same packed weights,
    at the JAX suite's logit tolerance (0.15/0.05, tests/test_int_kv.py:174;
    the JAX storage GEMMs on the CPU are the same dequant + f32 dot)."""
    storage, slim, _, _ = built(fmt)
    jmodel = JaxLlama(JaxLlamaConfig(**ARCH),
                      JaxQuantConfig().with_storage(fmt, GROUP))
    want = jax.jit(jmodel.apply)({"params": slim, "storage": storage},
                                 jnp.asarray(ids))
    model = _model(fmt)
    model.load_state_dict(qt.params_from_jax(_np(slim), _np(storage)))
    got, _ = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=0.15, rtol=0.05)


# ---- the kernels' plain versions -----------------------------------------

def _weights(K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)


@pytest.mark.parametrize("nbits", [4, 2])
def test_dequant_planes_bit_equal(nbits):
    """The plane-major dequant is _dequant_planes rounded to bf16 with rows
    permuted, bit for bit, and _plane_major_x(x) @ it is the product;
    both equal the JAX kernel body (Pallas interpreter) bit for bit."""
    K, N = 192, 48
    codes, sf, zp = aff.pack_affine_weights(torch.from_numpy(_weights(K, N)),
                                            nbits, GROUP)
    per = 32 // nbits
    w_pm = aff.dequant_planes(codes, sf, zp, nbits, GROUP)
    w = aff._dequant_planes(codes, sf, zp, nbits, GROUP).to(torch.bfloat16)
    for p in range(per):
        assert torch.equal(w_pm[p * (K // per):(p + 1) * (K // per)],
                           w[p::per]), p
    want = jax_affine.dequant_planes_tpu(
        jnp.asarray(codes.numpy()), jnp.asarray(sf.numpy()),
        jnp.asarray(zp.numpy()), nbits, GROUP, interpret=True)
    np.testing.assert_array_equal(w_pm.float().numpy(),
                                  np.asarray(want, np.float32))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, K)).astype(np.float32))
    x_pm = aff._plane_major_x(x, K // per, per)
    np.testing.assert_array_equal(
        x_pm.numpy(), np.asarray(jax_affine._plane_major_x(
            jnp.asarray(x.numpy()), K // per, per)))
    np.testing.assert_allclose((x_pm @ w_pm.float()).numpy(),
                               (x @ w.float()).numpy(), rtol=1e-6, atol=1e-6)


def test_expand_w2_words_bit_equal():
    codes2, _, _ = aff.pack_affine_weights(torch.from_numpy(_weights(256, 40)),
                                           2, GROUP)
    got = aff.expand_w2_words_to_w4(codes2)
    want = jax_affine.expand_w2_words_to_w4(jnp.asarray(codes2.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt", ["mx8", "posit8", "w2a16"])
def test_plain_matmul_equals_jax_fallback(fmt):
    """f32 inputs through each format's GEMM equal the JAX function (its
    CPU fallback: the same dequant and an f32 dot) to f32 summation order;
    the identity picks out the dequantized weight bit for bit."""
    K, N = 192, 64
    w = _weights(K, N, seed=4)
    x = np.random.default_rng(5).standard_normal((7, K)).astype(np.float32)
    eye = np.eye(K, dtype=np.float32)
    if fmt == "mx8":
        tc, ts = mx_storage.pack_mx_weights(torch.from_numpy(w),
                                            block_size=GROUP)
        jc, js = jax_mx.pack_mx_weights(jnp.asarray(w), block_size=GROUP)

        def port(a):
            return mx_storage.mx_matmul(a, tc, ts, block_size=GROUP)

        def ref(a):
            return jax_mx.mx_matmul(a, jc, js, block_size=GROUP)
    elif fmt == "posit8":
        tc = posit_storage.pack_posit_weights(torch.from_numpy(w))
        jc = jax_posit.pack_posit_weights(jnp.asarray(w))

        def port(a):
            return posit_storage.posit_matmul(a, tc)

        def ref(a):
            return jax_posit.posit_matmul(a, jc)
    else:
        tc, ts, tz = aff.pack_affine_weights(torch.from_numpy(w), 2, GROUP)
        jc, js, jz = jax_affine.pack_affine_weights(jnp.asarray(w), 2, GROUP)

        def port(a):
            return aff.affine_matmul(a, tc, ts, tz, nbits=2,
                                     group_size=GROUP)

        def ref(a):
            return jax_affine.affine_matmul(a, jc, js, jz, nbits=2,
                                            group_size=GROUP)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(
        port(torch.from_numpy(eye)).numpy(), np.asarray(ref(jnp.asarray(eye))))
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                               np.asarray(ref(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_w8a8_integer_accumulation_exact():
    """The integer dot is exact, so scaling after it equals the reference
    int32 matmul (tests/test_fake_quant.py:498-515) and JAX's result; codes
    and scales are bit-equal to JAX's."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(32, 128)) * 3).astype(np.float32)
    w = rng.normal(size=(128, 64)).astype(np.float32)
    codes, ws = int8_matmul.pack_int8_weights(torch.from_numpy(w))
    xc, xs = int8_matmul.quantize_int8_rowwise(torch.from_numpy(x))
    jcodes, jws = jax_int8.pack_int8_weights(jnp.asarray(w))
    jxc, jxs = jax_int8.quantize_int8_rowwise(jnp.asarray(x))
    for t, a in ((codes, jcodes), (ws, jws), (xc, jxc), (xs, jxs)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    acc = xc.numpy().astype(np.int64) @ codes.numpy().astype(np.int64)
    ref = (acc.astype(np.float32) * xs.numpy()[:, None]
           * ws.numpy()[None, :])
    out = int8_matmul.w8a8_matmul(torch.from_numpy(x), codes, ws,
                                  out_dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), ref)
    want = jax_int8.w8a8_matmul(jnp.asarray(x), jcodes, jws,
                                out_dtype=jnp.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_w8a8_zero_rows_and_channels():
    """All-zero activations and weights keep finite unit scales and give
    zeros (tests/test_fake_quant.py:530-540)."""
    x = torch.zeros((4, 32), dtype=torch.bfloat16)
    codes, ws = int8_matmul.pack_int8_weights(torch.zeros((32, 8)))
    _, xs = int8_matmul.quantize_int8_rowwise(x)
    assert torch.isfinite(xs).all() and torch.isfinite(ws).all()
    out = int8_matmul.w8a8_matmul(x, codes, ws)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), torch.zeros((4, 8)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_random_params_load_for_every_format(fmt):
    """random_params packs leaf by leaf for every format, and the weights
    load strictly into that format's model."""
    cfg = qt.LlamaConfig(**ARCH)
    sd = qt.random_params(cfg, fmt, GROUP, seed=3, device="cpu")
    model = _model(fmt)
    model.load_state_dict(sd, assign=True)
    assert "lm_head.codes" in sd
    logits, _ = model(torch.zeros((1, 4), dtype=torch.long))
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("wrapper,args", [
    (mx_storage.mx_matmul, (torch.zeros((64, 8), dtype=torch.int8),
                            torch.ones((1, 8), dtype=torch.bfloat16))),
    (posit_storage.posit_matmul, (torch.zeros((64, 8), dtype=torch.int8),)),
])
def test_kernel_wrappers_reject_other_devices(wrapper, args):
    """A wrapper takes its plain version only for CPU tensors."""
    x = torch.zeros((2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="device"):
        wrapper(x, *(a.to("meta") for a in args))


def test_decode_workspace_and_plan_kept(monkeypatch):
    """The MX8/posit8 decode form's host side: the library's plan is asked
    once a shape and device, a launch without split K gets no workspace,
    and the workspace and zeroed counters are kept per device and stream,
    grown when a call needs more."""
    from quantized_training_torch.ops import _decode_gemm as dg
    asked = []

    def fake_plan(M, K, N, param, sms, out):
        asked.append((M, K, N, param, sms))
        out[0], out[1], out[2], out[3] = (2, 4096, 3, 128) if N > 128 \
            else (1, 0, 0, 128)

    cpu = torch.device("cpu")
    monkeypatch.setitem(dg._SMS, cpu.index, 132)
    monkeypatch.setattr(dg, "_PLANS", {})
    monkeypatch.setattr(dg, "_WORKSPACES", {})
    assert dg.decode_plan(fake_plan, cpu, 8, 4096, 4096, 64) == \
        (2, 4096, 3, 128, 132)
    assert dg.decode_plan(fake_plan, cpu, 8, 4096, 4096, 64)[0] == 2
    assert asked == [(8, 4096, 4096, 64, 132)]
    assert dg.decode_args(fake_plan, cpu, 7, 8, 4096, 128, 64) == \
        (None, 0, None, 0, 132)
    part, floats, count, ints, sms = dg.decode_args(fake_plan, cpu, 7, 8,
                                                    4096, 4096, 64)
    assert floats >= 4096 and ints >= 3 and sms == 132
    ws = dg.decode_workspace(cpu, 7, 4096, 3)
    assert (ws[0], ws[2]) == (part, count)
    assert not ws[5].any() and ws[4].dtype == torch.float32
    assert dg.decode_workspace(cpu, 8, 16, 1)[0] != part   # another stream
    grown = dg.decode_workspace(cpu, 7, 10 * floats, ints)
    assert grown[1] >= 10 * floats and grown[0] != part and grown[2] == count
    assert dg.decode_workspace(cpu, 7, 4096, 3)[0] == grown[0]
