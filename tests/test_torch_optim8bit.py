"""The port's 8-bit Adam against the JAX package on the CPU: the blockwise
quantizers and the packed word and scale layouts bit for bit, Adam8bit
against optax ``adam8bit`` over several steps on a tree with an exact, a
packed and an unpacked leaf (from zero state and from a converted non-zero
JAX state), weight decay, and ``state_nbytes``; kernel 13's plain version
against the reference's XLA path and its Pallas kernel.  That an unpacked 8-bit leaf
launches kernel 13 on CUDA is in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from quantized_training_tpu.ops.pallas import adam8bit_step as jax_step
from quantized_training_tpu.training import adam8bit as jax_adam8bit
from quantized_training_tpu.training import optim8bit as jax_optim
from quantized_training_tpu.training import state_nbytes as jax_nbytes
from quantized_training_torch.convert import adam8bit_state_from_jax
from quantized_training_torch.ops import adam8bit_step as step
from quantized_training_torch.training import Adam8bit, state_nbytes
from quantized_training_torch.training import optim8bit

# an exact leaf (under min_8bit_size), a packed one (nb = 512) and an
# unpacked one (nb = 31, the last block padded)
SHAPES = {"bias": (64,), "packed": (512, 256), "odd": (100, 77)}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [8192, 7700, 256 * 512 + 3])
def test_quantizers_match_jax(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(rng.standard_normal(n) * 3)
         ).astype(np.float32)
    x[:300] = 0.0                          # a zero block: scale 1
    for jq, tq, arg in ((jax_optim._quantize_signed,
                         optim8bit._quantize_signed, x),
                        (jax_optim._quantize_sqrt, optim8bit._quantize_sqrt,
                         x * x)):
        jc, js = jq(jnp.asarray(arg), 256)
        tc, ts = tq(torch.from_numpy(arg), 256)
        assert tc.dtype == {"int8": torch.int8, "uint8": torch.uint8}[
            str(jc.dtype)]
        np.testing.assert_array_equal(tc.numpy(), _np(jc))
        np.testing.assert_array_equal(ts.numpy(), _np(js))
    codes, scale = optim8bit._quantize_signed(torch.from_numpy(x), 256)
    jc, js = jax_optim._quantize_signed(jnp.asarray(x), 256)
    np.testing.assert_array_equal(
        optim8bit._dequantize_signed(codes, scale, (n,)).numpy(),
        _np(jax_optim._dequantize_signed(jc, js, (n,))))
    codes, scale = optim8bit._quantize_sqrt(torch.from_numpy(x * x), 256)
    jc, js = jax_optim._quantize_sqrt(jnp.asarray(x * x), 256)
    np.testing.assert_array_equal(
        optim8bit._dequantize_sqrt(codes, scale, (n,)).numpy(),
        _np(jax_optim._dequantize_sqrt(jc, js, (n,))))


def test_packed_layouts_match_jax():
    rng = np.random.default_rng(1)
    signed = rng.integers(-127, 128, (1024, 256)).astype(np.int32)
    unsigned = rng.integers(0, 256, (1024, 256)).astype(np.int32)
    scale = rng.random(1024).astype(np.float32)
    for codes, is_signed in ((signed, True), (unsigned, False)):
        words = step.pack_moment_rows(torch.from_numpy(codes))
        want = _np(jax_step.pack_moment_rows(jnp.asarray(codes)))
        assert words.dtype == torch.int32
        np.testing.assert_array_equal(words.numpy(), want)
        np.testing.assert_array_equal(
            step.unpack_moment_rows(words, is_signed).numpy(), codes)
    tiled = step.pack_scale_rows(torch.from_numpy(scale))
    np.testing.assert_array_equal(
        tiled.numpy(), _np(jax_step.pack_scale_rows(jnp.asarray(scale))))
    np.testing.assert_array_equal(step.unpack_scale_rows(tiled).numpy(),
                                  scale)
    assert step.packable_rows(512) and not step.packable_rows(31)


class Leaves(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for name, val in params.items():
            self.register_parameter(name, torch.nn.Parameter(_t(val)))


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 0)
                  ).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(8)]
    return params, grads


def _jax_steps(tx, params, state, grads):
    for g in grads:
        u, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                             params)
        params = optax.apply_updates(params, u)
    return params, state


def _torch_steps(opt, model, grads):
    for g in grads:
        for name, p in model.named_parameters():
            p.grad = _t(g[name])
        opt.step()


def _assert_state_equal(model, opt, jax_state):
    """Every moment tensor bit-equal to JAX's, kind by kind."""
    mu, nu = jax_state.mu, jax_state.nu
    kinds = {}
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert st["count"] == int(jax_state.count)
        for key, tree in (("mu", mu), ("nu", nu)):
            want = tree[name]
            got_codes, got_scale = st[f"{key}_codes"], st[f"{key}_scale"]
            kinds.setdefault(name, got_codes.dtype)
            np.testing.assert_array_equal(got_codes.numpy(),
                                          _np(want.codes), err_msg=name)
            np.testing.assert_array_equal(got_scale.numpy(),
                                          _np(want.scale), err_msg=name)
    assert kinds == {"bias": torch.float32, "packed": torch.int32,
                     "odd": torch.int8}


@pytest.mark.parametrize("weight_decay", [None, 0.01])
def test_adam8bit_matches_optax_adam8bit(weight_decay):
    """Six steps from zero state: parameters, codes, words and scales bit
    for bit (the port repeats the reference's f32 arithmetic, including
    the f32 bias corrections; the JAX side runs op by op on the CPU)."""
    params, grads = _setup()
    tx = jax_adam8bit(1e-2, weight_decay=weight_decay)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    model = Leaves(params)
    opt = Adam8bit(model.parameters(), lr=1e-2, weight_decay=weight_decay)
    jstate = tx.init(jparams)
    for i in range(6):
        jparams, jstate = _jax_steps(tx, jparams, jstate, grads[i:i + 1])
        _torch_steps(opt, model, grads[i:i + 1])
        for name, p in model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          _np(jparams[name]),
                                          err_msg=f"step {i} {name}")
        _assert_state_equal(model, opt, jstate[0])


def test_adam8bit_from_converted_jax_state():
    """Both packages continue from one non-zero JAX state (three JAX steps,
    carried over by adam8bit_state_from_jax) for three more steps, bit for
    bit."""
    params, grads = _setup(seed=1)
    tx = jax_adam8bit(3e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jparams, jstate = _jax_steps(tx, jparams, tx.init(jparams), grads[:3])
    model = Leaves({k: _np(v) for k, v in jparams.items()})
    opt = Adam8bit(model.parameters(), lr=3e-3)
    numpy_state = jax.tree_util.tree_map(np.asarray, jstate[0])
    opt.load_state_dict(adam8bit_state_from_jax(numpy_state, opt, model))
    _assert_state_equal(model, opt, jstate[0])
    jparams, jstate = _jax_steps(tx, jparams, jstate, grads[3:6])
    _torch_steps(opt, model, grads[3:6])
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _np(jparams[name]))
    _assert_state_equal(model, opt, jstate[0])


def test_state_nbytes_matches_jax():
    params, grads = _setup()
    tx = jax_adam8bit(1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    _, jstate = _jax_steps(tx, jparams, tx.init(jparams), grads[:1])
    model = Leaves(params)
    opt = Adam8bit(model.parameters(), lr=1e-3)
    _torch_steps(opt, model, grads[:1])
    assert state_nbytes(opt) == jax_nbytes(jstate)


def _unpacked_case(n, count, seed=7):
    """tests/test_optim8bit.py:183's inputs: a leaf of n elements padded to
    whole blocks, random codes and scales in every row, bias corrections of
    step ``count``."""
    rng = np.random.default_rng(seed + n)
    g = (rng.standard_normal(n) * 0.02).astype(np.float32)
    nb = (n + jax_optim._pad_len(n, 256)) // 256
    g2d = np.zeros(nb * 256, np.float32)
    g2d[:n] = g
    return (g2d.reshape(nb, 256),
            rng.integers(-127, 128, (nb, 256)).astype(np.int8),
            (rng.random(nb) * 1e-3 + 1e-6).astype(np.float32),
            rng.integers(0, 256, (nb, 256)).astype(np.uint8),
            (rng.random(nb) * 1e-3 + 1e-6).astype(np.float32),
            np.float32(1.0 - 0.9 ** count), np.float32(1.0 - 0.999 ** count))


@pytest.mark.parametrize("n,count", [(8192, 1), (4096 * 3 + 100, 5)])
def test_unpacked_plain_matches_jax(n, count):
    """Kernel 13's plain version (the unpacked leaf's update on padded
    (nb, 256) blocks) bit for bit against the reference's XLA path of an
    unpacked leaf (training/optim8bit.py:258-265, op by op), and within
    the reference's own bounds of its Pallas kernel in interpret mode (one
    code step, scales to rtol 1e-6, updates to rtol 1e-5: that kernel
    divides by reciprocals, tests/test_optim8bit.py:171-223)."""
    g2d, mc, ms, vc, vs, bc1, bc2 = _unpacked_case(n, count)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    got = [t.numpy() for t in step.fused_adam8bit_update_plain(
        *map(_t, (g2d, mc, ms, vc, vs)), float(bc1), float(bc2), **kw)]
    jg = jnp.asarray(g2d)
    m = (0.9 * jax_optim._dequantize_signed(jnp.asarray(mc), jnp.asarray(ms),
                                            g2d.shape) + (1.0 - 0.9) * jg)
    v = (0.999 * jax_optim._dequantize_sqrt(jnp.asarray(vc), jnp.asarray(vs),
                                            g2d.shape)
         + (1.0 - 0.999) * jg * jg)
    upd = (m / bc1) / (jnp.sqrt(v / bc2) + 1e-8)
    want = [upd, *jax_optim._quantize_signed(m, 256),
            *jax_optim._quantize_sqrt(v, 256)]
    for name, a, b in zip(("update", "m codes", "m scales", "v codes",
                           "v scales"), got, want):
        assert a.dtype == _np(b).dtype, name
        np.testing.assert_array_equal(a, _np(b), err_msg=name)
    pallas = [_np(x) for x in jax_step.fused_adam8bit_update(
        jg, jnp.asarray(mc), jnp.asarray(ms), jnp.asarray(vc),
        jnp.asarray(vs), jnp.float32(bc1), jnp.float32(bc2), interpret=True,
        **kw)]
    for i in (1, 3):
        assert np.abs(got[i].astype(np.int32)
                      - pallas[i].astype(np.int32)).max() <= 1
    for i in (2, 4):
        np.testing.assert_allclose(got[i], pallas[i], rtol=1e-6)
    np.testing.assert_allclose(got[0], pallas[0], rtol=1e-5, atol=1e-6)


def _edge_state(nb, seed=3):
    """A packed leaf's g and state spread over f32's range: each row's
    magnitudes near an exponent of its own, so moments fall below 2^-40
    and above 2^40, v above 2^80 and below 2^-80, and rows' largest
    magnitudes outside [2^-50, 2^50] (the ranges outside which kernel 14
    leaves its fast paths), with zero rows, zero elements and rows of zero
    state.  (g, m codes, m scales, v codes, v scales), numpy."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-75, 53, (nb, 1)) + rng.integers(-6, 7, (nb, 256))
    g = (rng.standard_normal((nb, 256)) * np.exp2(e)).astype(np.float32)
    g[::5] = 0.0
    g[rng.random((nb, 256)) < 0.05] = 0.0
    mc = rng.integers(-127, 128, (nb, 256)).astype(np.int32)
    vc = rng.integers(0, 256, (nb, 256)).astype(np.int32)
    ms = (rng.random(nb) * np.exp2(rng.integers(-75, 53, nb))
          ).astype(np.float32)
    vs = (rng.random(nb) * np.exp2(rng.integers(-60, 41, nb))
          ).astype(np.float32)
    mc[::7] = 0
    vc[::7] = 0
    ms[::7] = 1.0
    vs[::7] = 1.0
    return g, mc, ms, vc, vs


def _packed_case(data, nb=1024):
    if data == "edge":
        return _edge_state(nb)
    if data == "zero":   # a leaf whose gradients the error taps flushed
        return (np.zeros((nb, 256), np.float32),
                np.zeros((nb, 256), np.int32), np.ones(nb, np.float32),
                np.zeros((nb, 256), np.int32), np.ones(nb, np.float32))
    rng = np.random.default_rng(11)
    return ((rng.standard_normal((nb, 256)) * 1e-3).astype(np.float32),
            rng.integers(-127, 128, (nb, 256)).astype(np.int32),
            (rng.random(nb) * 1e-4 + 1e-7).astype(np.float32),
            rng.integers(0, 256, (nb, 256)).astype(np.int32),
            (rng.random(nb) * 1e-4 + 1e-7).astype(np.float32))


def test_edge_state_reaches_every_slow_range():
    """The edge leaf has elements in each range where kernel 14 leaves its
    fast paths (its m and v, computed as the update computes them)."""
    g, mc, ms, vc, vs = _edge_state(1024)
    m = np.float32(0.9) * (mc * ms[:, None]).astype(np.float32) \
        + np.float32(1.0 - 0.9) * g
    root = (vc * vs[:, None]).astype(np.float32)
    v = np.float32(0.999) * (root * root) + np.float32(1.0 - 0.999) * (g * g)
    am = np.abs(m)
    for what, n in (("|m| in (0, 2^-40)", ((am > 0) & (am < 2.0 ** -40))),
                    ("|m| > 2^40", am > 2.0 ** 40),
                    ("v in (0, 2^-80)", (v > 0) & (v < 2.0 ** -80)),
                    ("v > 2^80", v > 2.0 ** 80),
                    ("a row's max |m| > 2^50", am.max(1) > 2.0 ** 50),
                    ("a row's max |m| in (0, 2^-50)",
                     (am.max(1) > 0) & (am.max(1) < 2.0 ** -50)),
                    ("a row's max v > 2^50", v.max(1) > 2.0 ** 50)):
        assert n.sum() > 0, what


@pytest.fixture
def flushed_subnormals():
    """f32 subnormals flushed to zero in torch's CPU arithmetic, as XLA's
    CPU backend (and the TPU) flushes them; the port's plain versions and
    kernels keep them, so the two differ only where a value is subnormal
    (ROADMAP C).  The flag is the calling thread's, so torch runs on this
    thread alone meanwhile."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("b1,b2,eps,count", [
    (0.9, 0.999, 1e-8, 1), (0.9, 0.999, 1e-8, 7), (0.9, 0.9999999, 1e-8, 1),
    (0.9, 0.999, 0.0, 1), (0.9, 0.999, 1e-45, 1)])
@pytest.mark.parametrize("data", ["random", "zero", "edge"])
def test_packed_step_matches_jax_at_the_edges(flushed_subnormals, data, b1,
                                              b2, eps, count):
    """The packed leaf's step as the port runs it on the CPU (kernel 14's
    plain version) bit for bit against the reference's XLA path of a
    packed leaf (training/optim8bit.py:203-217, through
    ``scale_by_adam8bit``'s update from the same state at count - 1):
    update, words and scales, pad rows too, NaN lanes compared as NaN.
    From random state, zeros and the edge leaf, at the usual constants,
    at a b2 whose first bias correction is below 2^-20, and at eps 0 and
    a subnormal eps (the cases where kernel 14 takes the intrinsics)."""
    g, mc, ms, vc, vs = _packed_case(data)
    tx = jax_optim.scale_by_adam8bit(b1=b1, b2=b2, eps=eps)
    state = jax_optim.ScaleByAdam8bitState(
        count=jnp.int32(count - 1),
        mu={"w": jax_optim._Moment8(jax_step.pack_moment_rows(jnp.asarray(mc)),
                                    jax_step.pack_scale_rows(jnp.asarray(ms)))},
        nu={"w": jax_optim._Moment8(jax_step.pack_moment_rows(jnp.asarray(vc)),
                                    jax_step.pack_scale_rows(jnp.asarray(vs)))})
    upd, new = tx.update({"w": jnp.asarray(g)}, state)
    want = (upd["w"], new.mu["w"].codes, new.mu["w"].scale,
            new.nu["w"].codes, new.nu["w"].scale)
    got = step.fused_adam8bit_update_packed(
        _t(g), step.pack_moment_rows(_t(mc)), step.pack_scale_rows(_t(ms)),
        step.pack_moment_rows(_t(vc)), step.pack_scale_rows(_t(vs)),
        *optim8bit.bias_corrections(b1, b2, count), b1=b1, b2=b2, eps=eps)
    for name, a, b in zip(("update", "m words", "m scales", "v words",
                           "v scales"), got, want):
        a, b = a.numpy(), _np(b)
        assert a.dtype == b.dtype, name
        both_nan = (np.isnan(a) & np.isnan(b) if a.dtype == np.float32
                    else np.zeros(a.shape, bool))
        assert ((a.view(np.int32) == b.view(np.int32)) | both_nan).all(), \
            name
