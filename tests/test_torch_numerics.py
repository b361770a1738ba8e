"""The port's quantizers against the JAX package's, bit for bit, over every
bf16 bit pattern (the reference's LUT key space), on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from quantized_training_tpu import numerics as jnum
from quantized_training_torch import numerics as tnum

FORMATS = ["int8", "int4", "uint4", "uint8", "e4m3", "e5m2", "fp8.e4m3",
           "fp8_e4m3", "fp8_e5m2", "fp6_e3m2", "fp6_e2m3", "fp4_e2m1",
           "fp8_e5m3", "posit8_1", "posit16_1", "posit8_0", "posit8_2",
           "posit6_1", "nf4", "nf4_6", "bfloat16", "float16"]

_ALL = np.arange(2 ** 16, dtype=np.uint16)


def _bits(t: torch.Tensor) -> np.ndarray:
    """bf16 tensor -> uint16 patterns, every NaN mapped to one pattern."""
    b = t.view(torch.int16).numpy().view(np.uint16).copy()
    b[torch.isnan(t.float()).numpy()] = 0x7FC0
    return b


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    b = a.view(np.uint16).copy()
    b[np.isnan(a.astype(np.float32))] = 0x7FC0
    return b


def _universe():
    return (torch.from_numpy(_ALL.view(np.int16).copy()).view(torch.bfloat16),
            jnp.asarray(_ALL.view(ml_dtypes.bfloat16)))


@pytest.mark.parametrize("dtype", FORMATS)
def test_quantize_fn_bit_equal_over_all_bf16(dtype):
    t, j = _universe()
    got = _bits(tnum.quantize_fn(dtype)(t))
    want = _jbits(jnum.quantize_fn(dtype)(j))
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (
        f"{dtype}: {bad.size} lanes differ, first patterns "
        f"{[hex(int(i)) for i in bad[:8]]}")


@pytest.mark.parametrize("dtype", ["posit8_1", "posit16_1", "e4m3", "int8"])
def test_positive_and_unit_forms_bit_equal_on_their_domains(dtype):
    t, j = _universe()
    f = t.float()
    pos = torch.isfinite(f) & (f >= 0) & ~torch.signbit(f)
    unit = pos & (f <= 1)
    for tf, jf, keep in ((tnum.quantize_fn_positive, jnum.quantize_fn_positive,
                          pos),
                         (tnum.quantize_fn_unit, jnum.quantize_fn_unit, unit)):
        idx = torch.nonzero(keep).flatten()
        got = _bits(tf(dtype)(t[idx]))
        want = _jbits(jf(dtype)(j[idx.numpy()]))
        np.testing.assert_array_equal(got, want)
        # and each equals the general quantizer there
        np.testing.assert_array_equal(got, _bits(tnum.quantize_fn(dtype)(t[idx])))


def test_posit_forms_agree_with_reference_shape():
    t, _ = _universe()
    fin = torch.isfinite(t.float())
    for nbits, es in ((8, 1), (16, 1), (8, 0), (8, 2)):
        ref = tnum.quantize_to_posit(t[fin], nbits, es)
        fast = tnum.quantize_to_posit_fast(t[fin], nbits, es)
        np.testing.assert_array_equal(_bits(fast), _bits(ref))


@pytest.mark.parametrize("nbits,es", [(8, 1), (8, 0), (16, 1)])
def test_encode_decode_posit_match_jax(nbits, es):
    t, j = _universe()
    got = tnum.encode_posit(t, nbits, es).numpy()
    want = np.asarray(jnum.encode_posit(j, nbits, es))
    np.testing.assert_array_equal(got, want)
    codes = np.arange(-(1 << (nbits - 1)), 1 << (nbits - 1),
                      dtype=np.int32)[:: max(1, (1 << nbits) // 4096)]
    got = tnum.decode_posit(torch.from_numpy(codes), nbits, es).numpy()
    want = np.asarray(jnum.decode_posit(jnp.asarray(codes), nbits, es))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("mode", ["floor", "nearest", "even", "dither"])
@pytest.mark.parametrize("src", ["bfloat16", "float32"])
def test_quantize_elemwise_rounding_modes(mode, src):
    """The generic fp quantizer's four modes on fixed inputs; dither gets
    one noise tensor on both sides."""
    import jax
    from quantized_training_tpu.numerics import fp8 as jfp8
    from quantized_training_torch.numerics import fp8 as tfp8

    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 4).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, np.nan]
    noise = rng.random(4096).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, src))
    jx = jnp.asarray(x, getattr(jnp, src))
    got = tfp8.quantize_elemwise(tx, 5, 3, 15.0, round_mode=mode,
                                 noise=torch.from_numpy(noise))
    if mode == "dither":
        orig = jax.random.uniform
        jax.random.uniform = lambda key, shape, dtype: jnp.asarray(noise)
        try:
            want = jfp8.quantize_elemwise(jx, 5, 3, 15.0, round_mode=mode,
                                          key=jax.random.PRNGKey(0))
        finally:
            jax.random.uniform = orig
    else:
        want = jfp8.quantize_elemwise(jx, 5, 3, 15.0, round_mode=mode)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_luts_and_shared_exponents_match_jax():
    t, j = _universe()
    for dtype in ("posit8_1", "e4m3", "int4"):
        tmap = tnum.get_quantization_map(dtype)
        jmap = jnum.get_quantization_map(dtype)
        np.testing.assert_array_equal(_bits(tmap), _jbits(jmap))
        rng = np.random.default_rng(1)
        x = rng.standard_normal(2048).astype(np.float32)
        got = tnum.apply_lut(torch.from_numpy(x), tmap).numpy()
        want = np.asarray(jnum.apply_lut(jnp.asarray(x), jmap))
        np.testing.assert_array_equal(got, want)
    ti, tc = tnum.get_quantization_map("nf4")
    ji, jc = jnum.get_quantization_map("nf4")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc, np.float32))
    x = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)
    x[0, :5] = [0.0, 1e-42, 3e38, -2.0 ** -130, 2.0 ** 20]
    for ebits in (0, 8):
        got = tnum.shared_exponents(torch.from_numpy(x), axes=[1], ebits=ebits)
        want = jnum.shared_exponents(jnp.asarray(x), axes=[1], ebits=ebits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_dispatch_raises_off_cpu():
    """A rounding on any device but the CPU goes to a kernel or raises: a
    meta tensor never reaches the plain code."""
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    for dtype in ("posit8_1", "e4m3", "int8", "nf4"):
        with pytest.raises(ValueError, match="no rounding kernel"):
            tnum.quantize_fn(dtype)(x)
    assert tnum.quantize_fn("posit8_1").fmt.kind == "posit"
    assert tnum.quantize_fn("nf4").fmt is None
