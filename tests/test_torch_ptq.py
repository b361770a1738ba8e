"""The paper's LLM post-training-quantization path in the port against the
JAX package, on the CPU: every spec string of the six presets
(quantize/presets.py) fake-quantized bit for bit, a 2-layer LLaMA's logits
under each preset, the functional MX and outlier ops, the NF and native-cast
roundings of kernel 11's plain version against the JAX tables, the
sliding-window perplexity, the safetensors reader, the LLaMA checkpoint
conversion and the wikitext script."""

import importlib.util
import json
import os
from pathlib import Path

# transformers would import TensorFlow too (seconds), which no test uses
os.environ.setdefault("USE_TF", "0")

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import transformers

from quantized_training_tpu.models import LlamaConfig as JaxLlamaConfig
from quantized_training_tpu.models import LlamaForCausalLM as JaxLlama
from quantized_training_tpu.models import hf_loader as jhf
from quantized_training_tpu import numerics as jnum
from quantized_training_tpu import quantize as jq
from quantized_training_tpu.qspec import QuantizationSpec as JaxSpec
from quantized_training_tpu.quantize.presets import (
    QUANTIZATION_CONFIGS as JAX_PRESETS, build_preset as jax_build_preset)
from quantized_training_tpu.utils.evaluation import (
    sliding_window_perplexity as jax_perplexity)

import quantized_training_torch as qt
from quantized_training_torch import numerics as tnum
from quantized_training_torch import quantize as tq
from quantized_training_torch.examples import wikitext as t_wikitext
from quantized_training_torch.models import hf_loader as thf
from quantized_training_torch.ops.quantize_elemwise import (
    quantize_elemwise_plain)
from quantized_training_torch.quantize.presets import (
    QUANTIZATION_CONFIGS, build_preset)
from quantized_training_torch.utils.evaluation import (
    sliding_window_perplexity)

REPO = Path(__file__).resolve().parent.parent
PRESETS = sorted(QUANTIZATION_CONFIGS)
SPECS = sorted({s for scopes in QUANTIZATION_CONFIGS.values()
                for pair in scopes.values() for s in pair if s})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    """Bit patterns of a bf16 or f32 array, every NaN one pattern."""
    a = np.asarray(a)
    itype = np.uint16 if a.dtype.itemsize == 2 else np.uint32
    b = a.view(itype).copy()
    b[np.isnan(a.astype(np.float32))] = 0
    return b


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _pair(x: np.ndarray, dtype: str):
    """The same values as a torch and a JAX array of ``dtype``."""
    if dtype == "bf16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return t, jnp.asarray(_to_np(t))
    return torch.from_numpy(x), jnp.asarray(x)


def test_presets_match_jax():
    assert sorted(JAX_PRESETS) == PRESETS == [
        "linear4", "linear4_matmul6", "linear4_matmul6_fp8",
        "linear4_matmul6_fp8_mixhead", "linear4_matmul6_fp8_outlier",
        "matmul4"]
    assert all(QUANTIZATION_CONFIGS[n] == JAX_PRESETS[n] for n in PRESETS)


# Each spec string of the presets on a (1, 64, 128) activation of the model
# below, at magnitudes from 0.01 to 30 per token (the outlier spec's
# threshold 4.0 splits the larger rows): with ax=-1 its blocks run along
# the features, with ax=-2 along the tokens.  (The JAX side compiles each
# spec once per shape and dtype, and the bf16 compilations serve the model
# test too.)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("spec", SPECS)
def test_preset_spec_fake_quant_bit_equal(spec, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 64, 128)).astype(np.float32)
    x *= np.exp(rng.uniform(np.log(0.01), np.log(30.0), (1, 64, 1))
                ).astype(np.float32)
    t, j = _pair(x, dtype)
    got, _ = tq.fake_quantize(t, qt.QuantizationSpec.from_str(spec))
    want, _ = jq.fake_quantize(j, JaxSpec.from_str(spec))
    bad = np.nonzero(_bits(_to_np(got)).ravel() != _bits(want).ravel())[0]
    assert bad.size == 0, bad[:8]


# ---- a 2-layer LLaMA under each preset ------------------------------------
# hidden 128 (two heads of 64, one kv head), so every 64-wide MX block is
# whole; the MLP and the vocabulary are as wide, so the weights have two
# shapes.  The port and JAX sum the matmuls in other orders: through no
# quantizer one logit of 8192 differs in its last bit, and a 4-bit site can
# turn such a difference into a code step.  Here five presets read
# bit-equal and matmul4 up to 0.0078 in 56 logits (|logits| up to 4.25);
# a 1-layer model at hidden 256 read up to 0.0156.  Tolerance 0.02 abs.
# It is a bound for this configuration, not for every one: with two kv
# heads matmul4 reads 0.047 in 208 logits, where its NF4 rounding of q, k,
# p and v meets more order differences (summing only the port's own dense
# layers in f64 instead of f32 moves its matmul4 logits by 0.0156 there;
# each site is bit-equal to JAX on equal inputs, the test above).
ARCH = dict(vocab_size=128, hidden_size=128, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
            max_position_embeddings=128)


@pytest.fixture(scope="module")
def llama_weights():
    jcfg = JaxLlamaConfig(**ARCH)
    ids = jnp.zeros((1, 64), jnp.int32)
    params = jax.jit(JaxLlama(jcfg, None).init)(jax.random.PRNGKey(0),
                                               ids)["params"]
    return params, qt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params))


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_logits_match_jax(preset, llama_weights):
    jparams, tparams = llama_weights
    ids = np.random.default_rng(1).integers(0, ARCH["vocab_size"], (1, 64))
    # jitted: the eager forward's bits under every preset, in less time
    want = np.asarray(jax.jit(JaxLlama(JaxLlamaConfig(**ARCH),
                                       jax_build_preset(preset)).apply)(
        {"params": jparams}, jnp.asarray(ids, jnp.int32)))
    model = qt.LlamaForCausalLM(qt.LlamaConfig(**ARCH), build_preset(preset),
                                device="cpu")
    model.load_state_dict(tparams)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))[0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02)


# ---- the functional MX and outlier ops ------------------------------------
def test_quantize_mx_matches_jax():
    """quantize_mx and calculate_mx_qparam as tests/test_fake_quant.py's
    TestMicroscaling exercises them: amax scales with and without an
    fp8_e5m3 scale codebook, power-of-two scales, a ragged last block."""
    x = (np.random.default_rng(2).standard_normal((4, 10)) * 3).astype(
        np.float32)
    for kw in (dict(), dict(force_scale_power_of_two=True),
               dict(scale_fmt="fp8_e5m3")):
        fmt = kw.pop("scale_fmt", None)
        ts, tv = tq.quantize_mx(torch.from_numpy(x), tnum.quantize_fn("int6"),
                                (-1,), 4, 31.0,
                                scale_qfn=tnum.quantize_fn(fmt) if fmt
                                else None, **kw)
        js, jv = jq.quantize_mx(jnp.asarray(x), jnum.quantize_fn("int6"),
                                (-1,), 4, 31.0,
                                scale_qfn=jnum.quantize_fn(fmt) if fmt
                                else None, **kw)
        assert ts.shape == (4, 3)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    out = tq.expand_scale(torch.tensor([[1.0, 2.0]]), (1, 6), 4)
    np.testing.assert_array_equal(out.numpy(),
                                  [[1.0, 1.0, 1.0, 1.0, 2.0, 2.0]])


def _mx_operands(rng, shape, block, axis):
    """NF4 codes and ``block``-wide block scales along ``axis``."""
    codes = rng.integers(0, 16, shape).astype(np.float32)
    sshape = list(shape)
    sshape[axis] = -(-shape[axis] // block)
    scale = rng.uniform(0.5, 2.0, sshape).astype(np.float32)
    return codes, scale


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_linear_matmul_conv_mx_match_jax(dtype):
    """The dequantize-then-compute ops on NF4 codes with block scales, and
    on plain values: the JAX suite has no test of them, so the JAX
    functions run directly on the same inputs."""
    rng = np.random.default_rng(5)
    cb = np.asarray(jnum.nf_codebook(4), np.float32)
    tcb, jcb = torch.from_numpy(cb.copy()), jnp.asarray(cb)
    rtol = 1e-2 if dtype == "bf16" else 1e-5

    def both(a):
        return _pair(np.ascontiguousarray(a), dtype)

    xc, xs = _mx_operands(rng, (3, 5, 128), 64, -1)
    wc, ws = _mx_operands(rng, (32, 128), 64, -1)
    bias = rng.standard_normal(32).astype(np.float32)
    (tx, jx), (tw, jw), (tb, jb) = both(xc), both(wc), both(bias)
    kw_t = dict(input_scale=torch.from_numpy(xs),
                weight_scale=torch.from_numpy(ws), block_size=64,
                input_codebook=tcb, weight_codebook=tcb)
    kw_j = dict(input_scale=jnp.asarray(xs), weight_scale=jnp.asarray(ws),
                block_size=64, input_codebook=jcb, weight_codebook=jcb)
    got = tq.linear_mx(tx, tw, tb, **kw_t)
    want = jq.linear_mx(jx, jw, jb, **kw_j)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol)

    ac, as_ = _mx_operands(rng, (2, 16, 128), 64, -1)
    bc, bs = _mx_operands(rng, (2, 128, 24), 64, -2)
    (ta, ja), (tb2, jb2) = both(ac), both(bc)
    got = tq.matmul_mx(ta, tb2, input_scale=torch.from_numpy(as_),
                       weight_scale=torch.from_numpy(bs), block_size=64,
                       input_codebook=tcb, weight_codebook=tcb)
    want = jq.matmul_mx(ja, jb2, input_scale=jnp.asarray(as_),
                        weight_scale=jnp.asarray(bs), block_size=64,
                        input_codebook=jcb, weight_codebook=jcb)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol)

    x = rng.standard_normal((2, 4, 9, 9)).astype(np.float32)
    w = rng.standard_normal((6, 2, 3, 3)).astype(np.float32)
    ws = rng.uniform(0.5, 2.0, (6, 2, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    (tx, jx), (tw, jw), (tb, jb), (tws, jws) = both(x), both(w), both(b), \
        both(ws)
    got = tq.conv2d_mx(tx, tw, tb, stride=2, padding=1, dilation=1, groups=2,
                       weight_scale=tws, block_size=1)
    want = jq.conv2d_mx(jx, jw, jb, stride=2, padding=1, dilation=1, groups=2,
                        weight_scale=jws, block_size=1)
    assert got.dtype == tx.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=rtol)


def test_outlier_ops_match_jax():
    """filter_outlier, outlier_matmul and to_csr as tests/test_fake_quant.py's
    TestOutlier exercises them, against the JAX functions."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 4, 64)) * 3).astype(np.float32)
    for a, b in zip(tq.filter_outlier(torch.from_numpy(x), 4.0),
                    jq.filter_outlier(jnp.asarray(x), 4.0)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, outlier = tq.filter_outlier(torch.from_numpy(x), 4.0)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    ws = rng.uniform(0.5, 2.0, (1, 16)).astype(np.float32)
    for kw in (dict(), dict(b_scale=ws, block_size=64),
               dict(weight_transposed=True)):
        wb = w.T.copy() if kw.get("weight_transposed") else w
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        got = tq.outlier_matmul(outlier, torch.from_numpy(wb), **tkw)
        want = jq.outlier_matmul(jnp.asarray(outlier.numpy()),
                                 jnp.asarray(wb), **jkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    dense = np.array([[0.0, 3.0, 0.0], [4.0, 0.0, 5.0]], np.float32)
    for arr, nnz in ((dense, 4), (outlier.numpy(), 7),
                     (np.arange(1, 7, dtype=np.float32).reshape(3, 2), 3)):
        for a, b in zip(tq.to_csr(torch.from_numpy(arr), nnz),
                        jq.to_csr(arr, nnz)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---- kernel 11's new forms: the plain versions against the JAX tables -----
@pytest.mark.parametrize("dtype", ["nf2", "nf3", "nf4", "nf4_6", "bfloat16",
                                   "float16"])
def test_nf_and_cast_plain_match_jax_lut(dtype):
    """Every bf16 pattern through kernel 11's plain version (what the
    kernel is held to on the card) against the JAX package's 2**16-entry
    table (codebook[indices] for the NF formats)."""
    universe = np.arange(2 ** 16, dtype=np.uint16)
    t = torch.from_numpy(universe.view(np.int16).copy()).view(torch.bfloat16)
    got = quantize_elemwise_plain(t, tnum.quantize_fn(dtype))
    table = jnum.get_quantization_map(dtype)
    if isinstance(table, tuple):
        indices, codebook = table
        table = np.asarray(codebook)[np.asarray(indices)]
    want = np.asarray(table).astype(ml_dtypes.bfloat16)
    bad = np.nonzero(_bits(_to_np(got)) != _bits(want))[0]
    assert bad.size == 0, [hex(int(i)) for i in bad[:8]]


# ---- sliding-window perplexity --------------------------------------------
@pytest.mark.parametrize("n,max_length,stride", [(300, 64, 32), (200, 48, 40),
                                                 (40, 64, 32)])
def test_sliding_window_perplexity_matches_jax(n, max_length, stride):
    """Several windows (the last ones overlapping by max_length - stride,
    the tail after the last full window dropped) and a stream shorter than
    one window, through the same logits function in both packages."""
    rng = np.random.default_rng(n)
    table = (rng.standard_normal((97, 97)) * 2).astype(np.float32)
    ids = rng.integers(0, 97, n)
    tt, jt = torch.from_numpy(table), jnp.asarray(table)
    got = sliding_window_perplexity(lambda w: tt[w], ids, max_length, stride,
                                    device="cpu")
    want = jax_perplexity(lambda w: jt[w], ids, max_length, stride)
    assert got == pytest.approx(want, rel=1e-6)


# ---- checkpoints ----------------------------------------------------------
def test_load_state_dict_dir_reads_safetensors_files(tmp_path):
    """Shards written by the safetensors package (F32, BF16 and F16, a
    scalar, an empty tensor, metadata) read back bit for bit."""
    from safetensors.torch import save_file
    rng = np.random.default_rng(7)
    shards = [
        {"a.weight": torch.from_numpy(rng.standard_normal((5, 3)).astype(
            np.float32)),
         "b.bias": torch.from_numpy(rng.standard_normal(7).astype(
             np.float32)).to(torch.bfloat16)},
        {"c.weight": torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(
            np.float32)).to(torch.float16),
         "d.scalar": torch.tensor(1.5),
         "e.empty": torch.zeros((0, 4))},
    ]
    for i, shard in enumerate(shards):
        save_file(shard, str(tmp_path / f"model-{i:05d}.safetensors"),
                  metadata={"format": "pt"})
    (tmp_path / "notes.txt").write_text("not a shard")
    got = thf.load_state_dict_dir(str(tmp_path))
    want = {k: v for shard in shards for k, v in shard.items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        thf.load_state_dict_dir(str(tmp_path / "empty"))


def _hf_llama(tie=False):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        tie_word_embeddings=tie, attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


@pytest.fixture(scope="module")
def hf_llama():
    return _hf_llama()


@pytest.mark.parametrize("fused", [False, True])
def test_convert_llama_bit_equal_to_jax(fused, hf_llama):
    """convert_llama then maybe_fuse_qkv on a random-config HF model, in
    both packages: the same names and bits (the JAX tree flattened to the
    port's state-dict names)."""
    state = hf_llama.state_dict()
    arch = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, fused_qkv=fused)
    want = qt.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jhf.maybe_fuse_qkv(jhf.convert_llama(state, 2),
                                       JaxLlamaConfig(**arch))))
    got = thf.maybe_fuse_qkv(thf.convert_llama(state, 2),
                             qt.LlamaConfig(**arch))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    model = qt.LlamaForCausalLM(qt.LlamaConfig(**arch), device="cpu")
    model.load_state_dict(got)
    tied = thf.convert_llama(_hf_llama(tie=True).state_dict(), 2,
                             tie_word_embeddings=True)
    assert "lm_head.kernel" not in tied


def test_wikitext_script_matches_jax(tmp_path, capsys, hf_llama):
    """The port's script with --device cpu on a tiny checkpoint and a .npy
    token stream, no qconfig: its perplexity equals the JAX script's
    load_model with JAX's sliding_window_perplexity on the same files."""
    hf_llama.save_pretrained(tmp_path / "ckpt", safe_serialization=True)
    ids = np.random.default_rng(8).integers(0, 128, 300)
    np.save(tmp_path / "tokens.npy", ids)
    t_wikitext.main(["--model_path", str(tmp_path / "ckpt"), "--token_file",
                     str(tmp_path / "tokens.npy"), "--max_length", "64",
                     "--stride", "32", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"perplexity": line["perplexity"], "activation": None,
                    "weight": None, "quantize_forward": None,
                    "max_length": 64, "stride": 32}

    spec = importlib.util.spec_from_file_location(
        "jax_wikitext", REPO / "examples" / "wikitext.py")
    jw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jw)
    model, params, _ = jw.load_model(str(tmp_path / "ckpt"), None, False)
    want = jax_perplexity(lambda w: model.apply({"params": params}, w),
                          np.load(tmp_path / "tokens.npy"), 64, 32)
    assert line["perplexity"] == pytest.approx(want, rel=1e-3)
    if not torch.cuda.is_available():
        # the script runs on CUDA unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            t_wikitext.main(["--model_path", str(tmp_path / "ckpt"),
                             "--token_file", str(tmp_path / "tokens.npy")])
