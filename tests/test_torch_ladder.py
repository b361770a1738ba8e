"""The port's posit8 fusion ladder (bench.py's forward) against the JAX
package on the CPU: logits at every FUSION_LADDER rung on a shrunk bench.py
configuration, bit for bit, with the flash path at residual_fusion in both
packages; that the comparison catches one dropped rounding site; and the
quantization-site multiset per rung against tests/golden/ladder_sites.json
(read, never written)."""

import json
import re
from collections import Counter
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import quantized_training_tpu.numerics as jax_numerics
from quantized_training_tpu.models import LlamaConfig as JaxLlamaConfig
from quantized_training_tpu.models import LlamaForCausalLM as JaxLlama
from quantized_training_tpu.ops.pallas import flash_attention as jax_fa_mod
from quantized_training_tpu.quantize import FUSION_LADDER as JAX_LADDER
from quantized_training_tpu.quantize import QConfig as JaxQConfig
from quantized_training_tpu.quantize import QuantConfig as JaxQuantConfig
from quantized_training_tpu.quantize import fold_quantized_weights as jax_fold
from quantized_training_tpu.quantize import strip_weight_specs as jax_strip

import quantized_training_torch as qt
from quantized_training_torch.models import llama as t_llama
from quantized_training_torch.numerics import lut as t_lut

GOLDEN = Path(__file__).parent / "golden" / "ladder_sites.json"

# bench.py's configuration shrunk: 2 heads keep head_dim 128, so the flash
# gate (D % 128 == 0 and S % 128 == 0) passes at S = 128
ARCH = dict(vocab_size=1024, hidden_size=256, intermediate_size=688,
            num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
            max_position_embeddings=128, use_flash_attention=True)
B, S = 2, 128


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the tier-1 run puts several test processes on the
    cores, and the port's side of these tests is many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qc(pkg_qconfig, pkg_quantconfig, cats):
    return pkg_quantconfig(global_qconfig=pkg_qconfig.from_strs(
        activation="posit8_1", weight="posit8_1")).with_fusion(forward=cats)


@pytest.fixture(scope="module")
def weights():
    """bench.py's weight step in both packages: JAX init, fold at the
    posit8_1 weight spec (compiled as one program: on the CPU its bits are
    the eager fold's, and a tenth of its time); the port folds its own copy
    of the init."""
    jcfg = JaxLlamaConfig(**ARCH)
    ids = jnp.zeros((1, S), jnp.int32)
    params = jax.jit(JaxLlama(jcfg, None).init)(jax.random.PRNGKey(0),
                                               ids)["params"]
    rung = dict(JAX_LADDER)["residual_fusion"]
    jqc = _qc(JaxQConfig, JaxQuantConfig, rung)
    jfold = jax.jit(lambda p: jax_fold(p, jqc))(params)
    tfold = qt.fold_quantized_weights(
        qt.params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
        _qc(qt.QConfig, qt.QuantConfig, [c.value for c in rung]))
    return jfold, tfold


def _ids():
    return np.random.default_rng(0).integers(0, ARCH["vocab_size"], (B, S))


def _stripped(rung):
    cats = dict(JAX_LADDER)[rung]
    return (jax_strip(_qc(JaxQConfig, JaxQuantConfig, cats)),
            qt.strip_weight_specs(_qc(qt.QConfig, qt.QuantConfig,
                                      [c.value for c in cats])))


def _jax_logits(jfold, jqc):
    return np.asarray(JaxLlama(JaxLlamaConfig(**ARCH), jqc).apply(
        {"params": jfold}, jnp.asarray(_ids(), jnp.int32)))


@pytest.fixture(scope="module")
def jax_rungs():
    """The reference's logits per rung, as each rung's test computed them
    (under the general unit rounding), shared with the later tests of the
    same rung."""
    return {}


def _port_logits(tfold, tqc):
    model = qt.LlamaForCausalLM(qt.LlamaConfig(**ARCH), tqc, device="cpu")
    model.load_state_dict(tfold)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(_ids()))
    return got.numpy()


@pytest.mark.parametrize("rung", [r for r, _ in JAX_LADDER])
def test_ladder_logits_match_jax(weights, jax_rungs, rung, monkeypatch):
    """Bit-equal logits: the port rounds at the same sites, in the same
    order, with the same f32 products as the reference."""
    jfold, tfold = weights
    jqc, tqc = _stripped(rung)
    calls = Counter()

    def counting(module, name):
        inner = getattr(module, name)

        def wrapped(*a, **k):
            calls[module.__name__] += 1
            return inner(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    counting(jax_fa_mod, "flash_attention")
    counting(t_llama, "flash_attention")
    # Under jit on the CPU, the reference's multiplication-form unit
    # rounding (quantize_fn_unit, the flash path's p_qfn) returns 1028 of
    # the 16257 bf16 values in [0, 1] unrounded (ROADMAP C); its general
    # form gives the values the unit form is specified to give there.
    monkeypatch.setattr(jax_numerics, "quantize_fn_unit",
                        jax_numerics.quantize_fn)

    want = jax_rungs[rung] = _jax_logits(jfold, jqc)
    got = _port_logits(tfold, tqc)
    np.testing.assert_array_equal(got, want)
    flash = 2 if rung in ("activation_fusion", "layernorm_fusion",
                          "residual_fusion") else 0
    assert calls[jax_fa_mod.__name__] == flash, calls
    assert calls[t_llama.__name__] == flash, calls


class DroppingQuantConfig:
    """The port's QuantConfig with the activation rounding at one path
    removed: a port that skips that site."""

    def __init__(self, inner, path):
        self.inner, self.path = inner, path

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def activation_spec(self, path, op, category, index=0):
        if path == self.path:
            return None
        return self.inner.activation_spec(path, op, category, index)


@pytest.mark.parametrize("site", [
    "lm_head", "model.layers_1.mlp.down_proj",
    "model.layers_0.self_attn.o_proj", "flash p"])
def test_ladder_comparison_catches_a_dropped_site(weights, jax_rungs, site,
                                                  monkeypatch):
    """At residual_fusion, a port that skips one rounding site (a GEMM
    input, the o_proj rounding in the flash epilogue, or the flash
    probabilities) no longer matches the reference (its logits from the
    residual_fusion rung's test where that ran first)."""
    jfold, tfold = weights
    monkeypatch.setattr(jax_numerics, "quantize_fn_unit",
                        jax_numerics.quantize_fn)
    jqc, tqc = _stripped("residual_fusion")
    if site == "flash p":
        monkeypatch.setattr(t_llama, "quantize_fn_unit", lambda dtype: None)
    else:
        tqc = DroppingQuantConfig(tqc, site)
    want = jax_rungs.get("residual_fusion")
    if want is None:
        want = jax_rungs["residual_fusion"] = _jax_logits(jfold, jqc)
    got = _port_logits(tfold, tqc)
    assert not np.array_equal(got, want)


# --- quantization-site placement against the golden ----------------------

class RecordingQuantConfig:
    """The recording proxy of tests/test_ladder_golden.py:37-73, around the
    port's QuantConfig."""

    def __init__(self, inner):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "sites", Counter())

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @staticmethod
    def _norm(path: str) -> str:
        return re.sub(r"(layers[_/.])\d+", r"\1*", path or "")

    def _rec(self, kind, path, op, cat, idx, resolved):
        if resolved:
            self.sites[f"{kind}:{self._norm(path)}:{op}:{cat}:{idx}"] += 1

    def activation_spec(self, path, op, category, index=0):
        spec = self.inner.activation_spec(path, op, category, index)
        self._rec("act", path, op, category.value, index, spec is not None)
        return spec

    def error_spec(self, path, op, category, index=0):
        spec = self.inner.error_spec(path, op, category, index)
        self._rec("err", path, op, category.value, index, spec is not None)
        return spec

    def weight_spec(self, path, op="linear"):
        spec = self.inner.weight_spec(path, op)
        self._rec("weight", path, op, "-", 0, spec is not None)
        return spec

    def bias_spec(self, path, op="linear"):
        spec = self.inner.bias_spec(path, op)
        self._rec("bias", path, op, "-", 0, spec is not None)
        return spec


def _golden_configs():
    """tests/test_ladder_golden.py's two configurations."""
    bench = qt.LlamaConfig(vocab_size=1024, hidden_size=256,
                           intermediate_size=688, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=4,
                           max_position_embeddings=128,
                           use_flash_attention=True)
    llama7b = replace(qt.LlamaConfig.llama2_7b(), num_hidden_layers=2,
                      vocab_size=1024, max_position_embeddings=128)
    return {"bench_stack": bench, "llama7b": llama7b}


def _cases():
    out = [(m, rung, [c.value for c in cats], ())
           for m in ("bench_stack", "llama7b") for rung, cats in JAX_LADDER]
    out += [(m, "backward_gemm_residual", ["gemm"], ["gemm", "residual"])
            for m in ("bench_stack", "llama7b")]
    return out


@pytest.mark.parametrize("model_name,rung,fwd,bwd", _cases())
def test_site_multiset_matches_golden(model_name, rung, fwd, bwd,
                                      monkeypatch):
    """One forward's site decisions, doubled (the golden counts the init
    and the apply trace), on the meta device: the values do not matter
    here, so every rounding is the identity."""
    monkeypatch.setattr(t_lut.QuantFn, "__call__", lambda self, x: x)
    cfg = _golden_configs()[model_name]
    qc = qt.QuantConfig(global_qconfig=qt.QConfig.from_strs(
        activation="posit8_1", weight="posit8_1", error="posit8_1"),
    ).with_fusion(forward=fwd, backward=bwd)
    rec = RecordingQuantConfig(qc)
    model = qt.LlamaForCausalLM(cfg, rec, device="meta")
    model(torch.zeros((1, 16), dtype=torch.long, device="meta"))
    got = {k: 2 * n for k, n in sorted(rec.sites.items())}
    want = json.loads(GOLDEN.read_text())[f"{model_name}/{rung}"]
    assert got == want
