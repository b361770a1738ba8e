"""The port's BERT fine-tuning slice against the JAX package on the CPU, at
BertConfig.tiny (2 layers, hidden 64): HF checkpoint conversion, the
classification logits in float and under run_quantized_training.py's
posit8 ``bert_base`` recipe (bit for bit), the LoRA adapters, QLoRADense
and the derived-scale bias quantization, the command-line qspec flags of
every DTYPE_MATRIX arm, and three make_train_step + Adam8bit steps.

The reference runs module by module here: under jit, XLA keeps f32 sums
where the model code asks for bf16 ones (excess precision) -- the pooler's
and the classifier's bias adds, whose consumers convert to f32, and, in
float, adds inside the encoder (ROADMAP C) -- and the port computes what
the code asks for.  So the float model runs op by op, and the posit8
model's modules are jitted one by one, the dtype conversions between them
outside: a jit boundary rounds its outputs, and the posit8 rounding sites
pin every value inside."""

import argparse
from functools import lru_cache, partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import run_quantized_training as launcher
from quantized_training_tpu import cli as jax_cli
from quantized_training_tpu.models import bert as jbert
from quantized_training_tpu.models import hf_loader as jhf
from quantized_training_tpu.models import layers as jlayers
from quantized_training_tpu.quantize import QConfig as JaxQConfig
from quantized_training_tpu.quantize import QuantConfig as JaxQuantConfig
from quantized_training_tpu.training import adam8bit as jax_adam8bit
from quantized_training_tpu.training import \
    classification_loss as jax_classification_loss

import quantized_training_torch as qt
from quantized_training_torch import cli as torch_cli
from quantized_training_torch.convert import _flatten
from quantized_training_torch.models import layers as tlayers
from quantized_training_torch.training import (Adam8bit, classification_loss,
                                               make_train_step)

CFG = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           max_position_embeddings=64, type_vocab_size=2)
B, S = 2, 16
# run_quantized_training.py's bert_base row with DTYPE_MATRIX["posit8"], and
# the LoRA targets its table means (its comma list matches nothing)
POSIT8 = dict(activation="posit8_1", weight="posit8_1",
              error="posit8_1,qs=per_tensor_symmetric,qmax=64,ahl=10")
OPS = "gemm,residual,layernorm,activation"
LORA = (8, 8.0, (r"\.(query|value)$",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qcs(quantized, lora=True):
    """(JAX QuantConfig, port QuantConfig) of the recipe, or (None, None)."""
    if not quantized:
        return None, None
    out = []
    for qc_cls, q_cls in ((JaxQuantConfig, JaxQConfig),
                          (qt.QuantConfig, qt.QConfig)):
        qc = qc_cls(global_qconfig=q_cls.from_strs(**POSIT8)).with_fusion(
            forward=OPS, backward=OPS)
        out.append(qc.with_lora(*LORA) if lora else qc)
    return tuple(out)


def _batch(seed=0):
    """input_ids, token_type_ids (two segments), an attention mask of seeded
    lengths and labels, as numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, S))
    tt = np.broadcast_to((np.arange(S) >= S // 2).astype(np.int64), (B, S))
    lens = rng.integers(S // 2, S + 1, B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int64)
    return dict(input_ids=ids, attention_mask=mask,
                token_type_ids=np.ascontiguousarray(tt),
                labels=rng.integers(0, 2, B))


def _hf_state(seed=1):
    """A random HF BertForSequenceClassification state dict (numpy), with
    non-trivial biases and LayerNorm parameters."""
    rng = np.random.default_rng(seed)
    H, I = CFG["hidden_size"], CFG["intermediate_size"]
    st = {}

    def lin(name, fin, fout):
        st[f"{name}.weight"] = (rng.standard_normal((fout, fin))
                                / np.sqrt(fin)).astype(np.float32)
        st[f"{name}.bias"] = (rng.standard_normal(fout) * 0.1).astype(
            np.float32)

    def norm(name):
        st[f"{name}.weight"] = (1 + rng.standard_normal(H) * 0.1).astype(
            np.float32)
        st[f"{name}.bias"] = (rng.standard_normal(H) * 0.1).astype(np.float32)

    for name, n in (("word", CFG["vocab_size"]),
                    ("position", CFG["max_position_embeddings"]),
                    ("token_type", CFG["type_vocab_size"])):
        st[f"bert.embeddings.{name}_embeddings.weight"] = (
            rng.standard_normal((n, H)) * 0.5).astype(np.float32)
    norm("bert.embeddings.LayerNorm")
    for i in range(CFG["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            lin(f"{p}.attention.self.{proj}", H, H)
        lin(f"{p}.attention.output.dense", H, H)
        norm(f"{p}.attention.output.LayerNorm")
        lin(f"{p}.intermediate.dense", H, I)
        lin(f"{p}.output.dense", I, H)
        norm(f"{p}.output.LayerNorm")
    lin("bert.pooler.dense", H, H)
    lin("classifier", H, 2)
    return st


def _lora_params(tree, seed=2):
    """``tree`` (nested numpy params) with random lora_a and non-zero
    lora_b on every query and value projection."""
    rng = np.random.default_rng(seed)
    H, r = CFG["hidden_size"], LORA[0]
    for i in range(CFG["num_hidden_layers"]):
        for proj in ("query", "value"):
            node = tree["bert"][f"layer_{i}"]["attention_self"][proj]
            node["lora_a"] = (rng.standard_normal((H, r)) * 0.02).astype(
                np.float32)
            node["lora_b"] = (rng.standard_normal((r, H)) * 0.02).astype(
                np.float32)
    return tree


def _jax_params(lora):
    tree = jax.tree_util.tree_map(
        np.asarray, jhf.convert_bert(_hf_state(), CFG["num_hidden_layers"]))
    return _lora_params(tree) if lora else tree


@lru_cache(maxsize=None)
def _jax_parts(quantized):
    """The reference's embeddings, encoder layer, pooler dense and
    classifier, each jitted under the posit8 recipe (a jit boundary
    rounds its outputs to bf16, and the encoder's rounding sites pin its
    values; the two layers share one compiled function) and op by op in
    float."""
    cfg, jqc = jbert.BertConfig(**CFG), _qcs(quantized)[0]
    emb, layer = jbert.BertEmbeddings(cfg, jqc), jbert.BertLayer(cfg, jqc)
    pooler = jlayers.QDense(CFG["hidden_size"], qconfig=jqc)
    head = jlayers.QDense(2, qconfig=jqc)
    wrap = jax.jit if quantized else (lambda fn: fn)
    return (wrap(lambda p, ids, tt: emb.apply({"params": p}, ids, tt)),
            wrap(lambda p, h, mask: layer.apply({"params": p}, h, mask)),
            wrap(lambda p, x: pooler.apply({"params": p}, x)),
            wrap(lambda p, x: head.apply({"params": p}, x)))


def _jax_logits(params, batch, quantized):
    """The reference's BertForSequenceClassification (models/bert.py:
    139-175, 220-234), its dtype conversions outside the jitted parts."""
    embed, layer, pooler, head = _jax_parts(quantized)
    bert = params["bert"]
    mask = jbert.extended_attention_mask(jnp.asarray(batch["attention_mask"]))
    hidden = embed(bert["embeddings"], jnp.asarray(batch["input_ids"]),
                   jnp.asarray(batch["token_type_ids"]))
    for i in range(CFG["num_hidden_layers"]):
        hidden = layer(bert[f"layer_{i}"], hidden, mask)
    pooled = pooler(bert["pooler_dense"], hidden[:, 0])
    pooled = jnp.tanh(pooled.astype(jnp.float32)).astype(hidden.dtype)
    return head(params["classifier"], pooled).astype(jnp.float32)


def _port_model(params, quantized, lora=True):
    tm = qt.BertForSequenceClassification(
        qt.BertConfig(**CFG), _qcs(quantized, lora)[1], device="cpu")
    tm.load_state_dict(qt.params_from_jax(params))
    return tm


def _port_inputs(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(batch[k]))
                 for k in ("input_ids", "attention_mask", "token_type_ids"))


def test_convert_bert_matches_jax():
    """convert_bert maps one HF state dict to the JAX package's params,
    name for name and bit for bit, and fills the port model's state dict."""
    st = _hf_state()
    got = qt.convert_bert(st, CFG["num_hidden_layers"])
    want = qt.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jhf.convert_bert(st, CFG["num_hidden_layers"])))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want[name].numpy(), name)
    tm = qt.BertForSequenceClassification(qt.BertConfig(**CFG), None,
                                          device="cpu")
    assert sorted(tm.state_dict()) == sorted(got)


@pytest.mark.parametrize("quantized", [False, True])
def test_logits_match_jax(quantized):
    """The classification logits bit for bit, in float and under the posit8
    bert_base recipe with LoRA (every site rounded, adapters non-zero)."""
    params = _jax_params(lora=quantized)
    batch = _batch()
    if quantized:      # the compiled functions of the train step's test
        want = np.asarray(_jax_value_and_grad(params, batch)[0][1])
    else:
        want = np.asarray(_jax_logits(params, batch, quantized))
    got = _port_model(params, quantized)(*_port_inputs(batch))
    assert got.dtype == torch.float32 and got.shape == (B, 2)
    np.testing.assert_array_equal(got.detach().numpy(), want)


def test_lora_targets_and_zero_adapter():
    """LoRA params exist only on the query and value projections, as the
    reference's init makes them; with lora_b = 0 the adapted model's
    logits equal the lora-free model's (tests/test_training.py:72-90)."""
    jqc = _qcs(True)[0]
    jm = jbert.BertForSequenceClassification(jbert.BertConfig(**CFG), jqc)
    batch = _batch()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(batch[k]) for k in (
                                "input_ids", "attention_mask",
                                "token_type_ids")))
    jax_lora = sorted(n for n in _flatten(shapes["params"])
                      if n.endswith(("lora_a", "lora_b")))
    params = _jax_params(lora=True)
    tm = _port_model(params, True)
    port_lora = sorted(n for n, _ in tm.named_parameters()
                       if n.endswith(("lora_a", "lora_b")))
    assert port_lora == jax_lora
    assert len(port_lora) == 2 * 2 * CFG["num_hidden_layers"]
    assert all(".query." in n or ".value." in n for n in port_lora)
    for i in range(CFG["num_hidden_layers"]):
        for proj in ("query", "value"):
            params["bert"][f"layer_{i}"]["attention_self"][proj][
                "lora_b"] *= 0
    inputs = _port_inputs(batch)
    adapted = _port_model(params, True)(*inputs)
    plain = _port_model(_jax_params(lora=False), True, lora=False)(*inputs)
    np.testing.assert_array_equal(adapted.detach().numpy(),
                                  plain.detach().numpy())


def test_qlora_dense_matches_jax():
    """QLoRADense under a posit8 weight spec: A and B rounded, the merged
    weight rounded again, the input rounded; bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    p = dict(kernel=rng.standard_normal((32, 24)) / 6,
             lora_a=rng.standard_normal((32, 4)) * 0.3,
             lora_b=rng.standard_normal((4, 24)) * 0.3,
             bias=rng.standard_normal(24) * 0.1)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    qcs = [cls(global_qconfig=q.from_strs(activation="posit8_1",
                                          weight="posit8_1"))
           for cls, q in ((JaxQuantConfig, JaxQConfig),
                          (qt.QuantConfig, qt.QConfig))]
    jm = jlayers.QLoRADense(24, lora_rank=4, lora_alpha=8.0, qconfig=qcs[0])
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(x, jnp.bfloat16))
    tm = tlayers.QLoRADense(32, 24, lora_rank=4, lora_alpha=8.0,
                            qconfig=qcs[1], device="cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    got = tm(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_derived_bias_quantization_matches_jax():
    """A bias spec quantizes the bias at act_scale * weight_scale, read from
    the layer's own per-tensor observers after this call's observation
    (the reference observes once at init, with its init weights: the port
    runs those and the init input first).  Bit for bit, and the bias
    rounding changes the output."""
    rng = np.random.default_rng(4)
    x0, x1 = (rng.standard_normal((4, 16)).astype(np.float32)
              for _ in range(2))
    p = dict(kernel=(rng.standard_normal((16, 8)) / 4).astype(np.float32),
             bias=(rng.standard_normal(8) * 0.3).astype(np.float32))
    spec = dict(activation="int8,qs=per_tensor_symmetric",
                weight="int8,qs=per_tensor_symmetric")
    outs = {}
    for bias in ("int4", None):
        jqc = JaxQuantConfig(global_qconfig=JaxQConfig.from_strs(
            bias=bias, **spec))
        tqc = qt.QuantConfig(global_qconfig=qt.QConfig.from_strs(
            bias=bias, **spec))
        jm = jlayers.QDense(8, qconfig=jqc)
        init = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                jnp.asarray(x0, jnp.bfloat16))
        want, _ = jax.jit(partial(jm.apply, mutable=["quant_state"]))(
            {"params": p, "quant_state": init["quant_state"]},
            jnp.asarray(x1, jnp.bfloat16))
        tm = tlayers.QDense(16, 8, qconfig=tqc, device="cpu")
        for params, x in ((init["params"], x0), (p, x1)):
            tm.load_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in params.items()})
            got = tm(torch.from_numpy(x).bfloat16())
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        outs[bias] = got
    assert not torch.equal(outs["int4"], outs[None])


@pytest.mark.parametrize("arm", list(launcher.DTYPE_MATRIX))
def test_quant_config_from_args_matches_jax(arm):
    """Each DTYPE_MATRIX arm of run_quantized_training.py's bert_base MRPC
    command gives the same QuantConfig in both packages, including the
    reference's fault: the comma list of LoRA targets is one regex that
    matches no module path."""
    args = argparse.Namespace(
        task="mrpc", model="bert_base", batch_size=None, learning_rate=None,
        num_train_epochs=None, quantized_ops=None, data_json=None,
        model_path=None, output_dir=None, seed=0)
    argv = launcher.build_commands(args)[arm][2:]
    configs = []
    for mod in (jax_cli, torch_cli):
        parser = mod.add_qspec_args(argparse.ArgumentParser())
        configs.append(mod.quant_config_from_args(
            parser.parse_known_args(argv)[0]))
    assert repr(configs[0]) == repr(configs[1])
    if arm == "bf16":
        assert configs[1] is None
        return
    assert configs[1].lora_targets == ("query,value",)
    assert configs[1].lora_rank == 8 and configs[1].lora_alpha == 8.0
    for qc in configs:
        assert not qc.lora_matches("bert.layer_0.attention_self.query")


def _jax_value_and_grad(params, batch):
    """((loss, logits), gradients) of the reference's posit8 model."""
    labels = {"labels": jnp.asarray(batch["labels"])}

    def loss(p):
        logits = _jax_logits(p, batch, True)
        return jax_classification_loss(logits, labels), logits
    return jax.value_and_grad(loss, has_aux=True)(params)


def test_train_steps_match_jax():
    """Three make_train_step + Adam8bit(min_8bit_size=1024) steps of the
    posit8 recipe against the reference's (its loss and gradients, then the
    optax update op by op, as tests/test_torch_train.py composes them):
    8-bit unpacked leaves (the embeddings and every kernel), exact leaves
    (biases, norms, the classifier) and the LoRA adapters all move.  Each
    step's loss to 1e-6 relative (it is equal), and every 8-bit leaf's
    moment codes and scales bit for bit after each step.  The exact leaves'
    f32 moments are not compared: the reference sums a bias's or a norm
    parameter's gradient over the tokens in bf16 (XLA's reduce) or in
    another f32 order, the port in f32, so a few entries differ by one
    rounding (readings: up to 9 of 64 entries of a bias, relative 7e-3)."""
    params = _jax_params(lora=True)
    batch = _batch()
    tm = _port_model(params, True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_adam8bit(5e-4, weight_decay=1e-4, min_8bit_size=1024)
    jstate = tx.init(jparams)
    opt = Adam8bit(tm.parameters(), lr=5e-4, weight_decay=1e-4,
                   min_8bit_size=1024)
    tstep = make_train_step(tm, opt, classification_loss)
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items()}
    losses = []
    for _ in range(3):
        (jl, _), grads = _jax_value_and_grad(jparams, batch)
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        losses.append((float(jl), float(tstep(tbatch))))
        mu, nu = (_flatten(jax.tree_util.tree_map(np.asarray, tree))
                  for tree in (jstate[0].mu, jstate[0].nu))
        for name, p in tm.named_parameters():
            st = opt.state[p]
            if st["mu_codes"].dtype == torch.float32:
                continue
            for key, tree in (("mu", mu), ("nu", nu)):
                np.testing.assert_array_equal(
                    st[f"{key}_codes"].numpy(), tree[name].codes, name)
                np.testing.assert_array_equal(
                    st[f"{key}_scale"].numpy(), tree[name].scale, name)
    kinds = {n: opt.state[p]["mu_codes"].dtype
             for n, p in tm.named_parameters()}
    assert set(kinds.values()) == {torch.float32, torch.int8}
    assert kinds["bert.layer_0.attention_self.query.lora_a"] == torch.float32
    for jl, tl in losses:
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert losses[-1][1] < losses[0][1]
