"""BERT of the PyTorch port against ``paddle_tpu``.

``BertConfig.tiny()`` models: the JAX model's state dict goes through
numpy into the port (``load_numpy_state``; the parameter names are the
same), and both run on the CPU on the same seeded ids.  The JAX side runs
eagerly in eval mode with x64 off for forwards, and as its
``CompiledTrainStep`` traces it for training.  Dropout streams differ
between the packages, so parity runs in eval mode or with dropout 0; the
port's dropout is held to its own statistics and determinism.

Tolerances: fp32 forwards atol 2e-5 (fp32 on both sides, other summation
orders); fp32 train-step losses rtol 1e-5; bf16 compute rtol 2e-2 (bf16
rounds at the same points in both packages, but sums in other orders
round differently); LayerNorm in bf16 bit for bit (the same rounding
points).
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models.bert import (
    BertConfig as JaxConfig, BertForMaskedLM as JaxMLM,
    BertForQuestionAnswering as JaxQA,
    BertForSequenceClassification as JaxCls, BertModel as JaxBert,
)
from paddle_tpu.models.training import CompiledTrainStep as JaxTrainStep
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.transformer import (
    MultiHeadAttention as JaxMHA,
    TransformerEncoderLayer as JaxEncoderLayer,
)
from paddle_tpu.ops.nn_ops import _layer_norm_plain
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import (
    BertConfig, BertForMaskedLM, BertForQuestionAnswering,
    BertForSequenceClassification, BertModel, CompiledTrainStep,
    init_bert_params, load_numpy_state,
)
from paddle_tpu_torch.ops import nn_ops

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_data"):
        a = a._data
    return np.array(jnp.asarray(a, jnp.float32))


def _state(model):
    return {k: np.array(v._data, dtype=np.float32)
            for k, v in model.state_dict().items()}


def _ids(b=2, s=32, seed=0):
    return np.random.RandomState(seed).randint(0, 1024, (b, s))


def _pair(jax_cls, port_cls, seed=3, cfg_kw=None, **kw):
    """(JAX module, port module) on the same weights, both in eval mode."""
    paddle.seed(seed)
    jcfg = JaxConfig.tiny(**(cfg_kw or {}))
    jmod = jax_cls(jcfg, **kw)
    pmod = port_cls(BertConfig(**asdict(jcfg)), device="cpu", seed=None,
                    **kw)
    load_numpy_state(pmod, _state(jmod))
    jmod.eval()
    pmod.eval()
    return jmod, pmod


def _jax(fn, *a, **kw):
    with jax.enable_x64(False):
        return fn(*a, **kw)


@pytest.mark.parametrize("cls", ["model", "qa", "cls", "mlm"])
def test_parameter_names_and_shapes_match(cls):
    jax_cls, port_cls, kw = {
        "model": (JaxBert, BertModel, {}),
        "qa": (JaxQA, BertForQuestionAnswering, {}),
        "cls": (JaxCls, BertForSequenceClassification,
                {"num_classes": 3}),
        "mlm": (JaxMLM, BertForMaskedLM, {})}[cls]
    paddle.seed(0)
    jcfg = JaxConfig.tiny()
    state = _state(jax_cls(jcfg, **kw))
    pmod = port_cls(BertConfig(**asdict(jcfg)), device="cpu", **kw)
    got = {k: tuple(p.shape) for k, p in pmod.named_parameters()}
    assert got == {k: v.shape for k, v in state.items()}
    if cls == "qa":
        assert "bert.encoder.layers.1.self_attn.q_proj.bias" in got
        assert "bert.embeddings.layer_norm.weight" in got


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_bert_model_forward_matches(masked):
    jmod, pmod = _pair(JaxBert, BertModel)
    ids = _ids()
    tt = np.random.RandomState(1).randint(0, 2, ids.shape)
    mask = np.ones_like(ids)
    mask[0, 20:] = 0
    mask[1, 5:] = 0
    m = mask if masked else None
    jseq, jpool = _jax(jmod, paddle.to_tensor(ids), paddle.to_tensor(tt),
                       attention_mask=None if m is None
                       else paddle.to_tensor(m))
    with torch.no_grad():
        seq, pool = pmod(torch.from_numpy(ids), torch.from_numpy(tt),
                         attention_mask=None if m is None
                         else torch.from_numpy(m))
    assert seq.shape == (2, 32, 64) and pool.shape == (2, 64)
    np.testing.assert_allclose(_np(seq), _np(jseq), rtol=0, atol=2e-5)
    np.testing.assert_allclose(_np(pool), _np(jpool), rtol=0, atol=2e-5)


def test_heads_match_in_eval():
    ids = _ids(seed=2)
    jqa, pqa = _pair(JaxQA, BertForQuestionAnswering)
    js, je = _jax(jqa, paddle.to_tensor(ids))
    with torch.no_grad():
        ps, pe = pqa(torch.from_numpy(ids))
    np.testing.assert_allclose(_np(ps), _np(js), rtol=0, atol=2e-5)
    np.testing.assert_allclose(_np(pe), _np(je), rtol=0, atol=2e-5)
    st, en = np.array([3, 31]), np.array([7, 0])
    jl = _jax(jqa, paddle.to_tensor(ids), start_positions=paddle.to_tensor(
        st), end_positions=paddle.to_tensor(en))
    with torch.no_grad():
        pl = pqa(torch.from_numpy(ids),
                 start_positions=torch.from_numpy(st.astype(np.int32)),
                 end_positions=torch.from_numpy(en.astype(np.int32)))
    np.testing.assert_allclose(float(pl), float(_np(jl)), rtol=1e-6)

    jcls, pcls = _pair(JaxCls, BertForSequenceClassification, num_classes=3)
    with torch.no_grad():
        got = pcls(torch.from_numpy(ids))
    np.testing.assert_allclose(_np(got), _np(_jax(jcls, paddle.to_tensor(
        ids))), rtol=0, atol=2e-5)

    jmlm, pmlm = _pair(JaxMLM, BertForMaskedLM)
    labels = np.random.RandomState(2).randint(0, 1024, ids.shape)
    labels[:, :16] = -100
    jl = _jax(jmlm, paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    with torch.no_grad():
        logits = pmlm(torch.from_numpy(ids))
        pl = pmlm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(_np(logits), _np(_jax(
        jmlm, paddle.to_tensor(ids))), rtol=0, atol=5e-5)
    np.testing.assert_allclose(float(pl), float(_np(jl)), rtol=1e-5)


class _JaxQATrain(jnn.Layer):
    """bench.py's QA wrapper: (ids, starts, ends) -> loss."""

    def __init__(self, cfg):
        super().__init__()
        self.qa = JaxQA(cfg)

    def forward(self, ids, starts, ends):
        return self.qa(ids, start_positions=starts, end_positions=ends)


class _QATrain(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.qa = BertForQuestionAnswering(cfg, device="cpu", seed=None)

    def forward(self, ids, starts, ends):
        return self.qa(ids, start_positions=starts, end_positions=ends)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype):
    """3 AdamW steps of CompiledTrainStep on the QA wrapper (the bench
    path's step with dropout 0: bf16 compute, fp32 master and moments):
    the losses match step for step; LayerNorm weights and biases stay
    fp32; the pooler, which the loss does not reach, is updated by the
    decay alone in both packages."""
    jcfg = JaxConfig.tiny(**NO_DROPOUT)
    paddle.seed(3)
    jw = _JaxQATrain(jcfg)
    pw = _QATrain(BertConfig(**asdict(jcfg)))
    load_numpy_state(pw, _state(jw))
    kw = {} if dtype == "float32" else dict(compute_dtype="bfloat16")
    jstep = JaxTrainStep(jw, lr=1e-3, donate=False, **kw)
    pstep = CompiledTrainStep(pw, lr=1e-3, device="cpu", donate=False, **kw)
    ids = _ids(seed=4).astype(np.int32)
    st, en = np.array([3, 5], np.int32), np.array([7, 9], np.int32)
    jl = [float(jstep.step(ids, st, en)) for _ in range(3)]
    pl = [float(pstep.step(ids, st, en)) for _ in range(3)]
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    assert pl[-1] < pl[0]
    pstate = pstep.state_dict()
    for k, want in jstep._master.items():
        assert pstate["params"][k].dtype == (
            torch.float32 if dtype == "float32" or "norm" in k
            else torch.bfloat16), k
        # fp32 only: in bf16, AdamW's early steps (m / sqrt(v) near +-1)
        # turn small gradient differences into whole-lr steps.  Skipped
        # too: parameters whose gradient is 0 in exact arithmetic, since
        # a softmax ignores a constant added to every logit of a row (the
        # key biases per query; the last LayerNorm's bias and the QA
        # bias per span), so rounding noise drives their updates.
        zero_grad = k.endswith(("k_proj.bias", "qa_outputs.bias",
                                "layers.1.norm2.bias"))
        if dtype == "float32" and not zero_grad:
            err = np.linalg.norm(_np(pstate["master"][k]) - _np(want))
            assert err <= rtol * np.linalg.norm(_np(want)), (k, err)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_layer_norm_matches(name, eps):
    """Statistics in x's dtype, fp32 weight and bias cast to it."""
    jd, td = ((jnp.float32, torch.float32) if name == "fp32"
              else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.RandomState(5)
    x = (3 + 2 * rng.randn(4, 7, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    want = _jax(_layer_norm_plain, jnp.asarray(x, jd), jnp.asarray(w),
                jnp.asarray(b), eps)
    got = nn_ops.layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(w),
                            torch.from_numpy(b), eps)
    assert got.dtype == td
    if name == "fp32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-6)
    else:   # the same rounding points: bit for bit
        np.testing.assert_array_equal(_np(got), _np(want))
    layer = pnn.LayerNorm(64, device="cpu")
    assert layer._epsilon == 1e-5
    assert torch.equal(layer.weight, torch.ones(64))


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_gelu_and_tanh_match(name):
    jd, td = ((jnp.float32, torch.float32) if name == "fp32"
              else (jnp.bfloat16, torch.bfloat16))
    x = np.linspace(-6, 6, 97).astype(np.float32)
    tol = 1e-6 if name == "fp32" else 2 ** -7
    want = _jax(jax.nn.gelu, jnp.asarray(x, jd), approximate=False)
    got = nn_ops.gelu(torch.from_numpy(x).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(torch.tanh(torch.from_numpy(x).to(td))),
                               _np(jnp.tanh(jnp.asarray(x, jd))), rtol=tol,
                               atol=tol)


def test_cross_entropy_over_span_logits():
    """The QA head's loss: [B, S] logits (bf16 and fp32), [B] int32
    labels, as ``F.cross_entropy`` computes it."""
    rng = np.random.RandomState(6)
    logits = rng.randn(4, 48).astype(np.float32) * 3
    labels = np.array([0, 47, 13, 5], np.int32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = _jax(JF.cross_entropy, paddle.to_tensor(
            np.asarray(jnp.asarray(logits, jd))), paddle.to_tensor(labels))
        got = nn_ops.cross_entropy(torch.from_numpy(logits).to(td),
                                   torch.from_numpy(labels))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(_np(want)), rtol=1e-6)


def test_dropout_statistics_and_determinism():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(7)
    a = nn_ops.dropout(x, 0.1, generator=gen)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    assert torch.all(a[kept] == 1 / 0.9)
    gen.manual_seed(7)
    assert torch.equal(nn_ops.dropout(x, 0.1, generator=gen), a)
    assert not torch.equal(nn_ops.dropout(x, 0.1, generator=gen), a)
    b = nn_ops.dropout(x, 0.3, mode="downscale_in_infer", generator=gen)
    assert set(b.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(nn_ops.dropout(x, 0.3, training=False,
                                       mode="downscale_in_infer"), x * 0.7)
    assert nn_ops.dropout(x, 0.3, training=False) is x
    with pytest.raises(ValueError, match="Generator"):
        nn_ops.dropout(x, 0.1)
    # the gradient takes the same mask
    xg = torch.randn(50, 40, generator=gen).requires_grad_(True)
    y = nn_ops.dropout(xg, 0.5, generator=gen)
    y.sum().backward()
    assert torch.equal(xg.grad != 0, y != 0)
    # the Dropout layer: active in training mode only
    layer = pnn.Dropout(0.5, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(layer(x), x)
    layer.eval()
    assert layer(x) is x


def test_model_dropout_is_seeded_and_shared():
    """A BERT model's dropouts (hidden and attention) draw from one
    generator; the encoder's deep-copied layers share it and start from
    the first layer's weights, as in ``paddle_tpu``."""
    cfg = BertConfig.tiny()
    m1 = BertForQuestionAnswering(cfg, device="cpu", seed=5)
    m2 = BertForQuestionAnswering(cfg, device="cpu", seed=5)
    gens = {id(mod.generator) for mod in m1.modules()
            if getattr(mod, "generator", None) is not None}
    assert gens == {id(m1.generator)}
    layers = m1.bert.encoder.layers
    for (k, a), (_, b) in zip(layers[0].named_parameters(),
                              layers[1].named_parameters()):
        assert torch.equal(a, b), k
        assert a.data_ptr() != b.data_ptr()
    ids = torch.from_numpy(_ids())
    l1 = [m1(ids)[0] for _ in range(2)]
    l2 = [m2(ids)[0] for _ in range(2)]
    assert torch.equal(l1[0], l2[0]) and torch.equal(l1[1], l2[1])
    assert not torch.equal(l1[0], l1[1])
    m1.eval()
    assert torch.equal(m1(ids)[0], m1(ids)[0])
    other = BertForQuestionAnswering(cfg, device="cpu", seed=6)
    assert not torch.equal(other.qa_outputs.weight, m1.qa_outputs.weight)
    g = torch.Generator().manual_seed(0)
    init_bert_params(other, g)
    assert torch.equal(other.bert.embeddings.layer_norm.weight,
                       torch.ones(64))


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["postnorm", "prenorm"])
def test_encoder_layer_matches(normalize_before):
    """One ``TransformerEncoderLayer`` (relu, bool mask) and a
    cross-attention ``MultiHeadAttention`` against ``paddle_tpu``'s."""
    paddle.seed(9)
    jl = JaxEncoderLayer(32, 4, 64, dropout=0.0, activation="relu",
                         normalize_before=normalize_before)
    jl.eval()
    pl = pnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                     activation="relu",
                                     normalize_before=normalize_before,
                                     device="cpu")
    load_numpy_state(pl, _state(jl))
    pl.eval()
    rng = np.random.RandomState(10)
    x = rng.randn(2, 12, 32).astype(np.float32)
    keep = rng.rand(2, 12, 12) > 0.2
    keep[:, :, 0] = True
    want = _jax(jl, paddle.to_tensor(x), src_mask=paddle.to_tensor(keep))
    with torch.no_grad():
        got = pl(torch.from_numpy(x), src_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)

    jm = JaxMHA(32, 4, kdim=16, vdim=24)
    pm = pnn.MultiHeadAttention(32, 4, kdim=16, vdim=24, device="cpu")
    load_numpy_state(pm, _state(jm))
    kv_k, kv_v = rng.randn(2, 9, 16), rng.randn(2, 9, 24)
    want = _jax(jm, paddle.to_tensor(x), paddle.to_tensor(
        kv_k.astype(np.float32)), paddle.to_tensor(kv_v.astype(np.float32)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(kv_k).float(),
                 torch.from_numpy(kv_v).float())
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)


def test_num_params_and_flops_match_jax():
    jmod, pmod = _pair(JaxBert, BertModel)
    assert pmod.num_params() == jmod.num_params()
    assert pmod.flops_per_token(384) == jmod.flops_per_token(384)
    base = BertModel(BertConfig.base(), device="cpu", seed=None)
    assert base.num_params() == 109482240


def test_linear_bias_is_optional():
    assert "bias" not in dict(pnn.Linear(4, 3, "cpu").named_parameters())
    lin = pnn.Linear(4, 3, "cpu", bias=True)
    assert dict(lin.named_parameters())["bias"].shape == (3,)
    with torch.no_grad():
        lin.weight.fill_(1.0)
        lin.bias.copy_(torch.tensor([1.0, 2.0, 3.0]))
    out = lin(torch.ones(2, 4, dtype=torch.bfloat16).to(torch.float32))
    assert torch.equal(out, torch.tensor([[5.0, 6.0, 7.0]] * 2))
