"""``paddle_tpu_torch.nn.Layer`` and the repaired layers against
``paddle_tpu.nn`` on the CPU: the names both packages export, the
constructors' positional signatures, ``isinstance`` of every layer, the
``Layer`` API (hooks, ``state_dict`` naming and non-persistable
buffers, ``set_state_dict``, ``create_parameter`` with ``ParamAttr``
read by the port's optimizer, ``to`` / ``astype``), torch's own
contracts on a ``Layer``, the initializers' distributions (JAX's
threefry stream is not Philox: moments and bounds, and ``paddle.seed``
reproducibility, never bits), weights carried across by
``set_state_dict`` from the reference layer's ``state_dict()``, and a
tiny user GPT through ``F.flash_attention`` whose loss matches
``paddle_tpu``'s.

Tolerances: values and gradients within 1e-5 of the largest magnitude
(at least 1), fp32 on both sides; moments within 6 standard errors.
"""
import inspect
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.optimizer.optimizer import L2Decay

from torch_nn_harness import FAST_COMPILE, close, concrete_key


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("name", ["nn", "nn.functional"])
def test_every_public_name_is_ported(name):
    """The reference's public names (modules aside: ``np``, ``ops``,
    ``registry``) all exist in the port; the port adds only
    ``running_stats_frozen`` (its compiled step's batch-norm switch)."""
    r = ref.nn if name == "nn" else JF
    p = pnn if name == "nn" else PF
    assert _public(r) - _public(p) == set()
    extra = _public(p) - _public(r)
    if name == "nn":
        assert extra == {"running_stats_frozen"}
    assert paddle.ParamAttr is pnn.ParamAttr


def _layer_classes():
    return sorted(n for n in _public(pnn)
                  if isinstance(getattr(pnn, n), type)
                  and issubclass(getattr(pnn, n), torch.nn.Module))


def test_every_layer_is_a_layer():
    names = _layer_classes()
    assert len(names) == 137
    bad = [n for n in names if not issubclass(getattr(pnn, n), pnn.Layer)]
    assert not bad, bad
    assert isinstance(pnn.Linear(2, 2), pnn.Layer)


def _positional(fn):
    ps = list(inspect.signature(fn).parameters.values())[1:]
    if any(p.kind == p.VAR_POSITIONAL for p in ps):
        return None
    return [p.name for p in ps
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def test_constructors_take_the_reference_positional_signature():
    """Every layer of both packages takes the reference's positional
    arguments in its order (``device``, ``dtype`` and ``generator`` are
    keyword-only in the port); the defaults of the repaired layers are
    the reference's."""
    checked = 0
    for n in _layer_classes():
        r = getattr(jnn, n, None)
        if not isinstance(r, type):
            continue
        want, got = _positional(r.__init__), _positional(
            getattr(pnn, n).__init__)
        if want is None or got is None:
            continue
        assert got == want, (n, got, want)
        checked += 1
    assert checked > 100
    for n in ("Linear", "Embedding", "Conv2D", "LayerNorm", "Dropout",
              "MultiHeadAttention", "TransformerEncoderLayer", "LSTM"):
        rs = inspect.signature(getattr(jnn, n).__init__).parameters
        ps = inspect.signature(getattr(pnn, n).__init__).parameters
        for k, v in rs.items():
            assert ps[k].default == v.default, (n, k)
        for k in ("device", "dtype", "generator"):
            if k in ps:
                assert ps[k].kind == inspect.Parameter.KEYWORD_ONLY, (n, k)


# -- initializers -----------------------------------------------------------------

def _moments(t, mean, var, n=None):
    v = t.detach().double().reshape(-1)
    n = v.numel()
    se = math.sqrt(var / n)
    assert abs(float(v.mean()) - mean) < 6 * se + 1e-12
    assert abs(float(v.var()) - var) < 6 * var * math.sqrt(2 / n) * 1.5


def test_linear_draws_xavier_uniform_and_a_zero_bias():
    paddle.seed(1)
    lin = pnn.Linear(256, 128)
    limit = math.sqrt(6 / (256 + 128))
    assert lin.bias is not None and torch.equal(lin.bias, torch.zeros(128))
    assert float(lin.weight.abs().max()) <= limit
    _moments(lin.weight, 0.0, limit ** 2 / 3)
    assert lin.weight.name.startswith("linear_") and lin.bias.name.endswith(
        ".b_0")
    r = jnn.Linear(256, 128)
    assert float(np.abs(r.weight.numpy()).max()) <= limit
    assert pnn.Linear(4, 3, bias_attr=False).bias is None


def test_embedding_draws_normal_with_the_padding_row_zeroed():
    paddle.seed(2)
    emb = pnn.Embedding(512, 64, padding_idx=3)
    assert torch.equal(emb.weight[3], torch.zeros(64))
    _moments(torch.cat([emb.weight[:3], emb.weight[4:]]), 0.0, 1.0)
    ids = torch.tensor([[3, 1], [0, 3]])
    out = emb(ids)
    assert torch.equal(out[0, 0], torch.zeros(64))
    out.sum().backward()
    assert torch.equal(emb.weight.grad[3], torch.zeros(64))
    assert torch.equal(emb.weight.grad[1], torch.ones(64))


def test_multi_head_attention_projections_are_drawn():
    paddle.seed(3)
    mha = pnn.MultiHeadAttention(64, 4)
    limit = math.sqrt(6 / 128)
    for p in (mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj):
        assert 0 < float(p.weight.abs().max()) <= limit
        assert torch.equal(p.bias, torch.zeros(64))


@pytest.mark.parametrize("case", [
    ("Normal", (0.5, 2.0), 0.5, 4.0),
    ("Uniform", (-1.0, 3.0), 1.0, 16 / 12),
    ("XavierNormal", (), 0.0, 2 / (256 + 128)),
    ("XavierUniform", (), 0.0, 2 / (256 + 128)),
    ("KaimingNormal", (), 0.0, 2 / 256),
    ("KaimingUniform", (), 0.0, 2 / 256),
    ("Constant", (0.25,), 0.25, 0.0),
])
def test_initializer_moments(case):
    name, args, mean, var = case
    t = torch.empty(256, 128)
    getattr(pnn.initializer, name)(*args)(t)
    if var == 0.0:
        assert torch.equal(t, torch.full_like(t, mean))
    else:
        _moments(t, mean, var)
    # the reference draws the same distribution
    r = getattr(jnn.initializer, name)(*args)((256, 128), jnp.float32)
    r = np.asarray(r, np.float64)
    assert abs(r.mean() - mean) < 6 * math.sqrt(var / r.size) + 1e-12


def test_truncated_normal_orthogonal_assign_and_gain():
    t = torch.empty(512, 256)
    pnn.initializer.TruncatedNormal(1.0, 0.5)(t)
    assert float(t.min()) >= 0.0 - 1e-6 and float(t.max()) <= 2.0 + 1e-6
    # the standard normal cut to [-2, 2]: variance 0.7737
    _moments(t, 1.0, 0.25 * 0.77372)
    for shape in ((32, 32), (48, 16), (16, 48), (8, 4, 3)):
        w = torch.empty(shape)
        pnn.initializer.Orthogonal(gain=2.0)(w)
        m = w.reshape(shape[0], -1) / 2.0
        gram = m @ m.t() if m.shape[0] <= m.shape[1] else m.t() @ m
        close(gram.numpy(), np.eye(gram.shape[0]), 1e-5)
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    w = torch.empty(2, 3)
    pnn.initializer.Assign(v)(w)
    assert torch.equal(w, torch.from_numpy(v))
    for nl, p in (("relu", None), ("tanh", None), ("leaky_relu", 0.2),
                  ("selu", None), ("sigmoid", None)):
        assert pnn.initializer.calculate_gain(nl, p) == \
            jnn.initializer.calculate_gain(nl, p)


def test_seed_repeats_and_explicit_generators_draw():
    paddle.seed(7)
    a = pnn.Linear(8, 8).weight.detach().clone()
    paddle.seed(7)
    b = pnn.Linear(8, 8).weight.detach().clone()
    assert torch.equal(a, b)
    assert not torch.equal(a, pnn.Linear(8, 8).weight)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(pnn.Conv2D(3, 4, 3, generator=g1).weight,
                       pnn.Conv2D(3, 4, 3, generator=g2).weight)


# -- Layer -------------------------------------------------------------------------

def _make_block(nn):
    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 6)
            self.seq = nn.Sequential(nn.Linear(6, 3), nn.ReLU())
            self.norm = nn.LayerNorm(3)
            self.bn = nn.BatchNorm1D(3)
            self.register_buffer("scratch", ref.zeros([2])
                                 if nn is jnn else torch.zeros(2),
                                 persistable=False)

        def forward(self, x):
            return self.bn(self.norm(self.seq(self.fc(x))))

    return Block()


def test_state_dict_names_buffers_and_set_state_dict():
    """The same user block in both packages has the same state dict
    names (BN's ``_mean`` / ``_variance`` included, the non-persistable
    buffer left out); the reference's ``state_dict()`` loads into the
    port by ``set_state_dict`` and the two compute the same."""
    rb, pb = _make_block(jnn), _make_block(pnn)
    assert list(pb.state_dict()) == list(rb.state_dict())
    assert list(pb.state_dict(structured_name_prefix="m.")) == [
        "m." + k for k in rb.state_dict()]
    assert "scratch" not in pb.state_dict()
    assert [n for n, _ in pb.named_sublayers()] == [
        n for n, _ in rb.named_sublayers()]
    missing, unexpected = pb.set_state_dict(rb.state_dict())
    assert missing == [] and unexpected == []
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    rb.eval()
    pb.eval()
    close(pb(torch.from_numpy(x)).detach().numpy(),
          rb(ref.to_tensor(x)).numpy(), 1e-5)
    extra = dict(rb.state_dict(), stray=np.zeros(1, np.float32))
    del extra["fc.bias"]
    assert pb.load_dict(extra) == (["fc.bias"], ["stray"])
    assert len(pb.parameters()) == len(rb.parameters()) == 8
    assert isinstance(pb.parameters(), list)
    assert [type(m).__name__ for m in pb.sublayers()] == [
        type(m).__name__ for m in rb.sublayers()]


def test_hooks_to_astype_and_torch_contracts():
    pb = _make_block(pnn)
    seen = []
    h1 = pb.register_forward_pre_hook(
        lambda layer, inputs: (inputs[0] * 2,))
    h2 = pb.register_forward_post_hook(
        lambda layer, inputs, out: seen.append(out.shape) or out + 1)
    pb.eval()
    x = torch.randn(5, 4)
    base = pb.bn(pb.norm(pb.seq(pb.fc(x * 2)))) + 1
    assert torch.equal(pb(x), base) and seen == [(5, 3)]
    h1.remove()
    h2.remove()
    assert torch.equal(pb(x), pb.bn(pb.norm(pb.seq(pb.fc(x)))))
    assert pb.to(dtype="float64").fc.weight.dtype == torch.float64
    assert pb.bn._mean.dtype == torch.float64
    assert pb.astype("float32").fc.weight.dtype == torch.float32
    assert pb.to("cpu").fc.weight.device.type == "cpu"
    assert pb.to(device="cpu", dtype=torch.bfloat16).norm.weight.dtype == \
        torch.bfloat16
    pb.float()
    # torch's contracts: train / eval, state dicts with keep_vars,
    # load_state_dict, functional_call, named_parameters(recurse=)
    pb.train()
    assert pb.bn.training and not pb.eval().bn.training
    sd = pb.state_dict(keep_vars=True)
    assert sd["fc.weight"] is pb.fc.weight
    pb.load_state_dict({k: v.detach().clone() for k, v in sd.items()})
    params = {k: torch.zeros_like(v) for k, v in pb.named_parameters()}
    out = torch.func.functional_call(pb, params, (x,))
    assert torch.isfinite(out).all()
    assert [n for n, _ in pb.named_parameters(recurse=False)] == []
    assert pb.full_name() == "block"
    pb(x).sum().backward()
    pb.clear_gradients()
    assert all(p.grad is None for p in pb.parameters())


def test_create_parameter_with_param_attr_reaches_the_optimizer():
    """``ParamAttr`` sets name, initializer, trainable, the learning-rate
    multiplier (an SGD step moves the parameter by lr x multiplier x g)
    and the regularizer (the optimizer's global decay skips it)."""
    layer = pnn.Layer()
    attr = paddle.ParamAttr(
        name="w_special", initializer=pnn.initializer.Constant(1.0),
        learning_rate=0.5,
        regularizer=L2Decay(0.0))
    w = layer.create_parameter([3], attr=attr)
    assert w.name == "w_special" and torch.equal(w, torch.ones(3))
    assert w.optimize_attr["learning_rate"] == 0.5
    frozen = layer.create_parameter([2], attr=paddle.ParamAttr(
        trainable=False))
    assert frozen.stop_gradient and not frozen.trainable
    assert layer.create_parameter([2], attr=False) is None
    b = layer.create_parameter([3], is_bias=True)
    assert torch.equal(b, torch.zeros(3)) and b.name.endswith(".b_0")
    layer.add_parameter("w", w)
    layer.add_parameter("b", b)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=layer.parameters(),
                               weight_decay=0.01)
    (w.sum() + b.sum()).backward()
    opt.step()
    # w: no global decay (it has a regularizer), lr 0.1 x 0.5
    close(w.detach().numpy(), np.full(3, 1 - 0.05, np.float32), 1e-7)
    # b: the global L2 decay 0.01 x 0 and lr 0.1
    close(b.detach().numpy(), np.full(3, -0.1, np.float32), 1e-7)
    sub = layer.add_sublayer("lin", pnn.Linear(3, 3))
    assert layer.lin is sub and layer.sublayers() == [sub]
    assert layer.create_variable().shape == (1,)


def test_containers_match_the_reference():
    rs = jnn.Sequential(("a", jnn.Linear(2, 3)), ("b", jnn.Tanh()))
    ps = pnn.Sequential(("a", pnn.Linear(2, 3)), ("b", pnn.Tanh()))
    assert list(ps.state_dict()) == list(rs.state_dict())
    assert isinstance(ps[0:1], pnn.Sequential) and len(ps) == 2
    rl = jnn.LayerList([jnn.Linear(2, 2) for _ in range(3)])
    pl = pnn.LayerList([pnn.Linear(2, 2) for _ in range(3)])
    pl.insert(1, pnn.Linear(2, 2))
    rl.insert(1, jnn.Linear(2, 2))
    assert list(pl.state_dict()) == list(rl.state_dict())
    assert pl[-1] is pl[3]
    pp = pnn.ParameterList([pnn.Layer().create_parameter([2])
                            for _ in range(2)])
    assert [n for n, _ in pp.named_parameters()] == ["0", "1"]
    d = pnn.LayerDict({"x": pnn.Linear(1, 1)})
    d["y"] = pnn.ReLU()
    assert list(d.keys()) == ["x", "y"] and "x.weight" in d.state_dict()
    assert pnn.Identity(3, k=1)(torch.ones(2)).shape == (2,)


# -- repaired layers against the reference, weights carried across -----------------

REPAIRED = {
    "Linear": (lambda nn: nn.Linear(6, 5), (3, 6)),
    "Embedding": (lambda nn: nn.Embedding(9, 4, padding_idx=2), None),
    "Conv2D": (lambda nn: nn.Conv2D(3, 4, 3, 2, 1), (2, 3, 7, 7)),
    "Conv1D": (lambda nn: nn.Conv1D(3, 4, 3), (2, 3, 9)),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(3, 2, 3, 2),
                        (1, 3, 4, 4)),
    "LayerNorm": (lambda nn: nn.LayerNorm([4, 5]), (3, 4, 5)),
    "RMSNorm": (lambda nn: nn.RMSNorm(5), (3, 5)),
    "GroupNorm": (lambda nn: nn.GroupNorm(2, 4), (2, 4, 3, 3)),
    "BatchNorm2D": (lambda nn: nn.BatchNorm2D(3), (4, 3, 2, 2)),
    "InstanceNorm1D": (lambda nn: nn.InstanceNorm1D(3), (2, 3, 6)),
    "PReLU": (lambda nn: nn.PReLU(3), (2, 3, 4)),
    "MultiHeadAttention": (lambda nn: nn.MultiHeadAttention(8, 2), (2, 5, 8)),
    "TransformerEncoderLayer": (
        lambda nn: nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0),
        (2, 5, 8)),
}


def _abstract_states(makers):
    """{name: {key: shape}} of the reference's layers, built under
    ``jax.eval_shape`` (built eagerly, their initializers compile once
    per parameter shape)."""
    concrete_key()
    shapes = jax.eval_shape(lambda: {
        n: {k: v._data for k, v in make(jnn).state_dict().items()}
        for n, make in makers.items()})
    return jax.tree_util.tree_map(lambda v: tuple(v.shape), shapes)


@pytest.fixture(scope="module")
def repaired_ref():
    """Each repaired layer's random state, input, and the reference's
    forward and input gradient: the layers are built, loaded and run
    inside one ``jax.jit``."""
    shapes = _abstract_states({n: m for n, (m, _) in REPAIRED.items()})
    out = {}
    rng = np.random.RandomState(0)
    for name, (_, shape) in REPAIRED.items():
        state = {k: (rng.randn(*v) * 0.3).astype(np.float32)
                 if "_variance" not in k else
                 rng.uniform(0.5, 1.5, v).astype(np.float32)
                 for k, v in shapes[name].items()}
        x = (rng.randint(0, 9, (3, 4)) if shape is None
             else rng.randn(*shape).astype(np.float32))
        out[name] = dict(state=state, x=x)

    def fwd(xs):
        res = {}
        for n, c in out.items():
            layer = REPAIRED[n][0](jnn)
            layer.set_state_dict(c["state"])
            layer.eval()
            x = xs[n]
            if not jnp.issubdtype(x.dtype, jnp.floating):
                res[n] = (layer(ref.Tensor(x))._data, None)
                continue

            def f(v, layer=layer):
                return layer(ref.Tensor(v))._data
            y, vjp = jax.vjp(f, x)
            res[n] = (y, vjp(jnp.cos(jnp.arange(
                y.size, dtype=jnp.float32)).reshape(y.shape))[0])
        return res

    concrete_key()
    res = jax.jit(fwd, compiler_options=FAST_COMPILE)(
        {n: jnp.asarray(c["x"]) for n, c in out.items()})
    for n, (y, g) in res.items():
        out[n]["y"], out[n]["g"] = np.asarray(y), (
            None if g is None else np.asarray(g))
    return out


@pytest.mark.parametrize("name", list(REPAIRED))
def test_repaired_layer_matches_the_reference(name, repaired_ref):
    case = repaired_ref[name]
    layer = REPAIRED[name][0](pnn)
    assert isinstance(layer, pnn.Layer)
    assert layer.set_state_dict(case["state"]) == ([], [])
    layer.eval()
    x = torch.from_numpy(case["x"])
    if case["g"] is None:
        close(layer(x).detach().numpy(), case["y"], 1e-5)
        return
    x.requires_grad_(True)
    y = layer(x)
    close(y.detach().numpy(), case["y"], 1e-5)
    w = torch.cos(torch.arange(y.numel(), dtype=torch.float32)).reshape(
        y.shape)
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    close(gx.numpy(), case["g"], 1e-5)


# -- a user's GPT through F.flash_attention ---------------------------------------

def _gpt(nn, F, V=64, D=32, H=4, L=2, S=16):
    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(D)
            self.qkv = nn.Linear(D, 3 * D)
            self.proj = nn.Linear(D, D)
            self.ln2 = nn.LayerNorm(D)
            self.fc1 = nn.Linear(D, 4 * D)
            self.act = nn.GELU()
            self.fc2 = nn.Linear(4 * D, D)
            self.drop = nn.Dropout(0.0)

        def forward(self, x):
            B = x.shape[0]
            qkv = self.qkv(self.ln1(x)).reshape([B, S, 3, H, D // H])
            a, _ = F.flash_attention(qkv[:, :, 0], qkv[:, :, 1],
                                     qkv[:, :, 2], dropout=0.0, causal=True)
            x = x + self.drop(self.proj(a.reshape([B, S, D])))
            return x + self.drop(self.fc2(self.act(self.fc1(self.ln2(x)))))

    class GPT(nn.Layer):
        def __init__(self):
            super().__init__()
            self.wte = nn.Embedding(V, D)
            self.wpe = nn.Embedding(S, D)
            self.blocks = nn.LayerList([Block() for _ in range(L)])
            self.ln_f = nn.LayerNorm(D)
            self.head = nn.Linear(D, V, bias_attr=False)
            self.loss = nn.CrossEntropyLoss()

        def forward(self, ids, labels, pos):
            x = self.wte(ids) + self.wpe(pos)
            for b in self.blocks:
                x = b(x)
            logits = self.head(self.ln_f(x))
            return self.loss(logits.reshape([-1, V]), labels.reshape([-1]))

    return GPT()


def test_tiny_gpt_loss_and_gradients_match_the_reference():
    rng = np.random.RandomState(4)
    rg = _gpt(jnn, JF)
    state = {k: (rng.randn(*v.shape) * 0.2).astype(np.float32)
             for k, v in rg.state_dict().items()}
    rg.set_state_dict(state)
    pg = _gpt(pnn, PF)
    assert pg.set_state_dict(state) == ([], [])
    ids = rng.randint(0, 64, (2, 16))
    labels = rng.randint(0, 64, (2, 16))
    pos = np.tile(np.arange(16), (2, 1))
    params = {k: jnp.asarray(v) for k, v in state.items()}

    def loss_fn(p):
        for k, v in rg.named_parameters():
            v._data = p[k]
        return rg(ref.to_tensor(ids), ref.to_tensor(labels),
                  ref.to_tensor(pos))._data

    want, gwant = jax.jit(jax.value_and_grad(loss_fn),
                          compiler_options=FAST_COMPILE)(params)
    got = pg(torch.from_numpy(ids), torch.from_numpy(labels),
             torch.from_numpy(pos))
    got.backward()
    close(got.detach().numpy(), np.asarray(want), 1e-5)
    for k, p in pg.named_parameters():
        close(p.grad.numpy(), np.asarray(gwant[k]), 1e-5)
