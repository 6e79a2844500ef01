"""The vision path's ops of the PyTorch port against ``paddle_tpu``.

The same seeded numpy inputs go through the JAX op (``paddle_tpu/ops/
nn_ops.py``'s plain functions, their hand-written VJPs, or the
``nn.functional`` wrappers with the eager tape) and the port's, on the
CPU.

Tolerances:
- fp32: atol 2e-5 on values and gradients of order 1 to 10 (fp32 on both
  sides, sums in other orders), 1e-6 on the BN running statistics;
- bf16 convolutions: a relative error of at most 2e-2 in the 2-norm
  (both round the products' fp32 sums once, in other orders);
- bf16 batch norm: elementwise within 2 bf16 ulps (2 * 2^-8 relative) of
  the larger magnitude, since the fp32 statistics differ in the last
  bits and a value near a rounding boundary can round the other way;
  the fp32 statistics themselves within 1e-5 relative;
- max pool: forward and gradient exact, ties included (the gradient
  goes to the first maximum in window order in both);
- the bf16 means of the adaptive pool: exact (both sum in fp32 and
  round once);
- losses and their gradients: fp32, rtol 1e-6 / atol 1e-7.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn import initializer as pinit
from paddle_tpu_torch.ops import nn_ops

DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_data"):
        a = a._data
    return np.array(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        dtype).requires_grad_(grad)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _hold(got, want, name, atol=2e-5):
    if name == "fp32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)
    else:
        assert _rel(got, want) <= 2e-2


# (kernel, stride, padding, dilation, groups, data_format)
CONV_CASES = [
    (3, 1, 0, 1, 1, "NCHW"),
    (3, 2, 1, 1, 1, "NCHW"),
    (3, (2, 1), (1, 2), 1, 1, "NCHW"),
    (3, 1, "SAME", 1, 1, "NCHW"),
    (4, 2, "SAME", 1, 1, "NCHW"),        # uneven: one more at the end
    (3, 1, "valid", 2, 1, "NCHW"),
    (3, 1, 1, 1, 4, "NCHW"),
    (1, 2, 0, 1, 1, "NCHW"),
    (3, 2, 1, 1, 2, "NHWC"),             # NHWC takes an HWIO weight
]


@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[
    f"k{c[0]}-s{c[1]}-p{c[2]}-d{c[3]}-g{c[4]}-{c[5]}" for c in CONV_CASES])
def test_conv2d_forward_and_grads(case, name):
    k, stride, padding, dilation, groups, fmt = case
    jd, td = DT[name]
    rng = np.random.RandomState(0)
    cin, cout = 8, 12
    x = rng.randn(2, cin, 9, 11).astype(np.float32)
    w = (rng.randn(cout, cin // groups, k, k) * 0.3).astype(np.float32)
    if fmt == "NHWC":
        x, w = x.transpose(0, 2, 3, 1), w.transpose(2, 3, 1, 0)
    jpad = padding.upper() if isinstance(padding, str) else \
        jops._pair(padding)

    def jconv(xa, wa):
        return jops._conv2d_plain(xa, wa, stride=jops._pair(stride),
                                  padding=jpad, dilation=jops._pair(dilation),
                                  groups=groups, data_format=fmt)

    # the weight stays fp32: _conv_dtype casts it to the stream's dtype
    want, vjp = jax.vjp(jconv, jnp.asarray(x, jd), jnp.asarray(w))
    g = rng.randn(*want.shape).astype(np.float32)
    wdx, wdw = vjp(jnp.asarray(g, jd))
    xt, wt = _t(x, td, True), _t(w, torch.float32, True)
    got = nn_ops.conv2d(xt, wt, stride, padding, dilation, groups, fmt)
    assert got.dtype == td and tuple(got.shape) == want.shape
    got.backward(_t(g, td))
    assert xt.grad.dtype == td and wt.grad.dtype == torch.float32
    _hold(got, want, name)
    _hold(xt.grad, wdx, name)
    _hold(wt.grad, wdw, name, atol=1e-4)   # sums over 2 * 9 * 11 positions


def test_conv2d_layer_and_bias():
    """``Conv2D``: OIHW weight, Kaiming-uniform bound sqrt(6 / fan_in),
    bias bound 1 / sqrt(fan_in), none with ``bias_attr=False``; the bias
    added as ``paddle_tpu``'s ``F.conv2d`` adds it."""
    gen = torch.Generator().manual_seed(0)
    layer = pnn.Conv2D(8, 16, 3, stride=2, padding=1, groups=2,
                       device="cpu", generator=gen)
    assert tuple(layer.weight.shape) == (16, 4, 3, 3)
    fan_in = 8 * 9 // 2
    wmax, bmax = float(_np(layer.weight).max()), float(_np(layer.bias).max())
    assert 0.9 * np.sqrt(6 / fan_in) < wmax <= np.sqrt(6 / fan_in)
    assert bmax <= 1 / np.sqrt(fan_in)
    assert pnn.Conv2D(8, 16, 3, bias_attr=False, device="cpu").bias is None
    # the initializers as objects (KaimingUniform's own fan rule: in * kh
    # * kw of an OIHW weight)
    t = torch.empty(16, 4, 3, 3)
    assert torch.equal(pinit.Constant(0.5)(t), torch.full_like(t, 0.5))
    pinit.KaimingUniform()(t, gen)
    assert 0.9 * np.sqrt(6 / 36) < float(t.max()) <= np.sqrt(6 / 36)
    x = np.random.RandomState(1).randn(2, 8, 7, 7).astype(np.float32)
    want = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(_np(
        layer.weight)), paddle.to_tensor(_np(layer.bias)), stride=2,
        padding=1, groups=2)
    with torch.no_grad():
        got = layer(_t(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)


def _relu_ties(shape, seed):
    """A ReLU'd input: about half the entries 0, so most 3x3 windows hold
    ties, and whole windows of zeros occur."""
    return np.maximum(np.random.RandomState(seed).randn(*shape), 0).astype(
        np.float32)


@pytest.mark.parametrize("case", [(3, 2, 1), (2, 2, 0), (3, 1, 1),
                                  (5, 2, 3)],
                         ids=["k3s2p1", "k2s2p0", "k3s1p1", "k5s2p3-wide"])
def test_max_pool2d_with_ties(case):
    k, s, p = case
    x = _relu_ties((2, 3, 12, 12), 3)
    x[0, 0] = 0.0                           # a plane of ties only
    want, vjp = jax.vjp(lambda a: jops._max_pool2d_plain(
        a, (k, k), (s, s), (p, p)), jnp.asarray(x))
    g = np.random.RandomState(4).randn(*want.shape).astype(np.float32)
    (wdx,) = vjp(jnp.asarray(g))
    xt = _t(x, grad=True)
    got = nn_ops.max_pool2d(xt, k, s, p)
    got.backward(_t(g))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(xt.grad), _np(wdx))
    # NHWC and the layer
    got = pnn.MaxPool2D(k, s, p, data_format="NHWC")(
        _t(x.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(_np(got), _np(want).transpose(0, 2, 3, 1))


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("case", [(3, 2, 1), (2, 2, 0), (3, 1, 2)],
                         ids=["k3s2p1", "k2s2p0", "k3s1p2-wide"])
def test_avg_pool2d(case, exclusive):
    k, s, p = case
    x = np.random.RandomState(5).randn(2, 3, 11, 11).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jops._avg_pool2d_plain(
        a, (k, k), (s, s), (p, p), exclusive=exclusive), jnp.asarray(x))
    g = np.random.RandomState(6).randn(*want.shape).astype(np.float32)
    (wdx,) = vjp(jnp.asarray(g))
    xt = _t(x, grad=True)
    got = pnn.AvgPool2D(k, s, p, exclusive=exclusive)(xt)
    got.backward(_t(g))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-6)
    np.testing.assert_allclose(_np(xt.grad), _np(wdx), rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("out", [(1, 1), (3, 3), (5, 3), 4],
                         ids=["1x1", "3x3", "5x3-uneven", "4"])
def test_adaptive_avg_pool2d(out, name):
    """Both branches: the divisible reshape-mean (14 -> 1, 7) and the
    interval averages (14 -> 3, 5; 10 -> 3, 4); bf16 means exact."""
    jd, td = DT[name]
    x = np.random.RandomState(7).randn(2, 3, 14, 10).astype(np.float32)
    xj = jnp.asarray(x, jd)
    want, vjp = jax.vjp(lambda a: jops._adaptive_avg_pool2d_plain(
        a, jops._pair(out)), xj)
    g = np.random.RandomState(8).randn(*want.shape).astype(np.float32)
    (wdx,) = vjp(jnp.asarray(g, jd))
    xt = _t(_np(xj), td, True)
    got = pnn.AdaptiveAvgPool2D(out)(xt)
    got.backward(_t(g, td))
    assert got.dtype == td
    if name == "fp32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-6)
        np.testing.assert_allclose(_np(xt.grad), _np(wdx), rtol=0,
                                   atol=2e-6)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))
        assert _rel(xt.grad, wdx) <= 2e-2


def _bn_inputs(shape, seed=9):
    rng = np.random.RandomState(seed)
    c = shape[1]
    x = (3 + 2 * rng.randn(*shape)).astype(np.float32)
    w = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, w, b, g


def _bn_close(got, want, name):
    got, want = _np(got), _np(want)
    if name == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * 2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("name", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (8, 6)],
                         ids=["NCHW", "NC"])
def test_batch_norm_train_matches_fused_op(shape, name):
    """``_bn_train_fwd`` / ``_bn_train_bwd`` against the port's fused op:
    y, the fp32 batch statistics, dx, dgamma and dbeta (in w's dtype)."""
    jd, td = DT[name]
    x, w, b, g = _bn_inputs(shape)
    xj = jnp.asarray(x, jd)
    (wy, wm, wv), saved = jops._bn_train_fwd(
        xj, jnp.asarray(w, jd), jnp.asarray(b, jd))
    wdx, wdw, wdb = jops._bn_train_bwd(saved, (jnp.asarray(g, jd), None,
                                               None))
    xt = _t(_np(xj), td, True)
    wt, bt = _t(w, td, True), _t(b, td, True)
    y, m, v = nn_ops.batch_norm_train(xt, wt, bt)
    assert y.dtype == td and m.dtype == v.dtype == torch.float32
    assert not m.requires_grad and not v.requires_grad
    y.backward(_t(g, td))
    np.testing.assert_allclose(_np(m), _np(wm), rtol=1e-5)
    np.testing.assert_allclose(_np(v), _np(wv), rtol=1e-5)
    _bn_close(y, wy, name)
    _bn_close(xt.grad, wdx, name)
    assert wt.grad.dtype == bt.grad.dtype == td
    _bn_close(wt.grad, wdw, name)
    _bn_close(bt.grad, wdb, name)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_batch_norm_infer_and_stats(name):
    jd, td = DT[name]
    x, w, b, _ = _bn_inputs((4, 6, 5, 5))
    xj = jnp.asarray(x, jd)
    rm = np.linspace(2, 4, 6).astype(np.float32)
    rv = np.linspace(1, 5, 6).astype(np.float32)
    want = jops._batch_norm_infer(xj, jnp.asarray(rm), jnp.asarray(rv),
                                  jnp.asarray(w), jnp.asarray(b))
    got = nn_ops.batch_norm_infer(_t(_np(xj), td), _t(rm), _t(rv), _t(w),
                                  _t(b))
    assert got.dtype == td
    _bn_close(got, want, name)
    wm, wv = jops._batch_norm_stats(xj)
    gm, gv = nn_ops.batch_norm_stats(_t(_np(xj), td))
    assert gm.dtype == gv.dtype == td
    if name == "fp32":
        np.testing.assert_allclose(_np(gm), _np(wm), rtol=1e-6)
        np.testing.assert_allclose(_np(gv), _np(wv), rtol=1e-5)
    else:
        np.testing.assert_array_equal(_np(gm), _np(wm))
        np.testing.assert_array_equal(_np(gv), _np(wv))


@pytest.mark.parametrize("route", ["fused", "stats", "global"])
def test_batch_norm_layer_and_running_update(route):
    """``BatchNorm2D`` in training mode against ``paddle_tpu``'s, eagerly:
    the output, and the running statistics after two forwards (momentum
    0.9, the biased batch variance); the stats route (no affine
    parameters) and ``use_global_stats`` too.  Then eval mode reads the
    running statistics."""
    x, _, _, _ = _bn_inputs((4, 6, 5, 5))
    x2 = x[::-1] * 0.5 + 1
    kw = dict(weight_attr=False, bias_attr=False) if route == "stats" \
        else dict(use_global_stats=True) if route == "global" else {}
    jl, pl = jnn.BatchNorm2D(6, **kw), pnn.BatchNorm2D(6, device="cpu", **kw)
    assert (pl._momentum, pl._epsilon) == (0.9, 1e-5)
    names = {k for k, _ in pl.named_buffers()}
    assert names == {"_mean", "_variance"}
    assert pl._mean.dtype == pl._variance.dtype == torch.float32
    jl.train()
    pl.train()
    for a in (x, x2):
        want = jl(paddle.to_tensor(a))
        with torch.no_grad():
            got = pl(_t(a))
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-5)
    np.testing.assert_allclose(_np(pl._mean), _np(jl._mean), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_np(pl._variance), _np(jl._variance),
                               rtol=0, atol=1e-6)
    if route == "global":
        assert torch.equal(pl._mean, torch.zeros(6))
    else:
        assert not torch.equal(pl._mean, torch.zeros(6))
    jl.eval()
    pl.eval()
    np.testing.assert_allclose(_np(pl(_t(x))), _np(jl(paddle.to_tensor(x))),
                               rtol=0, atol=2e-5)
    old = pl(_t(x))
    pl.stats_frozen = True          # frozen only matters in training
    assert torch.equal(pl(_t(x)), old)


def test_batch_norm_old_style_and_nd():
    x = _bn_inputs((4, 6, 7))[0]
    jl, pl = jnn.BatchNorm1D(6), pnn.BatchNorm1D(6, device="cpu")
    np.testing.assert_allclose(_np(pl(_t(x))), _np(jl(paddle.to_tensor(x))),
                               rtol=0, atol=2e-5)
    x = _bn_inputs((4, 6, 5, 5))[0]
    jl = jnn.BatchNorm(6, act="relu")
    pl = pnn.BatchNorm(6, act="relu", device="cpu")
    np.testing.assert_allclose(_np(pl(_t(x))), _np(jl(paddle.to_tensor(x))),
                               rtol=0, atol=2e-5)


def _ce_inputs(n=6, v=10, seed=10):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(n, v)).astype(np.float32)
    labels = rng.randint(0, v, (n,)).astype(np.int64)
    return logits, labels


def _j_loss_and_grad(fn, x, *args, **kw):
    xt = paddle.to_tensor(x, stop_gradient=False)
    loss = fn(xt, *args, **kw)
    loss.backward()
    return _np(loss), _np(xt.grad)


def _p_loss_and_grad(fn, x, *args, **kw):
    xt = _t(x, grad=True)
    loss = fn(xt, *args, **kw)
    loss.backward()
    return _np(loss), _np(xt.grad)


CE_CASES = {
    "plain": dict(),
    "ignore-100": dict(ignored=-100),
    "ignore3": dict(ignored=3, ignore_index=3),
    "smoothing": dict(label_smoothing=0.1),
    "sum": dict(reduction="sum", ignored=-100),
    "weight": dict(weight=True),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_and_grad(case):
    kw = dict(CE_CASES[case])
    logits, labels = _ce_inputs()
    ignored = kw.pop("ignored", None)
    if ignored is not None:
        labels[[1, 4]] = ignored
    jkw, pkw = dict(kw), dict(kw)
    if kw.pop("weight", False):
        w = np.linspace(0.5, 2, 10).astype(np.float32)
        jkw["weight"], pkw["weight"] = paddle.to_tensor(w), _t(w)
    jl, jg = _j_loss_and_grad(JF.cross_entropy, logits,
                              paddle.to_tensor(labels), **jkw)
    pl, pg = _p_loss_and_grad(PF.cross_entropy, logits,
                              torch.from_numpy(labels), **pkw)
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    np.testing.assert_allclose(pg, jg, rtol=1e-6, atol=1e-7)
    if ignored is not None:
        assert np.all(pg[[1, 4]] == 0)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_softmax_with_cross_entropy_op(name):
    """The op itself: fp32 loss ``[N, 1]``; the gradient of bf16 logits
    in bf16; soft labels."""
    jd, td = DT[name]
    logits, labels = _ce_inputs()
    labels[2] = -100
    lj = jnp.asarray(logits, jd)
    want, saved = jops._softmax_ce_fwd(lj, jnp.asarray(labels))
    g = np.random.RandomState(11).rand(6, 1).astype(np.float32)
    (wdl, _) = jops._softmax_ce_bwd(saved, jnp.asarray(g))
    xt = _t(_np(lj), td, True)
    got = nn_ops.softmax_with_cross_entropy(xt, torch.from_numpy(labels))
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 1)
    got.backward(_t(g))
    assert xt.grad.dtype == td
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    if name == "fp32":
        np.testing.assert_allclose(_np(xt.grad), _np(wdl), rtol=1e-6,
                                   atol=1e-7)
    else:       # the fp32 gradient rounded once to bf16
        np.testing.assert_array_equal(_np(xt.grad), _np(
            jnp.asarray(wdl, jnp.bfloat16)))
    soft = np.random.RandomState(12).dirichlet(np.ones(10), 6).astype(
        np.float32)
    want, saved = jops._softmax_ce_fwd(jnp.asarray(logits),
                                       jnp.asarray(soft), soft_label=True)
    (wdl, _) = jops._softmax_ce_bwd(saved, jnp.asarray(g), soft_label=True)
    xt = _t(logits, grad=True)
    got = nn_ops.softmax_with_cross_entropy(xt, _t(soft), soft_label=True)
    got.backward(_t(g))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), _np(wdl), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["plain", "pos_weight", "weight-none"])
def test_bce_with_logits_and_grad(case):
    rng = np.random.RandomState(13)
    x = (4 * rng.randn(4, 5, 3, 3)).astype(np.float32)
    y = (rng.rand(4, 5, 3, 3) > 0.8).astype(np.float32)
    jkw, pkw = {}, {}
    if case == "pos_weight":
        pw = np.linspace(0.5, 3, 3).astype(np.float32)
        jkw["pos_weight"], pkw["pos_weight"] = paddle.to_tensor(pw), _t(pw)
    if case == "weight-none":
        w = rng.rand(4, 5, 3, 3).astype(np.float32)
        jkw.update(weight=paddle.to_tensor(w), reduction="none")
        pkw.update(weight=_t(w), reduction="none")

    def jfn(a, t, **kw):
        out = JF.binary_cross_entropy_with_logits(a, t, **kw)
        return out if out.ndim == 0 else paddle.sum(out)

    def pfn(a, t, **kw):
        out = PF.binary_cross_entropy_with_logits(a, t, **kw)
        return out if out.dim() == 0 else out.sum()

    jl, jg = _j_loss_and_grad(jfn, x, paddle.to_tensor(y), **jkw)
    pl, pg = _p_loss_and_grad(pfn, x, _t(y), **pkw)
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    np.testing.assert_allclose(pg, jg, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_means_round_once(name):
    """``mean_fp32acc`` against ``jnp.mean``: bf16 sums in fp32 and rounds
    once (the adaptive pool, and the L1 term's mean in bench.py's
    detector)."""
    jd, td = DT[name]
    x = jnp.asarray(np.random.RandomState(14).randn(64, 7, 9) + 0.3, jd)
    want = jnp.mean(x, axis=(1, 2))
    got = nn_ops.mean_fp32acc(_t(_np(x), td), (1, 2))
    whole = nn_ops.mean_fp32acc(_t(_np(x), td))
    assert got.dtype == whole.dtype == td
    if name == "fp32":      # sums in other orders
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
        np.testing.assert_allclose(_np(whole), _np(jnp.mean(x)), rtol=1e-6)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(whole), _np(jnp.mean(x)))
