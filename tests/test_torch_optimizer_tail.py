"""The rest of the port's optimizers and the incubate surface against
``paddle_tpu`` on the CPU, on the same seeded numpy inputs.

* ``Adamax``, ``NAdam``, ``RAdam``, ``Adadelta``, ``Rprop`` and ``ASGD``:
  the same fp32 parameters and seeded gradients for 5 steps; after every
  step the parameters and every accumulator (host slots too) agree
  within rtol 1e-6, atol 1e-6 times the tensor's largest magnitude, as
  ``tests/test_torch_optimizer.py`` holds the core family.
* ``LBFGS`` (plain and ``strong_wolfe``) on a float64 least-squares
  closure, 3 outer steps: the losses and parameters within 1e-6
  relative, the same number of evaluations.
* ``paddle.regularizer``, ``incubate.ExponentialMovingAverage``,
  ``LookAhead`` and ``ModelAverage`` over 5 steps: parameters and
  averaged values within 1e-6.
* ``incubate.nn``: ``FusedMultiHeadAttention``, ``FusedFeedForward`` and
  ``FusedTransformerEncoderLayer`` (pre- and post-LN, dropout 0) with
  the reference's weights, outputs and input gradients within 2e-5 of
  the largest magnitude; the fused functional ops and
  ``softmax_mask_fuse`` / ``identity_loss`` within 2e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu_torch as paddle

SHAPES = [(4, 3), (3,), (2, 2, 3)]
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().copy()
    if hasattr(a, "_data"):
        a = a._data
    return np.array(jnp.asarray(a, jnp.float32))


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _params(seed=0):
    rng = np.random.RandomState(seed)
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    return ([ref.EagerParamBase(v) for v in vals],
            [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals])


OPTIMIZERS = {
    "adamax": lambda o, p: o.Adamax(learning_rate=0.02, parameters=p),
    "adamax_l2": lambda o, p: o.Adamax(learning_rate=0.02, parameters=p,
                                       weight_decay=0.01),
    "nadam": lambda o, p: o.NAdam(learning_rate=0.02, parameters=p),
    "radam": lambda o, p: o.RAdam(learning_rate=0.02, parameters=p),
    "adadelta": lambda o, p: o.Adadelta(learning_rate=1.0, rho=0.9,
                                        parameters=p),
    "rprop": lambda o, p: o.Rprop(learning_rate=0.01, parameters=p),
    "asgd": lambda o, p: o.ASGD(learning_rate=0.05, batch_num=3,
                                parameters=p, weight_decay=0.01),
    "regularizer_l1": lambda o, p: o.Adamax(
        learning_rate=0.02, parameters=p,
        weight_decay=(ref if o is ref.optimizer else paddle)
        .regularizer.L1Decay(0.05)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    jp, pp = _params()
    jo = OPTIMIZERS[name](ref.optimizer, jp)
    po = OPTIMIZERS[name](paddle.optimizer, pp)
    rng = np.random.RandomState(1)
    for step in range(5):
        for a, b in zip(jp, pp):
            g = rng.randn(*a.shape).astype(np.float32)
            if name == "rprop" and step % 2:
                g = -g                      # sign flips take their branch
            a.grad = ref.to_tensor(g)
            b.grad = torch.from_numpy(g)
        jo.step()
        po.step()
        for a, b in zip(jp, pp):
            _close(b, a)
            ja, pa = jo._accumulators.get(id(a), {}), \
                po._accumulators.get(id(b), {})
            assert set(ja) == set(pa), (set(ja), set(pa))
            for k in ja:
                if isinstance(pa[k], torch.Tensor):
                    assert str(pa[k].dtype).replace("torch.", "") == \
                        str(jnp.asarray(ja[k]).dtype), k
                    _close(pa[k], ja[k])
                else:
                    assert float(pa[k]) == pytest.approx(
                        float(np.asarray(ja[k])), rel=1e-12), k


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_reference(line_search):
    """Least squares ``|A w - y|^2`` through a closure, 3 outer steps,
    in float64 (in fp32 the two packages' last-bit differences in the
    loss's sums grow through the line search)."""
    rng = np.random.RandomState(3)
    a, y, w0 = rng.randn(20, 4), rng.randn(20), rng.randn(4)
    res = {}
    for P in (ref, paddle):
        w = P.create_parameter([4], "float64") if P is ref else \
            torch.nn.Parameter(torch.from_numpy(w0.copy()))
        if P is ref:
            w.set_value(ref.to_tensor(w0))
        at, yt = P.to_tensor(a), P.to_tensor(y)
        opt = P.optimizer.LBFGS(learning_rate=1.0, max_iter=5,
                                history_size=3, line_search_fn=line_search,
                                parameters=[w])

        def closure(P=P, opt=opt, w=w, at=at, yt=yt):
            opt.clear_grad()
            loss = ((P.matmul(at, w) - yt) ** 2).mean()
            loss.backward()
            return loss

        losses = [float(opt.step(closure)) for _ in range(3)]
        res[P.__name__] = (losses, _np(w), opt._state["func_evals"],
                           opt.state_dict()["H_diag"])
    (jl, jw, je, jh), (pl, pw, pe, ph) = res["paddle_tpu"], \
        res["paddle_tpu_torch"]
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    _close(pw, jw)
    assert pe == je
    assert ph == pytest.approx(jh, rel=1e-6)


def test_ema_lookahead_model_average_match_reference():
    jp, pp = _params(seed=2)
    outs = {}
    for P, ps in ((ref, jp), (paddle, pp)):
        opt = P.optimizer.Adam(learning_rate=0.05, parameters=ps)
        la = P.incubate.LookAhead(P.optimizer.SGD(learning_rate=0.1,
                                                  parameters=ps), 0.4, k=2)
        ema = P.incubate.ExponentialMovingAverage(ps, decay=0.9)
        avg = P.incubate.ModelAverage(0.5, parameters=ps,
                                      min_average_window=2,
                                      max_average_window=3)
        rng = np.random.RandomState(4)
        for _ in range(5):
            for q in ps:
                g = rng.randn(*q.shape).astype(np.float32)
                q.grad = ref.to_tensor(g) if P is ref else torch.from_numpy(g)
            opt.step()
            la.step()
            ema.update()
            avg.step()
        got = [_np(q) for q in ps]
        ema.apply()
        got += [_np(q) for q in ps]
        ema.restore()
        with avg.apply():
            got += [_np(q) for q in ps]
        got += [_np(q) for q in ps]
        outs[P.__name__] = got
    for g, w in zip(outs["paddle_tpu_torch"], outs["paddle_tpu"]):
        _close(g, w)
    assert paddle.regularizer.L2Decay is paddle.optimizer.L2Decay


def _copy_weights(pm, jm):
    """The reference layer's parameters, by name, into the port's."""
    want = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    sd = pm.state_dict()
    assert set(sd) == set(want), (set(sd) ^ set(want))
    with torch.no_grad():
        for k, v in sd.items():
            v.copy_(torch.from_numpy(want[k]))


@pytest.mark.parametrize("layer", ["mha_post", "mha_pre", "ffn",
                                   "encoder_pre"])
def test_fused_layers_match_reference(layer):
    d, h, f = 16, 4, 32
    make = {
        "mha_post": lambda M: M.FusedMultiHeadAttention(d, h),
        "mha_pre": lambda M: M.FusedMultiHeadAttention(
            d, h, normalize_before=True),
        "ffn": lambda M: M.FusedFeedForward(d, f, dropout_rate=0.0,
                                            activation="gelu"),
        "encoder_pre": lambda M: M.FusedTransformerEncoderLayer(
            d, h, f, dropout_rate=0.0, activation="gelu",
            normalize_before=True),
    }[layer]
    ref.seed(5)
    jm = make(ref.incubate.nn)
    pm = make(paddle.incubate.nn)
    _copy_weights(pm, jm)
    x = np.random.RandomState(6).randn(2, 8, d).astype(np.float32)
    jx = ref.to_tensor(x, stop_gradient=False)
    px = paddle.to_tensor(x, stop_gradient=False)
    jo, po = jm(jx), pm(px)
    _close(po, jo, rtol=2e-5)
    # a weighted sum: the sum of squares of a post-LN output is constant
    wgt = np.random.RandomState(8).randn(2, 8, d).astype(np.float32)
    (jo * ref.to_tensor(wgt)).sum().backward()
    (po * paddle.to_tensor(wgt)).sum().backward()
    _close(px.grad, jx.grad, rtol=2e-5)


def test_fused_functional_ops_match_reference():
    rng = np.random.RandomState(7)
    x, w = rng.randn(3, 5, 8).astype(np.float32), rng.randn(8).astype(
        np.float32)
    q, k = (rng.randn(2, 6, 2, 8).astype(np.float32) for _ in range(2))
    ang = np.arange(6)[:, None] * rng.rand(1, 8)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    lw, lb = rng.randn(8, 4).astype(np.float32), rng.randn(4).astype(
        np.float32)
    mask = np.where(rng.rand(3, 5, 8) > 0.3, 0, -1e4).astype(np.float32)
    res = {}
    for P in (ref, paddle):
        IF = P.incubate.nn.functional
        t = P.to_tensor
        out = [IF.fused_rms_norm(t(x), t(w), 1e-6),
               *IF.fused_rotary_position_embedding(t(q), t(k), sin=t(sin),
                                                   cos=t(cos))[:2],
               IF.swiglu(t(x), t(x) * 2),
               IF.fused_linear(t(x), t(lw), t(lb)),
               IF.fused_bias_act(t(x), t(w), act_method="gelu"),
               P.incubate.softmax_mask_fuse(t(x), t(mask)),
               P.incubate.softmax_mask_fuse_upper_triangle(t(x[:, :, :5])),
               P.incubate.identity_loss(t(x), "mean"),
               P.incubate.identity_loss(t(x), 1)]
        res[P.__name__] = out
    for g, w_ in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        _close(g, w_, rtol=2e-6)
