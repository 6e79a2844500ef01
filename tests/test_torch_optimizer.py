"""The optimizer family of the PyTorch port against ``paddle_tpu``.

The same fp32 parameters and the same seeded gradients go into each of
``paddle_tpu``'s optimizers and its port for 5 steps; after every step
the parameters and every accumulator (and master weight) agree within
rtol 1e-6, atol 1e-6 times the tensor's largest magnitude (both
packages round at the same points in fp32; an element much smaller than
its neighbours, after a subtraction, keeps their last-bit differences,
so it compares against the tensor's scale).  With master weights over
bf16 parameters, the fp32 masters agree within rtol 1e-6 and the bf16
parameters within one bf16 ulp.  The state dict crosses both ways
through ``models.convert`` and both packages continue to the same
parameters.  Counterparts of ``tests/test_nn_optimizer.py:93-195`` close
the file.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import (optimizer_state_to_port,
                                     optimizer_state_to_reference)

SHAPES = [(4, 3), (3,), (2, 2, 3)]
RTOL = 1e-6


def _close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_data"):
        a = a._data
    return np.array(jnp.asarray(a, jnp.float32))


def _params(seed=0, dtype=np.float32, names=False):
    rng = np.random.RandomState(seed)
    vals = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jp = [paddle.EagerParamBase(v) for v in vals]
    pp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
    if dtype != np.float32:
        for q in jp:
            q._data = q._data.astype(jnp.bfloat16)
        for q in pp:
            q.data = q.data.to(torch.bfloat16)
    if names:
        for i, (a, b) in enumerate(zip(jp, pp)):
            a.name = b.param_name = ("bias_" if i == 1 else "w_") + str(i)
    return jp, pp


def _grads(rng, jp, pp):
    for a, b in zip(jp, pp):
        g = rng.randn(*a.shape).astype(np.float32)
        a.grad = paddle.to_tensor(g).astype(a.dtype)
        b.grad = torch.from_numpy(g).to(b.dtype)


def _check_state(jo, po, jp, pp, master=False):
    for a, b in zip(jp, pp):
        if master:
            _close(po._master_weights[id(b)], jo._master_weights[id(a)])
            got, want = _np(b), _np(a)
            ulp = np.abs(want) * 2.0 ** -7 + 1e-30
            assert (np.abs(got - want) <= ulp).all()
        else:
            _close(b, a)
        ja, pa = jo._accumulators.get(id(a), {}), po._accumulators.get(
            id(b), {})
        assert set(ja) == set(pa)
        for k in ja:
            if k == "_t":
                assert int(np.asarray(ja[k])) == pa[k]
            else:
                assert str(pa[k].dtype).replace("torch.", "") == \
                    str(jnp.asarray(ja[k]).dtype)
                _close(pa[k], ja[k])


def _run(make, steps=5, seed=1, dtype=np.float32, names=False, **kw):
    jp, pp = _params(dtype=dtype, names=names)
    jo, po = make(jopt, jnn, jp, **kw), make(popt, pnn, pp, **kw)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        _grads(rng, jp, pp)
        jo.step()
        po.step()
        _check_state(jo, po, jp, pp, master=dtype != np.float32)
    return jo, po, jp, pp


CASES = {
    "sgd": lambda o, n, p: o.SGD(learning_rate=0.1, parameters=p),
    "sgd_l2": lambda o, n, p: o.SGD(learning_rate=0.1, parameters=p,
                                    weight_decay=0.05),
    "sgd_l1": lambda o, n, p: o.SGD(learning_rate=0.1, parameters=p,
                                    weight_decay=o.L1Decay(0.05)),
    "momentum": lambda o, n, p: o.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=p,
        weight_decay=o.L2Decay(1e-4)),
    "nesterov": lambda o, n, p: o.Momentum(
        learning_rate=0.05, momentum=0.8, parameters=p, use_nesterov=True),
    "adagrad": lambda o, n, p: o.Adagrad(
        learning_rate=0.1, parameters=p, initial_accumulator_value=0.1),
    "rmsprop": lambda o, n, p: o.RMSProp(learning_rate=0.01, parameters=p),
    "rmsprop_momentum": lambda o, n, p: o.RMSProp(
        learning_rate=0.01, momentum=0.9, parameters=p),
    "adam": lambda o, n, p: o.Adam(learning_rate=0.01, parameters=p),
    "adam_l2": lambda o, n, p: o.Adam(learning_rate=0.01, parameters=p,
                                      weight_decay=0.01),
    "adamw": lambda o, n, p: o.AdamW(learning_rate=0.01, parameters=p,
                                     weight_decay=0.1),
    "lamb": lambda o, n, p: o.Lamb(learning_rate=0.01, parameters=p),
    "lars": lambda o, n, p: o.LarsMomentum(learning_rate=0.1,
                                           parameters=p),
    "clip_value": lambda o, n, p: o.SGD(
        learning_rate=0.1, parameters=p, grad_clip=n.ClipGradByValue(0.5)),
    "clip_norm": lambda o, n, p: o.Momentum(
        learning_rate=0.1, parameters=p, grad_clip=n.ClipGradByNorm(1.0)),
    "clip_global_norm": lambda o, n, p: o.Adam(
        learning_rate=0.01, parameters=p,
        grad_clip=n.ClipGradByGlobalNorm(1.0)),
    "groups": lambda o, n, p: o.Momentum(
        learning_rate=0.1, parameters=[
            {"params": p[:1], "learning_rate": 0.5,
             "weight_decay": 0.01},
            {"params": p[1:]}]),
    "scheduler": lambda o, n, p: o.Adam(
        learning_rate=o.lr.StepDecay(0.01, step_size=1, gamma=0.5),
        parameters=p),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_and_accumulators_match(case):
    make = CASES[case]
    if case == "scheduler":
        jp, pp = _params()
        jo, po = make(jopt, jnn, jp), make(popt, pnn, pp)
        rng = np.random.RandomState(1)
        for _ in range(5):
            _grads(rng, jp, pp)
            jo.step()
            po.step()
            _check_state(jo, po, jp, pp)
            jo._learning_rate.step()
            po._learning_rate.step()
            assert po.get_lr() == jo.get_lr()
        return
    _run(make)


def test_optimize_attr_learning_rate():
    def make(o, n, p):
        p[0].optimize_attr = {"learning_rate": 0.25}
        return o.Adam(learning_rate=0.01, parameters=p)
    _run(make)


def test_adamw_decay_fun_and_lr_ratio_see_names():
    seen = {"ref": [], "port": []}

    def make(o, n, p):
        tag = "port" if o is popt else "ref"

        def decay(name):
            seen[tag].append(name)
            return not name.startswith("bias")
        return o.AdamW(learning_rate=0.01, parameters=p, weight_decay=0.1,
                       apply_decay_param_fun=decay,
                       lr_ratio=lambda q: 0.5 if q.ndim == 1 else 1.0)
    _run(make, names=True)
    assert seen["port"] == seen["ref"] and "bias_1" in seen["port"]


def test_lamb_exclude_fn():
    _run(lambda o, n, p: o.Lamb(
        learning_rate=0.01, parameters=p,
        exclude_from_weight_decay_fn=lambda q: q.ndim == 1))


@pytest.mark.parametrize("case", ["momentum", "adam", "adamw", "lars"])
def test_master_weights_over_bf16(case):
    make = CASES[case]

    def with_master(o, n, p):
        opt = make(o, n, p)
        opt._use_master_weights = True
        return opt
    jo, po, jp, pp = _run(with_master, dtype="bfloat16")
    assert all(q.dtype == torch.bfloat16 for q in pp)
    assert all(m.dtype == torch.float32 for m in po._master_weights.values())


def _continue(jo, po, jp, pp, steps=3, seed=7):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        _grads(rng, jp, pp)
        jo.step()
        po.step()
        _check_state(jo, po, jp, pp)


@pytest.mark.parametrize("case", ["momentum", "adam", "adamw"])
def test_state_dict_from_reference_continues_equal(case):
    """The reference trains 2 steps; its state goes into a fresh port
    optimizer over the reference's parameters' values; both continue."""
    make = CASES[case]
    jp, _ = _params()
    jo = make(jopt, jnn, jp)
    rng = np.random.RandomState(3)
    for _ in range(2):
        for a in jp:
            a.grad = paddle.to_tensor(rng.randn(*a.shape).astype(
                np.float32))
        jo.step()
    pp = [torch.nn.Parameter(torch.from_numpy(_np(a).copy())) for a in jp]
    po = make(popt, pnn, pp)
    ref_names = [a.name or f"param_{i}" for i, a in enumerate(jp)]
    po.set_state_dict(optimizer_state_to_port(jo.state_dict(), ref_names,
                                              po._param_names()))
    assert po._global_step == jo._global_step == 2
    _check_state(jo, po, jp, pp)
    _continue(jo, po, jp, pp)


@pytest.mark.parametrize("case", ["momentum", "adam"])
def test_state_dict_to_reference_continues_equal(case):
    make = CASES[case]
    _, pp = _params(names=True)
    po = make(popt, pnn, pp)
    rng = np.random.RandomState(4)
    for _ in range(2):
        for b in pp:
            b.grad = torch.from_numpy(rng.randn(*b.shape).astype(
                np.float32))
        po.step()
    jp = [paddle.EagerParamBase(_np(b).copy()) for b in pp]
    for a in jp:
        a.name = ""
    jo = make(jopt, jnn, jp)
    ref_names = [f"param_{i}" for i in range(len(jp))]
    state = optimizer_state_to_reference(po.state_dict(),
                                         po._param_names(), ref_names)
    assert all(isinstance(v, np.ndarray) for v in
               state["accumulators"].values())
    jo.set_state_dict(state)
    _check_state(jo, po, jp, pp)
    _continue(jo, po, jp, pp)


def test_state_dict_round_trip_within_the_port():
    _, pp = _params()
    po = popt.Adam(learning_rate=0.01, parameters=pp)
    for b in pp:
        b.grad = torch.ones_like(b)
    po.step()
    state = po.state_dict()
    assert state["global_step"] == 1
    assert set(state["accumulators"]) == {
        f"param_{i}.{s}" for i in range(3)
        for s in ("moment1", "moment2", "_t")}
    po2 = popt.Adam(learning_rate=0.01, parameters=pp)
    po2.set_state_dict(state)
    assert po2.state_dict()["global_step"] == 1
    for k, v in po2.state_dict()["accumulators"].items():
        want = state["accumulators"][k]
        assert v == want if k.endswith("_t") else torch.equal(v, want)


def test_not_ported_optimizers_name_their_item():
    for cls in (popt.LBFGS, popt.Adamax, popt.NAdam, popt.RAdam,
                popt.Adadelta, popt.Rprop, popt.ASGD):
        with pytest.raises(NotImplementedError, match="item 9"):
            cls(parameters=[])


# -- counterparts of tests/test_nn_optimizer.py ------------------------------

def test_sgd_converges_linear_regression():
    w_true = np.array([[2.0], [-3.0]], np.float32)
    x = torch.from_numpy(np.random.RandomState(0).rand(64, 2).astype(
        np.float32))
    y = x @ torch.from_numpy(w_true) + 0.5
    model = pnn.Linear(2, 1, device="cpu")
    with torch.no_grad():
        model.weight.zero_()
        model.bias.zero_()
    opt = popt.SGD(learning_rate=0.5, parameters=model.parameters())
    for _ in range(200):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert loss.item() < 1e-3
    np.testing.assert_allclose(model.weight.detach().numpy(), w_true,
                               atol=0.05)


def test_adam_and_adamw_step():
    for cls in (popt.Adam, popt.AdamW):
        model = pnn.Linear(4, 4, device="cpu")
        torch.nn.init.ones_(model.weight)
        torch.nn.init.zeros_(model.bias)
        opt = cls(learning_rate=0.01, parameters=model.parameters())
        before = model.weight.detach().clone()
        (model(torch.ones(2, 4)) ** 2).sum().backward()
        opt.step()
        opt.clear_grad()
        assert not torch.allclose(model.weight, before)
        assert model.weight.grad is None


def test_momentum_matches_reference_formula():
    p0 = np.array([1.0], np.float32)
    g = np.array([0.5], np.float32)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    p.grad = torch.from_numpy(g)
    opt = popt.Momentum(learning_rate=0.1, momentum=0.9, parameters=[p])
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), p0 - 0.1 * g, rtol=1e-6)
    p.grad = torch.from_numpy(g)
    opt.step()
    vel = 0.9 * g + g
    np.testing.assert_allclose(p.detach().numpy(),
                               p0 - 0.1 * g - 0.1 * vel, rtol=1e-6)


def test_scheduler_lr_and_set_lr():
    cos = popt.lr.CosineAnnealingDecay(0.1, T_max=10)
    opt = popt.SGD(learning_rate=cos,
                   parameters=[torch.nn.Parameter(torch.zeros(1))])
    assert opt.get_lr() == pytest.approx(0.1)
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)
    opt = popt.SGD(learning_rate=0.1,
                   parameters=[torch.nn.Parameter(torch.zeros(1))])
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5


def test_grad_clip_global_norm():
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.full((4,), 10.0)
    opt = popt.SGD(learning_rate=1.0, parameters=[p],
                   grad_clip=pnn.ClipGradByGlobalNorm(1.0))
    opt.step()
    np.testing.assert_allclose(np.linalg.norm(p.detach().numpy()), 1.0,
                               rtol=1e-4)


def test_weight_decay():
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.zeros(2)
    opt = popt.SGD(learning_rate=0.1, parameters=[p], weight_decay=0.5)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), [0.95, 0.95], rtol=1e-6)


def test_minimize_and_need_clip():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(3))
    q.need_clip = False
    opt = popt.SGD(learning_rate=1.0, parameters=[p, q],
                   grad_clip=pnn.ClipGradByValue(0.1))
    opt.minimize((p * 5).sum() + (q * 5).sum())
    np.testing.assert_allclose(p.detach().numpy(), [0.9] * 3, rtol=1e-6)
    np.testing.assert_allclose(q.detach().numpy(), [-4.0] * 3, rtol=1e-6)


@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
def test_clip_grad_norm_matches_reference(norm_type):
    from paddle_tpu.nn.clip import clip_grad_norm_ as jclip

    rng = np.random.RandomState(5)
    gs = [rng.randn(*s).astype(np.float32) * 3 for s in SHAPES]
    jp, pp = _params()
    for a, b, g in zip(jp, pp, gs):
        a.grad = paddle.to_tensor(g)
        b.grad = torch.from_numpy(g.copy())
    jt = jclip(jp, 1.0, norm_type)
    pt = pnn.clip_grad_norm_(pp, 1.0, norm_type)
    _close(pt, jt)
    for a, b in zip(jp, pp):
        _close(b.grad, a.grad)
