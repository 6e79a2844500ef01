"""AMP of the PyTorch port against ``paddle_tpu``.

* The dtype of every op: the same model on the same weights and inputs
  under ``auto_cast`` O1 and O2 in both packages; ``paddle_tpu``'s
  operator statistics (``amp.debugging``, (op, output dtype) -> calls)
  equal the port's tally (``amp.state.op_dtypes``) entry for entry,
  casts included; the losses agree within rtol 1e-6 in fp32 (O1: the
  same casts at the same points, sums in other orders) and within one
  bf16 ulp (rtol 2**-7) in bf16 (O2), and the running statistics the
  forward left within atol 2e-5 times their largest magnitude (batch
  means of bf16 activations summed in other orders).
* ``decorate``'s dtypes, the cast cache across steps, GradScaler's
  schedule, skip, ``state_dict`` and ``mark_found_inf`` (the counterpart
  of ``tests/test_guardian.py:311-343``), and counterparts of
  ``tests/test_nn_optimizer.py:196-218``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.amp import debugging
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.amp import _cast_cache
from paddle_tpu_torch.models import (grad_scaler_state_to_port,
                                     grad_scaler_state_to_reference,
                                     load_numpy_state)
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision import models as pmodels

sys.path.insert(0, str(Path(__file__).parent))
from test_detection_amp import TinyDetector, _loss  # noqa: E402


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_data"):
        a = a._data
    return np.array(jnp.asarray(a, jnp.float32))


def _state(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


class PortTinyDetector(torch.nn.Module):
    def __init__(self, num_classes=3):
        super().__init__()
        self.backbone = pnn.Sequential(
            pnn.Conv2D(3, 16, 3, stride=2, padding=1, device="cpu"),
            pnn.ReLU(),
            pnn.Conv2D(16, 32, 3, stride=2, padding=1, device="cpu"),
            pnn.ReLU())
        self.box_head = pnn.Conv2D(32, 4, 1, device="cpu")
        self.cls_head = pnn.Conv2D(32, num_classes, 1, device="cpu")

    def forward(self, x):
        f = self.backbone(x)
        return self.box_head(f), self.cls_head(f)


def port_loss(boxes, cls, box_t, cls_t):
    return torch.abs(boxes - box_t).mean() + \
        PF.binary_cross_entropy_with_logits(cls, cls_t)


def _ref_stats(fn):
    debugging.enable_operator_stats_collection()
    try:
        out = fn()
    finally:
        from paddle_tpu.ops import registry

        stats, registry._OP_STATS = registry._OP_STATS, None
    return out, stats


def _loss_close(got, want):
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol)


def _det_data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 3, 32, 32).astype("float32"),
            rng.randn(2, 4, 8, 8).astype("float32"),
            (rng.rand(2, 3, 8, 8) > 0.5).astype("float32"))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_detector_op_dtypes_match_reference_stats(level):
    paddle.seed(0)
    jm = TinyDetector()
    pm = PortTinyDetector()
    load_numpy_state(pm, _state(jm))
    if level == "O2":
        jm = paddle.amp.decorate(models=jm, level="O2")
        pm = pamp.decorate(pm, level="O2")
    x, box_t, cls_t = _det_data()

    def ref():
        with paddle.amp.auto_cast(level=level):
            b, c = jm(paddle.to_tensor(x))
            return _loss(b, c, paddle.to_tensor(box_t),
                         paddle.to_tensor(cls_t))
    jl, want = _ref_stats(ref)
    with pamp.state.op_dtypes() as got, pamp.auto_cast(level=level):
        b, c = pm(torch.from_numpy(x))
        pl = port_loss(b, c, torch.from_numpy(box_t),
                       torch.from_numpy(cls_t))
    assert got == want
    assert str(pl.dtype).endswith(str(jl.dtype).split(".")[-1])
    _loss_close(pl, jl)
    # the reference's own test: O2 really computes in bf16
    with pamp.auto_cast(level="O2"):
        assert pm.backbone(torch.from_numpy(x)).dtype == torch.bfloat16


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_resnet_op_dtypes_match_reference_stats(level):
    """ResNet-18 in training mode with the cross entropy: the batch norm
    takes bf16 x beside its fp32 weight under O1 and a bf16 weight under
    O2 (the fused train op is in neither list), the per-sample losses
    are rounded to bf16 by O2's ``squeeze`` before the fp32 mean."""
    paddle.seed(0)
    jm = jmodels.resnet18(num_classes=10)
    pm = pmodels.resnet18(num_classes=10, device="cpu")
    load_numpy_state(pm, _state(jm))
    jm.train()
    pm.train()
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype("float32")
    y = np.array([1, 2])

    def ref():
        with paddle.amp.auto_cast(level=level):
            return jnn.functional.cross_entropy(jm(paddle.to_tensor(x)),
                                                paddle.to_tensor(y))
    jl, want = _ref_stats(ref)
    with pamp.state.op_dtypes() as got, pamp.auto_cast(level=level):
        pl = PF.cross_entropy(pm(torch.from_numpy(x)), torch.from_numpy(y))
    assert got == want
    _loss_close(pl, jl)
    want = _state(jm)
    for k, v in _state(pm).items():
        np.testing.assert_allclose(
            v, want[k], rtol=0, atol=2e-5 * max(1.0, np.abs(want[k]).max()))


def test_backward_and_no_amp_regions_are_not_cast():
    x = torch.randn(4, 4, requires_grad=True)
    w = torch.randn(4, 4, requires_grad=True)
    with pamp.auto_cast(level="O2"):
        y = (x * 2.0).sum()          # multiply casts to bf16 under O2
        assert y.dtype == torch.float32    # reduce_sum is black
        with pamp.state.no_amp():
            assert (x * 2.0).dtype == torch.float32
        with pamp.state.op_dtypes() as seen:
            y.backward()
        assert seen == {}
        out = pnn.Linear(4, 4, device="cpu")(x)
        assert out.dtype == torch.bfloat16
    assert x.grad.dtype == torch.float32 and w.grad is None


def test_decorate_o2_dtypes_and_master_weights():
    m = pmodels.resnet18(num_classes=10, device="cpu")
    opt = popt.Momentum(learning_rate=0.1, parameters=m.parameters())
    m2, opt2 = pamp.decorate(m, opt, level="O2")
    assert m2 is m and opt2 is opt and opt._use_master_weights
    for name, mod in m.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            want = (torch.float32 if "bn" in name or "downsample.1" in name
                    else torch.bfloat16)
            assert p.dtype == want, (name, pname)
    assert all(b.dtype == torch.float32 for b in m.buffers())
    # the reference keeps the same split
    paddle.seed(0)
    jm = paddle.amp.decorate(models=jmodels.resnet18(num_classes=10),
                             level="O2")
    got = {k: str(v.dtype).replace("torch.", "")
           for k, v in m.state_dict().items()}
    want = {k: str(jnp.asarray(v._data).dtype)
            for k, v in jm.state_dict().items()}
    assert got == want
    # master weights: fp32, made from the bf16 parameter at the first step
    p = m.fc.weight
    p.grad = torch.zeros_like(p)
    opt.step()
    assert opt._master_weights[id(p)].dtype == torch.float32
    assert torch.equal(opt._master_weights[id(p)].to(torch.bfloat16), p)


def test_cast_cache_reuse_and_invalidation():
    _cast_cache.clear()
    p = torch.nn.Parameter(torch.randn(3, 3))
    with pamp.auto_cast(level="O1"):
        a = pamp.state.amp_transform("matmul", (p,))[0]
        b = pamp.state.amp_transform("matmul", (p,))[0]
        assert a is b and a.dtype == torch.bfloat16   # reused in a step
        a.float().sum().backward()
        c = pamp.state.amp_transform("matmul", (p,))[0]
        assert c is not a                  # backward released the cast
        with torch.no_grad():
            p.add_(1.0)                    # an update bumps the version
        d = pamp.state.amp_transform("matmul", (p,))[0]
        assert d is not c and torch.equal(d, p.detach().to(torch.bfloat16))
        with torch.no_grad():
            assert pamp.state.amp_transform("matmul", (p,))[0] is d
            p.mul_(0.5)
            e = pamp.state.amp_transform("matmul", (p,))[0]
        f = pamp.state.amp_transform("matmul", (p,))[0]
        # a cast made under no_grad never serves a step that needs the
        # gradient
        assert e.grad_fn is None and f is not e and f.grad_fn is not None
    q = torch.randn(2)
    pamp.state.amp_state().enabled = False
    with pamp.auto_cast(level="O1"):
        pamp.state.amp_transform("matmul", (q,))
    n = len(_cast_cache._cache)
    del q
    assert len(_cast_cache._cache) == n - 1   # dropped with its source


def test_amp_training_steps_match_reference():
    """Three O2 steps of the tiny detector with AdamW and GradScaler in
    both packages: losses within rtol 2e-2 (bf16), the scaler states
    equal."""
    paddle.seed(0)
    jm = TinyDetector()
    pm = PortTinyDetector()
    load_numpy_state(pm, _state(jm))
    jm = paddle.amp.decorate(models=jm, level="O2")
    pm = pamp.decorate(pm, level="O2")
    jo = paddle.optimizer.AdamW(learning_rate=1e-3,
                                parameters=jm.parameters())
    po = popt.AdamW(learning_rate=1e-3, parameters=pm.parameters())
    jo._use_master_weights = po._use_master_weights = True
    js = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    ps = pamp.GradScaler(init_loss_scaling=2.0 ** 10)
    x, box_t, cls_t = _det_data()
    jl, pl = [], []
    for _ in range(3):
        with paddle.amp.auto_cast(level="O2"):
            b, c = jm(paddle.to_tensor(x))
            loss = _loss(b, c, paddle.to_tensor(box_t),
                         paddle.to_tensor(cls_t))
        js.scale(loss).backward()
        js.step(jo)
        js.update()
        jo.clear_grad()
        jl.append(float(_np(loss)))
        with pamp.auto_cast(level="O2"):
            b, c = pm(torch.from_numpy(x))
            loss = port_loss(b, c, torch.from_numpy(box_t),
                             torch.from_numpy(cls_t))
        assert loss.dtype == torch.bfloat16
        ps.scale(loss).backward()
        ps.step(po)
        ps.update()
        po.clear_grad()
        pl.append(float(loss))
    np.testing.assert_allclose(pl, jl, rtol=2e-2)
    assert ps.state_dict() == js.state_dict()


def test_grad_scaler_schedule_and_skip():
    """The same sequence of finite and non-finite gradients through both
    scalers: scale after every update, steps skipped, state dicts."""
    kw = dict(init_loss_scaling=8.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5)
    js, ps = paddle.amp.GradScaler(**kw), pamp.GradScaler(**kw)
    jp = paddle.EagerParamBase(np.ones(3, np.float32))
    pp = torch.nn.Parameter(torch.ones(3))
    jo = paddle.optimizer.SGD(learning_rate=0.1, parameters=[jp])
    po = popt.SGD(learning_rate=0.1, parameters=[pp])
    for g in (1.0, 1.0, np.inf, 1.0, np.nan, np.nan, 1.0, 1.0, 1.0):
        grad = np.full(3, g * js._scale, np.float32)
        jp.grad = paddle.to_tensor(grad)
        pp.grad = torch.from_numpy(grad.copy())
        js.step(jo)
        ps.step(po)
        assert ps._found_inf == js._found_inf
        js.update()
        ps.update()
        assert ps._scale == js._scale
        assert ps.state_dict() == js.state_dict()
        np.testing.assert_array_equal(_np(pp), _np(jp))
    assert ps.get_loss_scaling().item() == js._scale
    st = grad_scaler_state_to_port(js.state_dict())
    fresh = pamp.GradScaler(**kw)
    fresh.load_state_dict(st)
    assert fresh.state_dict() == js.state_dict()
    back = paddle.amp.GradScaler(**kw)
    back.load_state_dict(grad_scaler_state_to_reference(ps.state_dict()))
    assert back.state_dict() == ps.state_dict()


def test_grad_scaler_disabled_and_unscale():
    s = pamp.GradScaler(enable=False)
    assert s.scale(torch.tensor(3.0)).item() == 3.0
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 4.0)
    s2 = pamp.GradScaler(init_loss_scaling=4.0)
    s2.unscale_(popt.SGD(learning_rate=0.0, parameters=[p]))
    assert torch.equal(p.grad, torch.ones(2)) and not s2._found_inf


def _eager_setup():
    torch.manual_seed(3)
    net = pnn.Linear(4, 2, device="cpu")
    torch.nn.init.uniform_(net.weight, -1, 1)
    torch.nn.init.zeros_(net.bias)
    opt = popt.Adam(learning_rate=0.1, parameters=net.parameters())
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 4).astype(
        np.float32))
    return net, opt, x


def test_grad_scaler_mark_found_inf_skips_update_and_decays_scale():
    """``mark_found_inf`` (the guardian's eager skip hook) as the
    reference's: the optimizer step is skipped (parameters, accumulators
    and the global step untouched, bit for bit) while the scale decays by
    ``decr_ratio``; a clean step afterwards moves the weights."""
    net, opt, x = _eager_setup()
    scaler = pamp.GradScaler(enable=True, init_loss_scaling=1024.0)
    scaler.scale((net(x) ** 2).mean()).backward()
    w0 = net.weight.detach().clone()
    opt_state0 = {k: (v.clone() if torch.is_tensor(v) else v)
                  for k, v in opt.state_dict()["accumulators"].items()}
    gstep0 = opt.state_dict()["global_step"]

    scaler.mark_found_inf()
    scaler.step(opt)
    scaler.update()
    assert torch.equal(net.weight, w0)
    st = opt.state_dict()
    assert st["global_step"] == gstep0
    assert set(st["accumulators"]) == set(opt_state0)
    for k, v in st["accumulators"].items():
        assert torch.equal(v, opt_state0[k])
    assert scaler._scale == 512.0
    opt.clear_grad()

    scaler.scale((net(x) ** 2).mean()).backward()
    scaler.step(opt)
    scaler.update()
    assert (net.weight - w0).abs().max() > 0
    assert opt.state_dict()["global_step"] == gstep0 + 1


# -- counterparts of tests/test_nn_optimizer.py:196-218 ----------------------

def test_amp_autocast_bf16():
    a, b = torch.randn(4, 4), torch.randn(4, 4)
    with pamp.auto_cast(level="O1", dtype="bfloat16"):
        c = torch.matmul(a, b)
        assert c.dtype == torch.bfloat16
        assert torch.exp(a).dtype == torch.float32     # black list
        assert (a + b).dtype == torch.float32          # neither list
    assert torch.matmul(a, b).dtype == torch.float32


def test_grad_scaler_fp16_semantics():
    model = pnn.Linear(2, 2, device="cpu")
    torch.nn.init.ones_(model.weight)
    torch.nn.init.zeros_(model.bias)
    scaler = pamp.GradScaler(init_loss_scaling=2.0)
    loss = model(torch.ones(1, 2)).sum()
    scaled = scaler.scale(loss)
    assert scaled.item() == pytest.approx(loss.item() * 2.0)
    scaled.backward()
    scaler.step(popt.SGD(learning_rate=0.0, parameters=model.parameters()))
    scaler.update()
    assert pamp.is_bfloat16_supported() and pamp.is_float16_supported()
