"""The eager training loop of the PyTorch port against ``paddle_tpu``:
BASELINE config 1's loop (a ResNet, ``Momentum`` with ``L2Decay``,
``GradScaler``, ``auto_cast`` O1, batches from ``io.DataLoader`` with
shuffling) and config 4's (the detector, ``decorate`` O2, ``AdamW``,
``GradScaler(init_loss_scaling=2**10)``), at tiny size (ResNet-18 at
64 px with 10 classes, B = 4; the tiny detector of
``tests/test_detection_amp.py``), both packages eager on the same
weights and the same batches in the same order (one numpy seed).

Tolerances: fp32 losses (no AMP) within rtol 1e-5; bf16 losses (O1,
O2) within rtol 2e-2 (bf16 rounds at the same points in both packages;
sums in other orders round differently).  The ResNet trains at lr 1e-5
(a random ResNet in training mode is chaotic at the recipe's 0.1, and
at 1e-3 the third fp32 loss of the two packages already differs by
10%: ``tests/test_torch_resnet.py``); the scaler's state is equal in
both after the steps.  The update is held too: each parameter's fp32
weight change over the steps (its master weight's under O2) and each
accumulator slot, all parameters together, in norm relative to the
reference's (a skipped update is 1 off, one off by a factor k is
|k - 1|): config 1 within 2e-2 fp32 and 0.5 at O1 (measured 5.5e-3 and
0.26: the batch norms' backward cancels, and the two packages' bf16
convolutions round their sums differently), config 4 within 1e-3 fp32
and 0.1 at O2 (measured 3.3e-6, 1.3e-2).  Config 4's loop runs without AMP and at O2 (its
reference at O1 refuses the detector's backward: a bf16 cotangent
meets an fp32 output in its VJP).  Counterparts of ``tests/test_detection_amp.py:37-74``
close the file (the nms eval test waits for ``vision/ops.py``).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision import models as pmodels

sys.path.insert(0, str(Path(__file__).parent))
from test_detection_amp import TinyDetector, _loss  # noqa: E402
from test_torch_amp import PortTinyDetector, port_loss  # noqa: E402


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_data"):
        a = a._data
    return np.array(jnp.asarray(a, jnp.float32))


def _state(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def _weights(model):
    return [_np(p).copy() for p in model.parameters()]


def _update(model, opt, before):
    """For each parameter: its fp32 weight's change since ``before`` (the
    master weight's where the optimizer keeps one), the spacing of fp32
    numbers at its weight before, and its accumulators (``_t`` left
    out).  Both packages keep ``_master_weights`` and ``_accumulators``
    keyed by ``id(p)``."""
    out = []
    for p, b in zip(model.parameters(), before):
        w = opt._master_weights.get(id(p), p)
        acc = {k: _np(v) for k, v in opt._accumulators.get(id(p), {}).items()
               if k != "_t"}
        out.append((_np(w) - b, np.spacing(np.abs(b)), acc))
    return out


def _update_err(got, want):
    """The relative difference of the port's update from the reference's,
    over all the parameters together: ||change - change'|| over
    ||change'|| (no less than 4 fp32 spacings at the weights: an update
    below fp32's resolution is its rounding), and the same for each
    accumulator slot; the larger.  A skipped update gives 1; one off by a
    factor k gives |k - 1|.  (Tensor by tensor, a batch norm's weight and
    bias changes are sums that cancel, and part by up to 40% between two
    summation orders in bf16.)"""
    assert len(got) == len(want)
    sq = {"d": 0.0, "n": 0.0, "s": 0.0}
    acc = {}
    for (dg, _, ag), (dw, sp, aw) in zip(got, want):
        assert dg.shape == dw.shape and set(ag) == set(aw)
        sq["d"] += float(np.sum((dg - dw) ** 2.0))
        sq["n"] += float(np.sum(dw ** 2.0))
        sq["s"] += float(np.sum(sp ** 2.0))
        for k in aw:
            a = acc.setdefault(k, [0.0, 0.0])
            a[0] += float(np.sum((ag[k] - aw[k]) ** 2.0))
            a[1] += float(np.sum(aw[k] ** 2.0))
    errs = [np.sqrt(sq["d"]) / max(np.sqrt(sq["n"]), 4 * np.sqrt(sq["s"]))]
    errs += [np.sqrt(d / n) for d, n in acc.values()]
    return float(max(errs))


def _config1_loop(level, steps=3, lr=1e-5):
    """Both packages' config 1 loops; returns (reference losses, port
    losses, reference scaler, port scaler)."""
    paddle.seed(0)
    jm = jmodels.resnet18(num_classes=10)
    pm = pmodels.resnet18(num_classes=10, device="cpu")
    load_numpy_state(pm, _state(jm))
    jm.train()
    pm.train()
    rng = np.random.RandomState(0)
    imgs = rng.randn(8, 3, 64, 64).astype(np.float32)
    labels = rng.randint(0, 10, (8,)).astype(np.int64)
    out = {}
    for tag, pkg in (("ref", "jax"), ("port", "torch")):
        if pkg == "jax":
            io, amp, opt_mod, model = paddle.io, paddle.amp, \
                paddle.optimizer, jm
            loader = io.DataLoader(io.TensorDataset([imgs, labels]),
                                   batch_size=4, shuffle=True,
                                   drop_last=True)
            ce = jnn.functional.cross_entropy
        else:
            io, amp, opt_mod, model = pio, pamp, popt, pm
            loader = io.DataLoader(io.TensorDataset([imgs, labels]),
                                   batch_size=4, shuffle=True,
                                   drop_last=True, num_workers=2,
                                   timeout=60,
                                   places="cpu")
            ce = PF.cross_entropy
        opt = opt_mod.Momentum(learning_rate=lr, momentum=0.9,
                               parameters=model.parameters(),
                               weight_decay=opt_mod.L2Decay(1e-4))
        before = _weights(model)
        scaler = amp.GradScaler(enable=level != "O0")
        np.random.seed(1)
        losses = []
        while len(losses) < steps:
            for x, y in loader:
                with amp.auto_cast(enable=level != "O0", level=level,
                                   dtype="bfloat16"):
                    loss = ce(model(x), y)
                scaler.scale(loss).backward()
                scaler.step(opt)
                scaler.update()
                opt.clear_grad()
                losses.append(float(_np(loss)))
                if len(losses) == steps:
                    break
        out[tag] = (losses, scaler, _update(model, opt, before))
    return out["ref"], out["port"]


@pytest.mark.parametrize("level,rtol,utol", [("O0", 1e-5, 2e-2),
                                             ("O1", 2e-2, 0.5)])
def test_config1_loop_matches(level, rtol, utol):
    (jl, js, ju), (pl, ps, pu) = _config1_loop(level)
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    assert ps.state_dict() == js.state_dict()
    assert np.isfinite(pl).all()
    assert _update_err(pu, ju) <= utol


def _config4_loop(level, steps=3):
    paddle.seed(0)
    jm = TinyDetector()
    pm = PortTinyDetector()
    load_numpy_state(pm, _state(jm))
    jm.train()
    pm.train()
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 32, 32).astype("float32")
    box_t = rng.randn(2, 4, 8, 8).astype("float32")
    cls_t = (rng.rand(2, 3, 8, 8) > 0.5).astype("float32")
    res = {}
    for tag in ("ref", "port"):
        if tag == "ref":
            amp, model = paddle.amp, jm
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=model.parameters())
            ins = [paddle.to_tensor(a) for a in (x, box_t, cls_t)]
            loss_fn = _loss
        else:
            amp, model = pamp, pm
            opt = popt.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
            ins = [torch.from_numpy(a) for a in (x, box_t, cls_t)]
            loss_fn = port_loss
        if level == "O2":
            model, opt = amp.decorate(models=model, optimizers=opt,
                                      level="O2")
        before = _weights(model)
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
        losses = []
        for _ in range(steps):
            with amp.auto_cast(enable=level != "O0", level=level):
                b, c = model(ins[0])
                loss = loss_fn(b, c, ins[1], ins[2])
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            losses.append(float(_np(loss)))
        res[tag] = (losses, scaler, model, _update(model, opt, before))
    return res


@pytest.mark.parametrize("level,rtol,utol", [("O0", 1e-5, 1e-3),
                                             ("O2", 2e-2, 0.1)])
def test_config4_loop_matches(level, rtol, utol):
    res = _config4_loop(level)
    np.testing.assert_allclose(res["port"][0], res["ref"][0], rtol=rtol)
    assert res["port"][1].state_dict() == res["ref"][1].state_dict()
    assert _update_err(res["port"][3], res["ref"][3]) <= utol
    if level == "O2":
        pm = res["port"][2]
        assert all(p.dtype == torch.bfloat16 for p in pm.parameters())


# -- counterparts of tests/test_detection_amp.py:37-74 ------------------------

def test_detection_amp_o2_train():
    torch.manual_seed(0)
    net = PortTinyDetector()
    net = pamp.decorate(models=net, level="O2")
    net.train()
    opt = popt.AdamW(learning_rate=1e-3, parameters=net.parameters())
    scaler = pamp.GradScaler(init_loss_scaling=2.0 ** 10)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 32, 32).astype("float32"))
    box_t = torch.from_numpy(rng.randn(2, 4, 8, 8).astype("float32"))
    cls_t = torch.from_numpy(
        (rng.rand(2, 3, 8, 8) > 0.5).astype("float32"))
    losses = []
    for _ in range(4):
        with pamp.auto_cast(level="O2"):
            boxes, cls = net(x)
            loss = port_loss(boxes, cls, box_t, cls_t)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_detection_amp_o2_bf16_compute():
    net = PortTinyDetector()
    x = torch.from_numpy(np.random.randn(1, 3, 32, 32).astype("float32"))
    with pamp.auto_cast(level="O2"):
        f = net.backbone(x)
    assert f.dtype == torch.bfloat16
