"""ResNet of the PyTorch port against ``paddle_tpu``.

``paddle_tpu``'s models are built from ``paddle.seed``; their state dicts
(parameters and the batch norms' ``_mean`` / ``_variance``) go through
numpy into the port (``load_numpy_state``), and both run on the CPU on
the same seeded inputs.  The JAX side runs eagerly (blocks, eval
logits, eager train-mode forwards); where only the state's names and
shapes matter it is built under ``jax.eval_shape``.  The train steps
(its ``CompiledTrainStep`` against the port's) are
``test_torch_resnet_train.py``'s, which shares this file's helpers.

Train steps use lr 1e-5.  At bench.py's lr 0.1 AdamW drives a small
batch's loss to 0 within a step.  At 1e-3 it still memorises 8 images in
two steps (7.50 -> 1.16 -> 0.03), and a randomly initialised ResNet in
training mode is chaotic there: one ReLU input of 6e-7 that rounds to the
other sign in fp32 than in fp64 moves a layer's gradient by 1e-3 (the
batch norm spreads it over the channel), AdamW's first steps, m / sqrt(v)
near +-1, turn every gradient element of changed sign into a whole-lr
step, and the third fp32 loss of two correct implementations differs by
3e-3 (bf16: 40%).  At 1e-5 the losses still fall (7.50 -> 6.98 -> 6.49)
and agree as the tolerances below say.

Tolerances: fp32 forwards, gradients and running statistics atol 2e-5
times the largest magnitude (at least 1) (sums in other orders through
up to 18 layers; gradients of a parameter 1e-4); fp32 train-step losses
rtol 1e-5; bf16 compute rtol 2e-2 (bf16 rounds at the same points in
both packages, sums in other orders round differently); the running
statistics of one block's eager forward atol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.vision import models as pmodels

LR = 1e-5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_data"):
        a = a._data
    return np.array(jnp.asarray(a, jnp.float32))


def _state(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def _close(got, want, atol=2e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


def _pair(jax_ctor, port_ctor, seed=3, **kw):
    """(JAX model, port model) on the same weights and statistics."""
    paddle.seed(seed)
    jm = jax_ctor(**kw)
    pm = port_ctor(device="cpu", **kw)
    load_numpy_state(pm, _state(jm))
    return jm, pm


def _jax_abstract(ctor):
    """The reference model's state shapes, built under ``jax.eval_shape``
    (built eagerly, its initializers compile once per parameter
    shape)."""
    shapes = jax.eval_shape(lambda: {k: v._data for k, v in
                                     ctor().state_dict().items()})
    return {k: tuple(v.shape) for k, v in shapes.items()}


def _images(b=4, hw=64, seed=0):
    return np.random.RandomState(seed).randn(b, 3, hw, hw).astype(
        np.float32)


@pytest.mark.parametrize("ctor", ["resnet18", "resnet50"])
def test_state_dict_names_and_shapes_match(ctor):
    paddle.seed(0)
    want = _jax_abstract(lambda: getattr(jmodels, ctor)(num_classes=10))
    pm = getattr(pmodels, ctor)(num_classes=10, device="cpu")
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == want
    assert "layer1.0.bn1._mean" in got and "layer1.0.bn1._variance" in got
    if ctor != "resnet18":
        assert "layer1.0.downsample.0.weight" in got
    assert {k for k, _ in pm.named_buffers()} == {
        k for k in got if k.endswith(("._mean", "._variance"))}
    assert all(b.dtype == torch.float32 for b in pm.buffers())
    assert tuple(pm.fc.weight.shape) == (512 * (1 if ctor == "resnet18"
                                                else 4), 10)


def test_constructors_follow_the_reference():
    """Other constructors of the family (another depth, groups, width;
    the rest differ from these only in block counts, groups and widths),
    without ``fc`` and pool: the parameter shapes equal the
    reference's."""
    for name in ("resnet34", "resnext50_32x4d", "wide_resnet50_2"):
        pm = getattr(pmodels, name)(num_classes=0, with_pool=False,
                                    device="cpu")
        paddle.seed(0)
        want = _jax_abstract(lambda: getattr(jmodels, name)(
            num_classes=0, with_pool=False))
        assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == \
            want, name


def test_default_device_is_cuda():
    """Built on CUDA by default; without a card that raises rather than
    falling back to the CPU."""
    if torch.cuda.is_available():
        m = pmodels.resnet18(num_classes=10)
        assert m.conv1.weight.is_cuda and m.bn1._mean.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmodels.resnet18(num_classes=10)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
@pytest.mark.parametrize("stride", [1, 2])
def test_block_train_forward_and_grads(block, stride):
    """A block in training mode (batch statistics), with a downsample
    branch at stride 2: output, input gradient and every parameter's
    gradient."""
    jcls, pcls = {"basic": (jmodels.resnet.BasicBlock, pmodels.BasicBlock),
                  "bottleneck": (jmodels.resnet.BottleneckBlock,
                                 pmodels.BottleneckBlock)}[block]
    inp, planes = 16, 8
    out = planes * jcls.expansion
    paddle.seed(5)
    jdown = (jnn.Sequential(jnn.Conv2D(inp, out, 1, stride=stride,
                                       bias_attr=False),
                            jnn.BatchNorm2D(out))
             if stride != 1 or inp != out else None)
    jb = jcls(inp, planes, stride, jdown)
    pdown = (pnn.Sequential(pnn.Conv2D(inp, out, 1, stride=stride,
                                       bias_attr=False, device="cpu"),
                            pnn.BatchNorm2D(out, device="cpu"))
             if jdown is not None else None)
    pb = pcls(inp, planes, stride, pdown, device="cpu")
    load_numpy_state(pb, _state(jb))
    rng = np.random.RandomState(6)
    x = rng.randn(2, inp, 10, 10).astype(np.float32)
    xj = paddle.to_tensor(x, stop_gradient=False)
    yj = jb(xj)
    g = rng.randn(*yj.shape).astype(np.float32)
    paddle.sum(yj * paddle.to_tensor(g)).backward()
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = pb(xt)
    yt.backward(torch.from_numpy(g))
    _close(yt, yj)
    _close(xt.grad, xj.grad)
    jp = dict(jb.named_parameters())
    for k, p in pb.named_parameters():
        _close(p.grad, jp[k].grad, atol=1e-4)
    for k, b in pb.named_buffers():     # the eager running update
        _close(b, dict(jb.named_buffers())[k], atol=1e-6)


@pytest.mark.parametrize("fmt", ["contiguous", "channels_last"])
def test_resnet18_eval_logits(fmt):
    mf = {"contiguous": torch.contiguous_format,
          "channels_last": torch.channels_last}[fmt]
    paddle.seed(7)
    jm = jmodels.resnet18(num_classes=10)
    pm = pmodels.resnet18(num_classes=10, device="cpu")
    assert pm.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    pm.to(memory_format=mf)
    assert pm.conv1.weight.is_contiguous(memory_format=mf)
    # eval reads the running statistics: make them other than 0 and 1
    state = _state(jm)
    rng = np.random.RandomState(8)
    for k in state:
        if k.endswith("_mean"):
            state[k] = (0.1 * rng.randn(*state[k].shape)).astype(np.float32)
        elif k.endswith("_variance"):
            state[k] = rng.uniform(0.5, 2, state[k].shape).astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    load_numpy_state(pm, state)
    jm.eval()
    pm.eval()
    x = _images()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    want = jm(paddle.to_tensor(x))
    assert tuple(got.shape) == (4, 10)
    _close(got, want)


def test_load_numpy_state_buffers():
    """Buffers load like parameters, each keeping its dtype and memory
    format; an unknown or a missing buffer name, or a wrong shape,
    raises."""
    pm = pmodels.resnet18(num_classes=10, device="cpu")
    state = _state(pm)
    state["bn1._mean"] = np.full(64, 0.5, np.float32)
    state["conv1.weight"] = np.ones((64, 3, 7, 7), np.float32)
    load_numpy_state(pm, state)
    assert torch.equal(pm.bn1._mean, torch.full((64,), 0.5))
    assert pm.bn1._mean.dtype == torch.float32
    assert pm.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(KeyError, match="unknown .*bn1._running"):
        load_numpy_state(pm, dict(state, **{"bn1._running": state[
            "bn1._mean"]}))
    with pytest.raises(KeyError, match="missing .*layer2.1.bn2._variance"):
        load_numpy_state(pm, {k: v for k, v in state.items()
                              if k != "layer2.1.bn2._variance"})
    with pytest.raises(ValueError, match="bn1._variance"):
        load_numpy_state(pm, dict(state, **{"bn1._variance": np.ones(
            63, np.float32)}))
    # buffers that are not in a state dict (non-persistent) are not asked
    # for: a module with one loads a state dict without it
    m = pnn.Conv2D(3, 4, 1, device="cpu")
    m.register_buffer("table", torch.zeros(5), persistent=False)
    load_numpy_state(m, {k: _np(v) for k, v in m.state_dict().items()})
