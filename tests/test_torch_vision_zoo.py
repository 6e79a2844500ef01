"""The vision model zoo of the PyTorch port against ``paddle_tpu``.

``paddle_tpu``'s models are built abstractly (``jax.eval_shape`` over
the constructor: built eagerly, its initializers compile once per
parameter shape), then every parameter and buffer is set from the
port's numpy state (``load_numpy_state``'s names), the running
statistics drawn away from 0 and 1; its forwards run under
``jax.jit(functional_call)``, its gradients by ``jax.grad``.

* Every constructor both packages export builds the same state-dict
  keys and shapes (the port's on the ``meta`` device).
* fp32 eval forwards at the reference's tiny sizes
  (``tests/test_vision_zoo.py:18-100``: 64 px and 10 classes, GoogLeNet
  at 224, Inception v3 at 299) within atol 2e-5 times the largest
  logit (sums in other orders through up to 120 layers).
* One SGD step of each family: ``test_torch_vision_zoo_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.vision.models as JM
from paddle_tpu.jit.functional import functional_call
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.vision import models as PM

CONSTRUCTORS = sorted(
    n for n in dir(JM) if not n.startswith("_") and n[0].islower()
    and callable(getattr(JM, n)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _jax_abstract(ctor):
    """The reference model built under ``jax.eval_shape``, and its state's
    shapes; its parameters and buffers hold tracers until set."""
    box = {}

    def build():
        box["m"] = ctor()
        return {k: v._data for k, v in box["m"].state_dict().items()}

    shapes = jax.eval_shape(build)
    return box["m"], {k: tuple(s.shape) for k, s in shapes.items()}


def test_every_constructor_is_exported():
    got = sorted(n for n in dir(PM) if not n.startswith("_")
                 and n[0].islower() and callable(getattr(PM, n)))
    assert got == CONSTRUCTORS
    assert len(CONSTRUCTORS) == 38


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_state_dict_keys_and_shapes_match(name):
    kw = {} if name == "lenet" else dict(num_classes=10)
    _, want = _jax_abstract(lambda: getattr(JM, name)(**kw))
    pm = getattr(PM, name)(device="meta", **kw)
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == want


def _pair(name, seed=3, **kw):
    """(reference model, port model) on the same parameters and running
    statistics."""
    jm, _ = _jax_abstract(lambda: getattr(JM, name)(**kw))
    pm = getattr(PM, name)(device="cpu", seed=0, **kw)
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in pm.state_dict().items():
        a = v.detach().numpy().copy()
        if k.endswith("_mean"):
            a = 0.1 * rng.randn(*a.shape).astype(np.float32)
        elif k.endswith("_variance"):
            a = rng.uniform(0.5, 2, a.shape).astype(np.float32)
        state[k] = a
    load_numpy_state(pm, state)
    named = dict(jm.named_parameters())
    named.update(dict(jm.named_buffers()))
    for k, v in state.items():
        named[k]._data = jnp.asarray(v)
    params = {k: jnp.asarray(state[k]) for k, _ in jm.named_parameters()}
    return jm, pm, params


def _x(n=1, hw=64, seed=0):
    return np.random.RandomState(seed).randn(n, 3, hw, hw).astype(
        np.float32)


FORWARD = [(n, 64) for n in (
    "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small",
    "mobilenet_v3_large", "squeezenet1_0", "squeezenet1_1",
    "shufflenet_v2_x0_25", "shufflenet_v2_x1_0", "shufflenet_v2_swish",
    "densenet121", "resnext50_32x4d", "vgg11", "alexnet")] + [
    ("googlenet", 224), ("inception_v3", 299)]


def _close(got, want, atol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol * max(1e-30, np.abs(want).max()))


@pytest.mark.parametrize("name,hw", FORWARD)
def test_eval_forward_matches(name, hw):
    jm, pm, params = _pair(name, num_classes=10)
    jm.eval()
    pm.eval()
    x = _x(hw=(224 if name == "alexnet" else hw))
    want = jax.jit(lambda p, a: functional_call(jm, p, a))(params, x)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 10)
    _close(got, want, 2e-5)


def test_lenet_and_mobilenetv3_half_width_forward():
    jm, pm, params = _pair("LeNet")
    x = np.random.RandomState(1).randn(2, 1, 28, 28).astype(np.float32)
    jm.eval()
    pm.eval()
    want = jax.jit(lambda p, a: functional_call(jm, p, a))(params, x)
    with torch.no_grad():
        _close(pm(torch.from_numpy(x)), want, 2e-5)
    m = PM.MobileNetV3Large(scale=0.5, num_classes=10, device="cpu")
    assert m.lastconv[0].weight.shape[0] == 480


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert PM.mobilenet_v2(num_classes=10).features[0][0].weight.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PM.mobilenet_v2(num_classes=10)
