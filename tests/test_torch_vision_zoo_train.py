"""One SGD step of each vision zoo family of the PyTorch port against
``paddle_tpu`` (the families with batch norm in
``test_torch_vision_zoo_train_bn.py``, through ``sgd_step``), on the same
weights (``test_torch_vision_zoo.py``'s
``_pair``: the reference built abstractly, its parameters and running
statistics set from the port's numpy state; its gradients by
``jax.grad`` over ``functional_call`` under ``jax.jit``).

* One SGD step (lr 0.1) of each family (B = 2 at 64 px, VGG-11 at 32,
  Inception v3 at 96, LeNet at 28; dropout layers in eval, their masks
  come from each package's own generator): the loss within rtol 1e-5,
  the gradients within atol 1e-4 times the parameter's largest
  gradient, the stepped parameters within lr times that plus 1e-6 of
  their largest value (an fp32 rounding of the update).  AlexNet and
  Inception v3 step in float64 on both sides (loss rtol 1e-9, gradients
  1e-7): in fp32 their gradients part at near-ties of ReLUs and max
  pools (AlexNet's first conv by 2.4% of its largest gradient), which
  float64 resolves alike.  Families with batch norm step on their
  running statistics (eval mode): in training mode both packages form
  the batch variance as E[x²] - E[x]² in fp32, and at these sizes the
  reference's sums, in another order, move a random network's loss by
  up to 33% and its gradients by up to 35% (training mode's batch norm
  is held at working sizes by ``tests/test_torch_resnet.py`` and
  ``tests/test_torch_conv_bn.py``).  GoogLeNet (with its auxiliary
  heads, weighted 0.3), VGG, SqueezeNet, AlexNet and LeNet have no
  batch norm and step in training mode.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.jit.functional import functional_call
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.common import Dropout

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_vision_zoo import _pair, _x  # noqa: E402


def _ce(logits, labels):
    lsm = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.take_along_axis(lsm, labels[:, None], 1))


#: the families without batch norm; ``test_torch_vision_zoo_train_bn.py``
#: steps the others through :func:`sgd_step`
TRAIN = [("squeezenet1_1", 64), ("vgg11", 32), ("googlenet", 64),
         ("alexnet", 64), ("LeNet", 28)]


NO_BN = ("googlenet", "vgg11", "squeezenet1_1", "alexnet", "LeNet")
#: families whose step is compared in float64 (module docstring)
FLOAT64 = ("alexnet", "inception_v3")


def _modes(jm, pm, train):
    for m in (jm, pm):
        m.train() if train else m.eval()
    for mod in pm.modules():
        if isinstance(mod, Dropout):
            mod.eval()
    for _, layer in jm.named_sublayers():
        if type(layer).__name__ == "Dropout":
            layer.eval()


@pytest.mark.parametrize("name,hw", TRAIN)
def test_one_sgd_step_matches(name, hw):
    sgd_step(name, hw)


def sgd_step(name, hw, lr=0.1):
    """One SGD step of ``name`` at ``hw`` px in both packages, held as the
    module docstring says."""
    jm, pm, params = _pair(name, num_classes=10)
    x = _x(n=2, hw=hw, seed=1)
    if name == "LeNet":
        x = x[:, :1, :28, :28].copy()
    y = np.array([3, 7])
    _modes(jm, pm, train=name in NO_BN)
    if name in FLOAT64:     # (module docstring)
        pm.double()
        params = {k: v.astype(jnp.float64) for k, v in params.items()}
        for _, b in jm.named_buffers():
            b._data = b._data.astype(jnp.float64)
        x = x.astype(np.float64)

    def jloss(p):
        out = functional_call(jm, p, x)
        if isinstance(out, (tuple, list)):
            return _ce(out[0], y) + 0.3 * (_ce(out[1], y) + _ce(out[2], y))
        return _ce(out, y)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    out = pm(torch.from_numpy(x))
    yt = torch.from_numpy(y)
    if isinstance(out, tuple):
        loss = PF.cross_entropy(out[0], yt) + 0.3 * (
            PF.cross_entropy(out[1], yt) + PF.cross_entropy(out[2], yt))
    else:
        loss = PF.cross_entropy(out, yt)
    assert str(loss.dtype).endswith(str(jl.dtype))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=1e-9 if name in FLOAT64 else 1e-5)
    opt = popt.SGD(learning_rate=lr, parameters=pm.parameters())
    loss.backward()
    named = dict(pm.named_parameters())
    tol = 1e-7 if name in FLOAT64 else 1e-4
    for k, g in jg.items():
        g = np.asarray(g)
        np.testing.assert_allclose(
            named[k].grad.numpy(), g, rtol=0,
            atol=tol * max(np.abs(g).max(), 1e-30))
    opt.step()
    for k, g in jg.items():
        want = np.asarray(params[k] - lr * g)
        np.testing.assert_allclose(
            named[k].detach().numpy(), want, rtol=0,
            atol=(1e-12 if name in FLOAT64 else 1e-6) * np.abs(want).max()
            + lr * tol * np.abs(np.asarray(g)).max())
