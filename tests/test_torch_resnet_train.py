"""ResNet-18 and the detector of the PyTorch port trained against
``paddle_tpu``: both packages' ``CompiledTrainStep`` on the same weights
(``paddle.seed``, through numpy into the port) and the same seeded
batches, and ``multi_step`` against the step loop.  The helpers, the
learning rate (1e-5, and why) and the tolerances are
``test_torch_resnet.py``'s.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models.training import CompiledTrainStep as JaxTrainStep
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import CompiledTrainStep, load_numpy_state
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision import models as pmodels

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_resnet import (  # noqa: E402
    LR, _close, _images, _np, _pair, _state,
)


class _JaxDetector(jnn.Layer):
    """bench.py's ``_bench_detection`` model (bench.py:484-499)."""

    def __init__(self, num_classes=80):
        super().__init__()
        self.backbone = jmodels.resnet18(num_classes=0, with_pool=False)
        self.box = jnn.Conv2D(512, 4, 1)
        self.cls = jnn.Conv2D(512, num_classes, 1)

    def forward(self, x, box_t, cls_t):
        from paddle_tpu import ops

        f = self.backbone(x)
        l_box = ops.mean(ops.abs(self.box(f) - box_t))
        l_cls = JF.binary_cross_entropy_with_logits(self.cls(f), cls_t)
        return l_box + l_cls


class _Detector(torch.nn.Module):
    """The same model on the port: ResNet-18 features, 1x1 box and class
    heads, L1 + BCE-with-logits."""

    def __init__(self, num_classes=80, device=None):
        super().__init__()
        self.backbone = pmodels.resnet18(num_classes=0, with_pool=False,
                                         device=device)
        self.box = pnn.Conv2D(512, 4, 1, device=device)
        self.cls = pnn.Conv2D(512, num_classes, 1, device=device)

    def forward(self, x, box_t, cls_t):
        f = self.backbone(x)
        l_box = torch.abs(self.box(f) - box_t).mean()
        l_cls = PF.binary_cross_entropy_with_logits(self.cls(f), cls_t)
        return l_box + l_cls


def _resnet_steps(dtype, n=3):
    """n steps of both packages' CompiledTrainStep on resnet18 (1000
    classes, B = 8, 64x64) with cross entropy: (losses, losses, steps,
    models, the reference's state before the steps)."""
    jm, pm = _pair(jmodels.resnet18, pmodels.resnet18, num_classes=1000)
    before = _state(jm)
    jm.train()
    pm.train()
    kw = {} if dtype == "float32" else dict(compute_dtype="bfloat16")
    jstep = JaxTrainStep(jm, lr=LR, loss_fn=JF.cross_entropy, donate=False,
                         **kw)
    pstep = CompiledTrainStep(pm, lr=LR, loss_fn=PF.cross_entropy,
                              device="cpu", **kw)
    xj = jnp.asarray(_images(b=8, seed=9), jnp.float32
                     if dtype == "float32" else jnp.bfloat16)
    xt = torch.from_numpy(_np(xj)).to(getattr(torch, dtype))
    y = np.random.RandomState(1).randint(0, 1000, 8).astype(np.int32)
    jl = [float(jstep.step(xj, y)) for _ in range(n)]
    pl = [float(pstep.step(xt, torch.from_numpy(y))) for _ in range(n)]
    return jl, pl, (jstep, pstep), (jm, pm), before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_losses_and_running_stats(dtype):
    """3 AdamW steps (bench.py's config 1 step at lr 1e-5, fp32 master and
    moments): the losses match step for step.  Both packages train with
    the batch statistics and leave the running statistics where they
    were; an eager train-mode forward then updates them in both, to the
    same values.  Under bf16 compute the batch norms' weights and biases
    are cast to bf16 in both (their names lack "norm"), and the running
    statistics stay fp32."""
    jl, pl, (jstep, pstep), (jm, pm), before = _resnet_steps(dtype)
    np.testing.assert_allclose(pl, jl, rtol=1e-5 if dtype == "float32"
                               else 2e-2)
    assert pl[-1] < pl[0]
    for k in ("bn1._mean", "layer4.1.bn2._variance"):
        np.testing.assert_array_equal(_np(jm.state_dict()[k]), before[k])
        np.testing.assert_array_equal(_np(pm.state_dict()[k]), before[k])
    bf16 = dtype == "bfloat16"
    for k in ("bn1.weight", "layer1.0.bn2.bias", "conv1.weight", "fc.bias"):
        assert (jstep.params[k].dtype == jnp.bfloat16) == bf16, k
        assert (pstep.params[k].dtype == torch.bfloat16) == bf16, k
    assert all(b.dtype == torch.float32 for b in pm.buffers())
    # an eager train-mode forward (outside the step) updates them; the
    # updated model (bf16 weights in the bf16 case) sees the same input
    pstep.sync_to_model()
    jstep.sync_to_model()
    x = jnp.asarray(_images(seed=10), jnp.bfloat16 if bf16 else
                    jnp.float32)
    jm(paddle.to_tensor(x))
    with torch.no_grad():
        pm(torch.from_numpy(_np(x)).to(torch.bfloat16 if bf16 else
                                       torch.float32))
    for k in ("bn1._mean", "bn1._variance", "layer3.0.downsample.1._mean"):
        got, want = _np(pm.state_dict()[k]), _np(jm.state_dict()[k])
        assert not np.array_equal(got, before[k]), k
        if not bf16:        # in bf16 the weights differ after 3 steps
            _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detector_train_steps(dtype):
    """bench.py's detector (config 4) at a tiny size: B = 2, 64x64
    images, so 2x2 features; 3 steps of both packages' CompiledTrainStep
    (lr 1e-5) match step for step."""
    paddle.seed(11)
    jm = _JaxDetector()
    pm = _Detector(device="cpu")
    load_numpy_state(pm, _state(jm))
    jm.train()
    pm.train()
    kw = {} if dtype == "float32" else dict(compute_dtype="bfloat16")
    jstep = JaxTrainStep(jm, lr=LR, donate=False, **kw)
    pstep = CompiledTrainStep(pm, lr=LR, device="cpu", **kw)
    rng = np.random.RandomState(12)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    box_t = rng.randn(2, 4, 2, 2).astype(np.float32)
    cls_t = (rng.rand(2, 80, 2, 2) > 0.95).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else
                     jnp.float32)
    xt = torch.from_numpy(_np(xj)).to(getattr(torch, dtype))
    jl = [float(jstep.step(xj, box_t, cls_t)) for _ in range(3)]
    pl = [float(pstep.step(xt, torch.from_numpy(box_t),
                           torch.from_numpy(cls_t))) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5 if dtype == "float32"
                               else 2e-2)
    assert pl[-1] < pl[0]


def test_multi_step_on_cpu_is_the_step_loop():
    """``multi_step(k)`` on the CPU runs k steps over the same body: the
    same losses and running statistics (unchanged) as k ``step`` calls."""
    def build():
        torch.manual_seed(0)
        m = pmodels.resnet18(num_classes=10, device="cpu", seed=1)
        m.train()
        return CompiledTrainStep(m, lr=LR, loss_fn=PF.cross_entropy,
                                 device="cpu")

    x = torch.from_numpy(_images(b=2, hw=32))
    y = torch.tensor([3, 4])
    a, b = build(), build()
    la = [float(a.step(x, y)) for _ in range(2)]
    b.multi_step(2, x, y)
    assert b.last_losses.tolist() == la
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert torch.equal(a.model.bn1._mean, torch.zeros(64))


@pytest.mark.cuda
def test_multi_step_replay_equals_eager_on_card():
    """On the card: a replayed ``multi_step(3)`` of a tiny ResNet-18 from
    one state equals 3 eager steps from an equal one, losses and every
    parameter, master and moment tensor, when cuDNN is deterministic
    (``torch.backends.cudnn.deterministic``); the running statistics
    stay as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")

    def build():
        m = pmodels.resnet18(num_classes=10, device=dev, seed=1)
        m.train()
        return CompiledTrainStep(m, lr=LR, loss_fn=PF.cross_entropy,
                                 compute_dtype="bfloat16", device=dev)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x = torch.from_numpy(_images(b=8, hw=64)).to(dev, torch.bfloat16)
        y = torch.arange(8, device=dev) % 10
        a, b = build(), build()
        la = [float(a.step(x, y)) for _ in range(3)]
        b.multi_step(3, x, y)
        lb = b.last_losses.tolist()
    finally:
        torch.backends.cudnn.deterministic = det
    assert la == lb
    for name in ("params", "_master", "_m", "_v"):
        ta, tb = getattr(a, name), getattr(b, name)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), (name, k)
    assert torch.equal(b.model.bn1._mean, torch.zeros(64, device=dev))
