"""The UNet train step of the PyTorch port against ``paddle_tpu``'s
``CompiledTrainStep``: bench.py's config 5 step (noise-prediction MSE,
AdamW at its lr 1e-4) on ``tiny()``, B = 2, 16 x 16 latents, 7 context
tokens.

Both steps start from the same numpy weights (the port's model, built
from a seed, carried by ``load_numpy_state`` into the port's trained
model and set into the reference's, which is built abstractly under
``jax.eval_shape`` so its initializers compile nothing).

Tolerances: 3 losses in fp32 rtol 1e-5 (fp32 on both sides, sums in other
orders); under ``compute_dtype="bfloat16"`` with bf16 moments rtol 2e-2
(the weights round to bf16 at the same points in both; the fp32
products and sums run in other orders, and a gradient element's bf16
rounding can differ).  bench.py's lr 1e-4 holds these: unlike a random
ResNet in training mode (trained at 1e-5 in ``test_torch_resnet.py``),
the UNet has no batch statistics to turn a rounding difference into a
sign change.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import unet as junet
from paddle_tpu.models.training import CompiledTrainStep as JaxTrainStep
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import (
    CompiledTrainStep, UNet2DConditionModel, load_numpy_state,
)
from paddle_tpu_torch.testing.vision_profile import UNetTrain

LR = 1e-4


class _JaxUNetTrain(jnn.Layer):
    """bench.py's ``UNetTrain`` (bench.py:535-543)."""

    def __init__(self, unet):
        super().__init__()
        self.unet = unet

    def forward(self, latents, t, ctx, noise):
        pred = self.unet(latents, t, ctx)
        return ((pred - noise) ** 2).mean()


def _jax_tiny(state):
    """The reference's ``tiny()`` built under ``jax.eval_shape``, then
    every parameter set from ``state``."""
    box = {}

    def build():
        box["m"] = junet.UNet2DConditionModel.tiny()
        return {k: p._data for k, p in box["m"].named_parameters()}

    jax.eval_shape(build)
    for k, p in box["m"].named_parameters():
        p._data = jnp.asarray(state[k])
    return box["m"]


def _stream_dtypes(model):
    """Forward hooks recording the output dtype of every conv, Linear,
    GroupNorm and LayerNorm of ``model``; returns (dtypes, handles)."""
    seen = []
    kinds = (pnn.Conv2D, pnn.Linear, pnn.GroupNorm, pnn.LayerNorm)
    handles = [m.register_forward_hook(
        lambda mod, args, out: seen.append((type(mod).__name__, out.dtype)))
        for m in model.modules() if isinstance(m, kinds)]
    return seen, handles


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_losses(dtype):
    """3 steps of ``CompiledTrainStep(lr=1e-4)`` (fp32 master), in fp32 and
    as config 5 runs (``compute_dtype="bfloat16"``,
    ``moments_dtype="bfloat16"``): the losses match step for step and
    fall.  Under bf16 compute the port's step keeps the reference's fp32
    stream: every parameter whose name holds "norm" stays fp32 (in both
    packages), every other one is bf16, and every conv, Linear, GroupNorm
    and LayerNorm output is fp32, because the fp32 inputs are not cast
    and the fp32 GroupNorm weights promote."""
    state = {k: v.detach().numpy() for k, v in UNet2DConditionModel.tiny(
        device="cpu", seed=0).state_dict().items()}
    jm = _JaxUNetTrain(_jax_tiny(state))
    pm = UNetTrain(UNet2DConditionModel.tiny(device="cpu", seed=1))
    load_numpy_state(pm.unet, state)
    kw = ({} if dtype == "float32" else
          dict(compute_dtype="bfloat16", moments_dtype="bfloat16"))
    jstep = JaxTrainStep(jm, lr=LR, donate=False, **kw)
    pstep = CompiledTrainStep(pm, lr=LR, device="cpu", **kw)
    rng = np.random.RandomState(11)
    batch = (rng.randn(2, 4, 16, 16).astype(np.float32),
             rng.randint(0, 1000, (2,)).astype(np.int32),
             rng.randn(2, 7, 32).astype(np.float32),
             rng.randn(2, 4, 16, 16).astype(np.float32))
    seen, handles = _stream_dtypes(pm)
    jl = [float(jstep.step(*batch)) for _ in range(3)]
    pl = [float(pstep.step(*batch)) for _ in range(3)]
    for h in handles:
        h.remove()
    np.testing.assert_allclose(pl, jl, rtol=1e-5 if dtype == "float32"
                               else 2e-2)
    assert pl[-1] < pl[0]
    assert len(seen) == 3 * len(handles)
    assert {d for _, d in seen} == {torch.float32}
    if dtype == "bfloat16":
        for k, p in pstep.params.items():
            want = torch.float32 if "norm" in k else torch.bfloat16
            assert p.dtype == want, k
            assert str(jstep.params[k].dtype) == str(want)[6:], k
        assert pstep._m["unet.conv_in.weight"].dtype == torch.bfloat16
