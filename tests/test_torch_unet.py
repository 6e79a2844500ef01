"""The diffusion UNet of the PyTorch port against ``paddle_tpu``.

Weights: the port's model, built on the CPU from a seed, gives a numpy
state; ``models.convert.load_numpy_state`` carries it into a second port
model built from another seed, and the same arrays are set into the
reference's model.  The reference's model is built abstractly
(``jax.eval_shape`` over its constructor: its initializers are traced
and nothing is drawn or compiled; at the narrow widths below they would
take some 20 s of compiles), then every parameter is set.  The
reference's forwards run as its ``CompiledTrainStep`` runs them:
``functional_call`` under ``jax.jit``, gradients by ``jax.grad``.

Tolerances: fp32 values atol 1e-5 times the largest magnitude (at least
1), gradients 1e-4 (sums in other orders through conv, GroupNorm and
attention; a parameter's gradient sums over the batch and all positions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.jit.functional import functional_call
from paddle_tpu.models import unet as junet
from paddle_tpu_torch.models import (
    CompiledTrainStep, UNet2DConditionModel, load_numpy_state,
)
from paddle_tpu_torch.models import unet as punet
from paddle_tpu_torch.testing.vision_profile import UNetTrain

#: phase 16's narrow UNet: full depth, every block type, both samplers
NARROW = dict(block_out_channels=(64, 128, 128, 128), layers_per_block=2,
              cross_attention_dim=64)
TINY = dict(in_channels=4, out_channels=4, block_out_channels=(32, 64),
            layers_per_block=1, cross_attention_dim=32, attention_head_dim=4,
            sample_size=8)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _close(got, want, atol=1e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


def _state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _jax_abstract(ctor):
    """The reference layer ``ctor()`` built under ``jax.eval_shape``, and
    its parameters' shapes; its parameters hold tracers until set."""
    box = {}

    def build():
        box["m"] = ctor()
        return {k: p._data for k, p in box["m"].named_parameters()}

    shapes = jax.eval_shape(build)
    return box["m"], {k: tuple(s.shape) for k, s in shapes.items()}


def _pair(jax_ctor, port_ctor):
    """(reference layer, port layer, params tree) on the same weights."""
    jm, shapes = _jax_abstract(jax_ctor)
    state = _state(port_ctor(seed=0))
    assert {k: v.shape for k, v in state.items()} == shapes
    pm = port_ctor(seed=1)
    load_numpy_state(pm, state)
    params = {k: jnp.asarray(v) for k, v in state.items()}
    for k, p in jm.named_parameters():
        p._data = params[k]
    return jm, pm, params


def _unet_inputs(b, hw, ctx_dim, seed=0, m=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 4, hw, hw).astype(np.float32),
            rng.randint(0, 1000, (b,)).astype(np.int32),
            rng.randn(b, m, ctx_dim).astype(np.float32))


def test_state_dict_keys_and_shapes_match():
    """``tiny()`` and the default (SD v1.5: 809.9 M parameters, built on
    the ``meta`` device and traced abstractly, so nothing is allocated):
    every key and shape letter for letter."""
    _, want = _jax_abstract(junet.UNet2DConditionModel.tiny)
    got = {k: tuple(v.shape) for k, v in UNet2DConditionModel.tiny(
        device="cpu").state_dict().items()}
    assert got == want
    _, want = _jax_abstract(junet.UNet2DConditionModel)
    pm = UNet2DConditionModel(device="meta")
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == want
    assert "down_blocks.0.1.1.attn2.to_k.weight" in got
    assert "up_blocks.3.2.1.norm_in.weight" in got
    assert "downsamplers.3.conv.weight" not in got      # Identity
    assert pm.num_params() == sum(int(np.prod(s)) for s in want.values()) \
        == 809_909_444


def test_default_device_is_cuda():
    """Built on CUDA by default; without a card that raises rather than
    falling back to the CPU."""
    if torch.cuda.is_available():
        m = UNet2DConditionModel.tiny()
        assert m.conv_in.weight.is_cuda and m.time_freqs.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            UNet2DConditionModel.tiny()


def _fwd_and_grads(jm, pm, params, inputs, seed):
    """Output, input gradients and parameter gradients of both under
    ``sum(out * g)``."""
    yj = jax.jit(lambda p, *a: functional_call(jm, p, *a))(params, *inputs)
    g = np.random.RandomState(seed).randn(*yj.shape).astype(np.float32)

    def loss(p, *a):
        return jnp.sum(functional_call(jm, p, *a) * g)

    gj = jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs) + 1))))(
        params, *inputs)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    yt = pm(*ins)
    yt.backward(torch.from_numpy(g))
    _close(yt, yj)
    for a, ga in zip(ins, gj[1:]):
        _close(a.grad, ga, atol=1e-4)
    for k, p in pm.named_parameters():
        _close(p.grad, gj[0][k], atol=1e-4)


@pytest.mark.parametrize("in_ch,out_ch", [(48, 64), (64, 64)])
def test_resnet_block(in_ch, out_ch):
    """48 channels in: 24 groups by the while rule and a 1x1 skip conv;
    64 -> 64: the identity skip."""
    jm, pm, params = _pair(
        lambda: junet.ResnetBlock(in_ch, out_ch, 32),
        lambda seed: punet.ResnetBlock(
            in_ch, out_ch, 32, device="cpu",
            generator=torch.Generator().manual_seed(seed)))
    assert pm.norm1._num_groups == (24 if in_ch == 48 else 32)
    assert (pm.skip is None) == (in_ch == out_ch)
    rng = np.random.RandomState(1)
    x = rng.randn(2, in_ch, 6, 6).astype(np.float32)
    temb = rng.randn(2, 32).astype(np.float32)
    _fwd_and_grads(jm, pm, params, (x, temb), seed=2)


@pytest.mark.parametrize("ctx_dim", [32, 64])
def test_transformer_block(ctx_dim):
    """Self- and cross-attention (77 context tokens at bench.py's shape;
    7 here), GELU FFN, GroupNorm + 1x1 convs in and out, 2 heads."""
    jm, pm, params = _pair(
        lambda: junet.TransformerBlock(64, ctx_dim, heads=2),
        lambda seed: punet.TransformerBlock(
            64, ctx_dim, 2, device="cpu",
            generator=torch.Generator().manual_seed(seed)))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 64, 5, 6).astype(np.float32)
    ctx = rng.randn(2, 7, ctx_dim).astype(np.float32)
    _fwd_and_grads(jm, pm, params, (x, ctx), seed=4)


@pytest.mark.parametrize("cfg,b,hw", [("tiny", 2, 16), ("narrow", 2, 16)])
def test_unet_forward(cfg, b, hw):
    """The ``tiny()`` UNet and phase 16's narrow one (4 levels, 2 layers a
    block, 16 x 16 latents, B = 2): the predicted noise."""
    kw = {"tiny": TINY, "narrow": NARROW}[cfg]
    jm, pm, params = _pair(
        lambda: junet.UNet2DConditionModel(**kw),
        lambda seed: UNet2DConditionModel(device="cpu", seed=seed, **kw))
    assert pm.num_params() == jm.num_params()
    inputs = _unet_inputs(b, hw, kw["cross_attention_dim"])
    want = jax.jit(lambda p, *a: functional_call(jm, p, *a))(params, *inputs)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in inputs))
    assert tuple(got.shape) == (b, 4, hw, hw)
    _close(got, want)


@pytest.mark.cuda
def test_multi_step_replay_equals_eager_on_card():
    """On the card: a replayed ``multi_step(3)`` of ``tiny()`` under bf16
    compute and bf16 moments (config 5's step) equals 3 eager steps from
    an equal state, losses and every parameter, master and moment
    tensor, with cuDNN deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")

    def build():
        m = UNetTrain(UNet2DConditionModel.tiny(device=dev, seed=1))
        return CompiledTrainStep(m, lr=1e-4, compute_dtype="bfloat16",
                                 moments_dtype="bfloat16", device=dev)

    x, t, ctx = (torch.from_numpy(a).to(dev)
                 for a in _unet_inputs(2, 16, 32))
    noise = torch.randn(2, 4, 16, 16, generator=torch.Generator(
        dev).manual_seed(5), device=dev)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a, b = build(), build()
        la = [float(a.step(x, t, ctx, noise)) for _ in range(3)]
        b.multi_step(3, x, t, ctx, noise)
        lb = b.last_losses.tolist()
    finally:
        torch.backends.cudnn.deterministic = det
    assert la == lb
    for name in ("params", "_master", "_m", "_v"):
        ta, tb = getattr(a, name), getattr(b, name)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), (name, k)
