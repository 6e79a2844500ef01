"""The diffusion path's ops and layers of the PyTorch port against
``paddle_tpu``: GroupNorm, interpolate, softmax, SiLU, GELU (erf and
tanh), the Linear dtype promotion and the timestep embedding.

The same seeded numpy inputs go through the JAX op (``paddle_tpu/ops/
nn_ops.py``'s plain functions, or the ``nn.functional`` wrappers with the
eager tape for gradients) and the port's, on the CPU.

Tolerances:
- fp32 values and gradients: atol 1e-5 times the largest magnitude (at
  least 1) (fp32 on both sides, sums in other orders);
- GroupNorm with a bf16 x and fp32 parameters: the output is fp32 in both
  packages, and within one bf16 ulp (2^-8 relative) of the larger
  magnitude elementwise: the statistics round to bf16 at the same points
  in both, but their fp32 sums run in other orders, so a value near a
  rounding boundary can round the other way;
- interpolate nearest: bit for bit (an index rule); bilinear, with the
  reference's antialiasing when it shrinks: atol 1e-6 (values of order 1);
  bicubic: atol 1e-5 of the largest magnitude;
- the Linear promotion: an fp32 x times a bf16 weight equals the fp32
  product of the bf16-rounded weight exactly; with equal dtypes the
  output is ``torch.matmul``'s, bit for bit;
- the timestep embedding: its argument ``t * freqs`` bit for bit, its
  cosines and sines within one fp32 ulp of |v| <= 1 (atol 2^-23): the
  port rounds fp64 values once (the correctly rounded ones), XLA's CPU
  cos and sin are their own approximations.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models.unet import timestep_embedding as j_temb
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models.unet import timestep_embedding as p_temb
from paddle_tpu_torch.models.unet import timestep_frequencies
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import nn_ops


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_data"):
        a = a._data
    return np.array(jnp.asarray(a, jnp.float32))


def _close(got, want, atol=1e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


def _jt(a, grad=False):
    return paddle.to_tensor(np.asarray(a), stop_gradient=not grad)


# -- group norm ---------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("C,groups", [(64, 32), (48, 24), (6, 6)])
def test_group_norm_fp32_forward_and_grads(fmt, C, groups):
    """Values and the gradients of x, weight and bias; 48 channels take 24
    groups by the ResnetBlock's rule, 6 channels one group each."""
    rng = np.random.RandomState(C)
    shape = (2, C, 5, 7) if fmt == "NCHW" else (2, 5, 7, C)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    w = rng.randn(C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    xj, wj, bj = _jt(x, True), _jt(w, True), _jt(b, True)
    yj = JF.group_norm(xj, groups, wj, bj, 1e-5, fmt)
    paddle.sum(yj * _jt(g)).backward()
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w, b))
    yt = PF.group_norm(xt, groups, wt, bt, 1e-5, fmt)
    yt.backward(torch.from_numpy(g))
    _close(yt, yj)
    _close(xt.grad, xj.grad)
    _close(wt.grad, wj.grad)
    _close(bt.grad, bj.grad)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_group_norm_bf16_x_fp32_params_promote(fmt):
    """A bf16 x with fp32 parameters gives fp32 in both packages (jnp's
    promotion at ``* weight``), unlike LayerNorm, which stays bf16."""
    rng = np.random.RandomState(1)
    shape = (2, 64, 6, 6) if fmt == "NCHW" else (2, 6, 6, 64)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    want = jops._group_norm_plain(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w), jnp.asarray(b), 1e-5, 32,
                                  fmt)
    got = nn_ops.group_norm(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(w), torch.from_numpy(b), 1e-5,
                            32, fmt)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, atol=2.0 ** -8)
    ln = nn_ops.layer_norm(torch.from_numpy(x).bfloat16(),
                           torch.ones(shape[-1]), torch.zeros(shape[-1]))
    assert ln.dtype == torch.bfloat16


def test_group_norm_layers():
    """``GroupNorm``'s parameters (ones, zeros; dropped with ``False``)
    and ``InstanceNorm2D`` (one group a channel) against the
    reference's layers."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 4, 4).astype(np.float32)
    gn = pnn.GroupNorm(4, 12, device="cpu")
    assert torch.equal(gn.weight, torch.ones(12))
    assert torch.equal(gn.bias, torch.zeros(12))
    assert pnn.GroupNorm(4, 12, weight_attr=False, bias_attr=False,
                         device="cpu").weight is None
    _close(gn(torch.from_numpy(x)), jnn.GroupNorm(4, 12)(_jt(x)))
    _close(pnn.InstanceNorm2D(12, device="cpu")(torch.from_numpy(x)),
           jnn.InstanceNorm2D(12)(_jt(x)))


# -- interpolate -------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("src,dst", [(4, 8), (5, 3), (3, 5), (8, 4),
                                     (7, 10)])
def test_interpolate_nearest_bit_for_bit(fmt, src, dst):
    """The reference's nearest index rule at 2x and off integer scales
    (torch's plain ``"nearest"`` would take other pixels at 5 -> 3 and
    8 -> 4)."""
    rng = np.random.RandomState(src * 10 + dst)
    shape = (2, 3, src, src + 1) if fmt == "NCHW" else (2, src, src + 1, 3)
    x = rng.randn(*shape).astype(np.float32)
    size = (dst, dst + 2)
    want = _np(JF.interpolate(_jt(x), size=size, mode="nearest",
                              data_format=fmt))
    got = PF.interpolate(torch.from_numpy(x), size=size, mode="nearest",
                         data_format=fmt).numpy()
    np.testing.assert_array_equal(got, want)


def test_interpolate_nearest_differs_from_torch_nearest():
    """Why the port maps ``"nearest"`` to ``"nearest-exact"``."""
    x = torch.arange(5.0).reshape(1, 1, 1, 5)
    plain = torch.nn.functional.interpolate(x, size=(1, 3), mode="nearest")
    want = _np(JF.interpolate(_jt(x.numpy()), size=(1, 3), mode="nearest"))
    assert not np.array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(
        PF.interpolate(x, size=(1, 3)).numpy(), want)


@pytest.mark.parametrize("src,dst", [(4, 8), (5, 3), (8, 4), (7, 10)])
def test_interpolate_bilinear(src, dst):
    """Half-pixel centres, antialiased when shrinking, ``align_corners``
    ignored as the reference ignores it; the gradient too."""
    rng = np.random.RandomState(src + dst)
    x = rng.randn(2, 3, src, src).astype(np.float32)
    g = rng.randn(2, 3, dst, dst).astype(np.float32)
    xj = _jt(x, True)
    yj = JF.interpolate(xj, size=(dst, dst), mode="bilinear",
                        align_corners=True)
    paddle.sum(yj * _jt(g)).backward()
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = PF.interpolate(xt, size=(dst, dst), mode="bilinear",
                        align_corners=True)
    yt.backward(torch.from_numpy(g))
    _close(yt, yj, atol=1e-6)
    _close(xt.grad, xj.grad, atol=1e-6)


def test_interpolate_scale_factor_upsample_and_bicubic():
    """The size rule ``int(h * scale_factor)``, the ``Upsample`` layer
    and ``upsample``; bicubic is ``jax.image.resize``'s cubic (Keys'
    a = -0.5, taps renormalised at the edges), up and down, antialiased
    when it shrinks (``F.interpolate``) and not (``cubic_resize`` against
    ``jax.image.resize(antialias=False)``), and NHWC; within atol 1e-5 of
    the largest magnitude."""
    import jax

    x = np.random.RandomState(3).randn(1, 2, 3, 5).astype(np.float32)
    want = _np(JF.interpolate(_jt(x), scale_factor=1.5))
    got = PF.upsample(torch.from_numpy(x), scale_factor=1.5)
    assert tuple(got.shape) == want.shape == (1, 2, 4, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pnn.Upsample(scale_factor=1.5)(torch.from_numpy(x)).numpy(), want)
    big = np.random.RandomState(4).randn(2, 3, 11, 9).astype(np.float32)
    for a, size, fmt in ((x, (6, 10), "NCHW"), (big, (4, 5), "NCHW"),
                         (big.transpose(0, 2, 3, 1), (7, 13), "NHWC")):
        _close(PF.interpolate(torch.from_numpy(a), size=size,
                              mode="bicubic", data_format=fmt),
               JF.interpolate(_jt(a), size=size, mode="bicubic",
                              data_format=fmt))
    _close(nn_ops.cubic_resize(torch.from_numpy(big), (4, 12),
                               antialias=False),
           jax.image.resize(big, (2, 3, 4, 12), method="cubic",
                            antialias=False))


# -- softmax, SiLU, GELU ------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_and_grad(axis):
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 5, 7) * 4).astype(np.float32)
    g = rng.randn(3, 5, 7).astype(np.float32)
    xj = _jt(x, True)
    yj = paddle.nn.functional.softmax(xj, axis=axis)
    paddle.sum(yj * _jt(g)).backward()
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = pnn.Softmax(axis)(xt)
    yt.backward(torch.from_numpy(g))
    _close(yt, yj)
    _close(xt.grad, xj.grad)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activation_layers_and_grads(act):
    rng = np.random.RandomState(5)
    x = (rng.randn(4, 33) * 3).astype(np.float32)
    g = rng.randn(4, 33).astype(np.float32)
    jl, pl = {"silu": (jnn.Silu(), pnn.Silu()),
              "gelu": (jnn.GELU(), pnn.GELU())}[act]
    xj = _jt(x, True)
    yj = jl(xj)
    paddle.sum(yj * _jt(g)).backward()
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = pl(xt)
    yt.backward(torch.from_numpy(g))
    _close(yt, yj)
    _close(xt.grad, xj.grad)
    if act == "gelu":           # the tanh form, as jax.nn.gelu's
        xj, xt = _jt(x, True), torch.from_numpy(x).requires_grad_(True)
        yj = jnn.GELU(approximate=True)(xj)
        paddle.sum(yj * _jt(g)).backward()
        yt = pnn.GELU(approximate=True)(xt)
        yt.backward(torch.from_numpy(g))
        _close(yt, yj)
        _close(xt.grad, xj.grad)


# -- Linear's dtype promotion ---------------------------------------------------

def test_linear_promotes_mixed_float_dtypes():
    """fp32 x and a bf16 weight compute in fp32 (``jnp.matmul``'s
    promotion; ``torch.matmul`` refuses the pair), and the bf16 bias is
    added in fp32; the reference gives the same."""
    rng = np.random.RandomState(6)
    x = rng.randn(3, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    lin = pnn.Linear(16, 8, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    lin.to(torch.bfloat16)
    got = lin(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = torch.from_numpy(x) @ lin.weight.float() + lin.bias.float()
    assert torch.equal(got, want)
    jl = jnn.Linear(16, 8)
    jl.weight._data = jnp.asarray(w, jnp.bfloat16)
    jl.bias._data = jnp.asarray(b, jnp.bfloat16)
    yj = jl(_jt(x))
    assert yj._data.dtype == jnp.float32
    _close(got, yj)
    # a bf16 x and an fp32 weight: fp32 as well
    lin32 = pnn.Linear(16, 8, device="cpu")
    with torch.no_grad():
        lin32.weight.copy_(torch.from_numpy(w))
    assert lin32(torch.from_numpy(x).bfloat16()).dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_equal_dtypes_unchanged(dtype):
    """Equal dtypes take the path they took before: ``torch.matmul``, then
    the bias in the product's dtype, bit for bit."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 5, 16).astype(np.float32)).to(dtype)
    lin = pnn.Linear(16, 24, device="cpu", dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.randn(16, 24).astype(
            np.float32)))
        lin.bias.copy_(torch.from_numpy(rng.randn(24).astype(np.float32)))
    got = lin(x)
    assert got.dtype == dtype
    assert torch.equal(got, torch.matmul(x, lin.weight) + lin.bias)


# -- the timestep embedding --------------------------------------------------------

@pytest.mark.parametrize("dim", [32, 320])
def test_timestep_embedding(dim):
    t = np.random.RandomState(8).randint(0, 1000, (16,)).astype(np.int32)
    t[:2] = (0, 999)
    want = _np(j_temb(_jt(t), dim))
    got = p_temb(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -23)
    # the argument of cos / sin is the reference's fp32 product exactly
    half = dim // 2
    freqs = np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float32)
                   / half)
    assert freqs.dtype == np.float32
    arg = jnp.asarray(t).astype(jnp.float32)[:, None] * jnp.asarray(
        freqs)[None, :]
    np.testing.assert_array_equal(timestep_frequencies(dim), freqs)
    targ = torch.from_numpy(t).float()[:, None] * torch.from_numpy(
        timestep_frequencies(dim))[None, :]
    np.testing.assert_array_equal(targ.numpy(), np.asarray(arg))
    # the correctly rounded values of that argument
    np.testing.assert_array_equal(
        got.numpy(), np.concatenate([np.cos(targ.double().numpy()),
                                     np.sin(targ.double().numpy())],
                                    -1).astype(np.float32))


def test_layer_list_names_children_by_index():
    """``LayerList`` (torch's ``ModuleList``) names its children ``0``,
    ``1``, ... as ``paddle_tpu``'s does, nested too."""
    inner = pnn.LayerList([pnn.Linear(2, 2, bias_attr=False, device="cpu")])
    inner.append(pnn.GroupNorm(1, 2, device="cpu"))
    outer = pnn.LayerList([pnn.Identity(), inner])
    assert sorted(k for k, _ in outer.named_parameters()) == [
        "1.0.weight", "1.1.bias", "1.1.weight"]
    assert outer[-1] is inner and len(outer) == 2
