"""Fused RMSNorm of the PyTorch port against ``paddle_tpu``'s Pallas kernel.

The same seeded numpy inputs go through ``paddle_tpu``'s
``_fused_fwd_2d`` / ``_fused_bwd_2d`` (Pallas, interpret mode on the CPU)
and ``jax.grad(fused_rms_norm_fn)``, and through the port's plain
versions, its wrappers (which take the plain versions for CPU tensors)
and its autograd ``Function``.  N is not a multiple of 256, so the TPU
version's row padding is exercised.

Tolerances: fp32 atol 1e-5 (fp32 on both sides, other summation
orders); bf16 outputs 2^-7 * |want| + 1e-6 (the two fp32 results may
round to neighbouring bf16 values); dw rtol 1e-5 in fp32 and 1e-2 with a
bf16 x (a sum over 300 rows of fp32 products of bf16 values).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels.rms_norm import (
    _fused_bwd_2d, _fused_fwd_2d, fused_rms_norm_fn,
)
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.kernels import rms_norm as rn

N, H, EPS = 300, 128, 1e-5
CASES = {"fp32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(H)).astype(np.float32)
    dy = rng.randn(N, H).astype(np.float32)
    return x, w, dy


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype_name, kind="out"):
    got, want = _np(got), _np(want)
    if kind == "dw":
        rtol = 1e-5 if dtype_name == "fp32" else 1e-2
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    elif dtype_name == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        excess = np.abs(got - want) - (2 ** -7 * np.abs(want) + 1e-6)
        assert excess.max() <= 0, excess.max()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_kernels(name):
    """fwd (out, rstd) and bwd (dx) of the port's plain versions against
    the Pallas kernels in interpret mode; x in the case's dtype, w fp32."""
    jd, td = CASES[name]
    x, w, dy = _inputs()
    jx, jw, jdy = jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(dy, jd)
    tx, tw = torch.from_numpy(x).to(td), torch.from_numpy(w)
    tdy = torch.from_numpy(dy).to(td)

    jout, jrstd = _fused_fwd_2d(jx, jw, EPS)
    out, rstd = rn.rms_norm_fwd_reference(tx, tw, EPS)
    assert out.dtype == td and rstd.dtype == torch.float32
    assert out.shape == (N, H) and rstd.shape == (N,)
    _close(out, jout, name)
    np.testing.assert_allclose(_np(rstd), _np(jrstd), rtol=1e-6, atol=0)

    jdx = _fused_bwd_2d(jx, jw, jrstd, jdy)
    dx = rn.rms_norm_bwd_reference(tx, tw, torch.from_numpy(_np(jrstd)),
                                   tdy)
    assert dx.dtype == td
    _close(dx, jdx, name)


@pytest.mark.parametrize("name", list(CASES))
def test_function_matches_jax_grad(name):
    """The autograd Function (CPU: the plain versions through the
    wrappers) gives jax.grad(fused_rms_norm_fn)'s out, dx and dw on a
    [3, 100, H] input."""
    jd, td = CASES[name]
    x, w, dy = _inputs(1)
    x3, dy3 = x.reshape(3, 100, H), dy.reshape(3, 100, H)
    jx, jw, jdy = jnp.asarray(x3, jd), jnp.asarray(w), jnp.asarray(dy3, jd)

    jout, vjp = jax.vjp(lambda a, b: fused_rms_norm_fn(a, b, epsilon=EPS),
                        jx, jw)
    jdx, jdw = vjp(jdy)

    tx = torch.from_numpy(x3).to(td).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    before = (rn.rms_norm_fwd.launches, rn.rms_norm_bwd.launches)
    out = rn.fused_rms_norm(tx, tw, EPS)
    out.backward(torch.from_numpy(dy3).to(td))
    assert (rn.rms_norm_fwd.launches, rn.rms_norm_bwd.launches) == before, \
        "CPU tensors must take the plain versions, not count launches"
    assert out.dtype == td and tx.grad.dtype == td
    assert tw.grad.dtype == torch.float32
    _close(out, jout, name)
    _close(tx.grad, jdx, name)
    _close(tw.grad, jdw, name, kind="dw")


def test_wrappers_take_plain_on_cpu():
    x, w, dy = _inputs(2)
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    out, rstd = rn.rms_norm_fwd(tx, tw, EPS)
    want, wrstd = rn.rms_norm_fwd_reference(tx, tw, EPS)
    assert torch.equal(out, want) and torch.equal(rstd, wrstd)
    assert torch.equal(rn.rms_norm_bwd(tx, tw, rstd, tdy),
                       rn.rms_norm_bwd_reference(tx, tw, rstd, tdy))
    with pytest.raises(ValueError, match=r"expected x \[N, h\]"):
        rn.rms_norm_fwd(tx, tw[:-1], EPS)


def test_fused_rounding_differs_from_plain_op_on_bf16():
    """The fused rule casts x*rstd*w once; the plain op casts x*rstd, then
    multiplies by w cast to bf16.  With an fp32 weight the two differ, and
    the flag picks between them."""
    x, w, _ = _inputs(3)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w)
    fused, _ = rn.rms_norm_fwd_reference(tx, tw, EPS)
    plain = nn_ops.rms_norm(tx, tw, EPS)
    assert not torch.equal(fused, plain)
    assert flag("FLAGS_use_fused_rms_norm") is False
    norm = RMSNorm(H, EPS, device="cpu")
    with torch.no_grad():
        norm.weight.copy_(tw)
        assert torch.equal(norm(tx), plain)
        set_flags({"FLAGS_use_fused_rms_norm": True})
        try:
            assert flag("use_fused_rms_norm") is True
            assert torch.equal(norm(tx), fused)
            assert torch.equal(F.rms_norm(tx, tw, EPS), fused)
        finally:
            set_flags({"FLAGS_use_fused_rms_norm": False})
    with pytest.raises(ValueError, match="Unknown flag"):
        set_flags({"FLAGS_no_such_flag": True})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("xd,wd", [(torch.float32, torch.float32),
                                   (torch.bfloat16, torch.float32),
                                   (torch.bfloat16, torch.bfloat16)])
def test_kernels_match_plain_on_card(cuda_device, xd, wd):
    x, w, dy = _inputs(4)
    tx = torch.from_numpy(x).to(cuda_device, xd)
    tw = torch.from_numpy(w).to(cuda_device, wd)
    tdy = torch.from_numpy(dy).to(cuda_device, xd)
    out, rstd = rn.rms_norm_fwd(tx, tw, EPS)
    dx = rn.rms_norm_bwd(tx, tw, rstd, tdy)
    torch.cuda.synchronize()
    want, wrstd = rn.rms_norm_fwd_reference(tx, tw, EPS)
    wdx = rn.rms_norm_bwd_reference(tx, tw, wrstd, tdy)
    name = "fp32" if xd == torch.float32 else "bf16"
    _close(out.cpu(), want.cpu(), name)
    _close(dx.cpu(), wdx.cpu(), name)
    np.testing.assert_allclose(_np(rstd.cpu()), _np(wrstd.cpu()),
                               rtol=1e-6)
