"""Grouped expert FFN of the PyTorch port against ``paddle_tpu``.

The port's plain versions (``grouped_ffn_reference`` and
``grouped_ffn_q_reference``, which CPU tensors take on the kernel route)
are held to the JAX package's Pallas kernels ``_pallas_ffn`` and
``_pallas_ffn_q``, run in interpret mode on the CPU through
``grouped_ffn(..., impl="pallas")``; the kernel route's backward to
``jax.grad`` through ``_fused``; ``einsum_ffn`` to JAX's; routing and
errors to ``resolve_impl`` and ``grouped_ffn``.  Inputs are numpy arrays
from a seed, handed to both packages.

Tolerances:
- f32: rtol 1e-5, atol 1e-6 -- f32 products and sums on both sides, in
  other orders (the Pallas kernel block by block over F).
- bf16 output: |got - want| <= 2^-7 |want| + 2e-3 -- both round an f32
  value to bf16, which may land on neighbouring bf16 values (one ulp is
  at most 2^-7 relative); 2e-3 absorbs the f32 differences near zero.

The CUDA kernels themselves are compared with the plain versions on the
card in the ``cuda``-marked tests (skipped where there is none) and in
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import quant as jq
from paddle_tpu.ops.pallas_kernels import grouped_gemm as jgg
from paddle_tpu_torch.ops import quant as tq
from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

SHAPES = [((4, 24, 32, 64), "gelu"),
          ((8, 130, 16, 48), "relu"),   # C not a multiple of a row block
          ((2, 7, 8, 8), "silu")]       # tiny everything
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(E, C, H, F, seed=0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=s) * sc).astype(np.float32) for s, sc in (
        ((E, C, H), 1.0), ((E, H, F), 0.1), ((E, 1, F), 0.1),
        ((E, F, H), 0.1), ((E, 1, H), 0.1))]


def _jax_args(arrs, dtype):
    return [jnp.asarray(a, DT[dtype][0]) for a in arrs]


def _torch_args(arrs, dtype):
    return [torch.from_numpy(a).to(DT[dtype][1]) for a in arrs]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        bound = 2 ** -7 * np.abs(want) + 2e-3
        assert np.all(np.abs(got - want) <= bound), \
            float(np.max(np.abs(got - want) - bound))


def _jax(fn, *a, **kw):
    with jax.enable_x64(False):
        return fn(*a, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,act", SHAPES)
def test_reference_matches_pallas_interpret(shape, act, dtype):
    arrs = _operands(*shape, seed=sum(shape))
    want = _jax(jgg.grouped_ffn, *_jax_args(arrs, dtype), activation=act,
                impl="pallas")
    got = gg.grouped_ffn(*_torch_args(arrs, dtype), activation=act,
                         impl="pallas")
    assert got.dtype == DT[dtype][1] and tuple(got.shape) == shape[:3]
    _close(got, want, dtype)


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "sigmoid", "tanh"])
def test_vjp_matches_jax_grad(act):
    """All five gradients of sum(out^2) through the kernel route's
    backward against jax.grad through ``_fused`` (fp32)."""
    arrs = _operands(4, 24, 32, 64, seed=3)

    def loss(args):
        return jnp.sum(jgg.grouped_ffn(*args, activation=act,
                                       impl="pallas") ** 2)

    want = _jax(jax.grad(loss), _jax_args(arrs, "float32"))
    targs = [a.requires_grad_(True) for a in _torch_args(arrs, "float32")]
    out = gg.grouped_ffn(*targs, activation=act, impl="pallas")
    out.square().sum().backward()
    for i, (t, w) in enumerate(zip(targs, want)):
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=1e-5,
                                   atol=1e-5, err_msg=str(i))


def test_vjp_casts_each_gradient_to_its_operand():
    """bf16 operands: the backward's f32 gradients are cast to bf16 (x,
    w1, w2) while an f32 bias keeps f32, as ``_fused_b`` casts each."""
    arrs = _operands(2, 16, 32, 64, seed=4)
    targs = _torch_args(arrs, "bfloat16")
    targs[2] = targs[2].float()
    targs = [a.requires_grad_(True) for a in targs]
    gg.grouped_ffn(*targs, impl="pallas").float().square().sum().backward()
    assert [t.grad.dtype for t in targs] == [t.dtype for t in targs]


def test_mixed_dtypes_match_pallas_interpret():
    """bf16 x with f32 weights: the kernel widens everything to f32 and
    returns bf16."""
    arrs = _operands(4, 24, 32, 64, seed=5)
    ja, ta = _jax_args(arrs, "float32"), _torch_args(arrs, "float32")
    ja[0], ta[0] = ja[0].astype(jnp.bfloat16), ta[0].bfloat16()
    want = _jax(jgg.grouped_ffn, *ja, impl="pallas")
    got = gg.grouped_ffn(*ta, impl="pallas")
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


def _quantized(arrs):
    """x, q1 dict, b1, q2 dict, b2 for both packages (the port's int8
    weights and scales are bit-identical to paddle_tpu's)."""
    x, w1, b1, w2, b2 = arrs
    jd = [jq.quantize_linear(jnp.asarray(w)) for w in (w1, w2)]
    td = [tq.quantize_linear(torch.from_numpy(w)) for w in (w1, w2)]
    for j, t in zip(jd, td):
        np.testing.assert_array_equal(t["qweight"].numpy(),
                                      np.asarray(j["qweight"]))
        np.testing.assert_array_equal(t["scale"].numpy(),
                                      np.asarray(j["scale"]))
    return jd, td


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,act", [SHAPES[0], SHAPES[1]])
def test_int8_reference_matches_pallas_q_interpret(shape, act, dtype):
    arrs = _operands(*shape, seed=7 + sum(shape))
    (jq1, jq2), (tq1, tq2) = _quantized(arrs)
    jx, _, jb1, _, jb2 = _jax_args(arrs, dtype)
    tx, _, tb1, _, tb2 = _torch_args(arrs, dtype)
    want = _jax(jgg.grouped_ffn, jx, jq1, jb1, jq2, jb2, activation=act,
                impl="pallas")
    got = gg.grouped_ffn(tx, tq1, tb1, tq2, tb2, activation=act,
                         impl="pallas")
    assert got.dtype == DT[dtype][1]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_einsum_route_matches_jax(dtype):
    """The einsum route dequantizes to x's dtype first, in both."""
    arrs = _operands(4, 24, 32, 64, seed=11)
    (jq1, jq2), (tq1, tq2) = _quantized(arrs)
    jx, _, jb1, _, jb2 = _jax_args(arrs, dtype)
    tx, _, tb1, _, tb2 = _torch_args(arrs, dtype)
    want = _jax(jgg.grouped_ffn, jx, jq1, jb1, jq2, jb2, impl="einsum")
    got = gg.grouped_ffn(tx, tq1, tb1, tq2, tb2, impl="einsum")
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,act", SHAPES)
def test_einsum_ffn_matches_jax(shape, act, dtype):
    """The fallback rounds h to x's dtype; so does JAX's."""
    arrs = _operands(*shape, seed=13 + sum(shape))
    want = _jax(jgg.einsum_ffn, *_jax_args(arrs, dtype), act)
    got = gg.einsum_ffn(*_torch_args(arrs, dtype), act)
    assert got.dtype == DT[dtype][1]
    _close(got, want, dtype)


def test_einsum_route_rounds_h_and_kernel_route_does_not():
    """In bf16 the two routes are different functions: the kernel route
    equals the f32 math rounded once, the einsum route does not."""
    arrs = _operands(4, 24, 32, 64, seed=17)
    args = _torch_args(arrs, "bfloat16")
    kern = gg.grouped_ffn(*args, impl="pallas")
    eins = gg.grouped_ffn(*args, impl="einsum")
    f32 = gg.grouped_ffn_reference(*[a.float() for a in args]).bfloat16()
    assert torch.equal(kern, f32)
    assert not torch.equal(eins, kern)


def test_resolve_impl_matches_jax(monkeypatch):
    monkeypatch.delenv("PT_GROUPED_GEMM", raising=False)
    for impl in (None, "auto", "pallas", "einsum", "PALLAS"):
        assert gg.resolve_impl(128, 256, impl) == \
            jgg.resolve_impl(128, 256, impl)
    for value in ("pallas", "einsum", "auto"):
        monkeypatch.setenv("PT_GROUPED_GEMM", value)
        assert gg.resolve_impl(128, 256) == jgg.resolve_impl(128, 256)
    monkeypatch.setenv("PT_GROUPED_GEMM", "bogus")
    for fn in (gg.resolve_impl, jgg.resolve_impl):
        with pytest.raises(ValueError, match="auto|pallas|einsum"):
            fn(128, 256)
    monkeypatch.delenv("PT_GROUPED_GEMM")
    for h, f in ((128, 256), (2048, 5504), (130, 256), (128, 48)):
        for acc in (True, False):
            assert gg.supported(h, f, acc) == jgg.supported(h, f, acc)
    # on CUDA, auto takes the kernel exactly where the TPU would
    assert gg.resolve_impl(2048, 5504, accelerated=True) == "pallas"
    assert gg.resolve_impl(2048, 5500, accelerated=True) == "einsum"


def test_auto_on_cpu_takes_einsum(monkeypatch):
    monkeypatch.delenv("PT_GROUPED_GEMM", raising=False)
    args = _torch_args(_operands(2, 16, 128, 128, seed=19), "bfloat16")
    assert torch.equal(gg.grouped_ffn(*args),
                       gg.einsum_ffn(*args, "gelu"))


def test_errors_match_jax():
    arrs = _operands(2, 8, 16, 32, seed=23)
    (jq1, _), (tq1, _) = _quantized(arrs)
    ja, ta = _jax_args(arrs, "float32"), _torch_args(arrs, "float32")
    with pytest.raises(ValueError, match="both be quantized"):
        jgg.grouped_ffn(ja[0], jq1, ja[2], ja[3], ja[4])
    with pytest.raises(ValueError, match="both be quantized"):
        gg.grouped_ffn(ta[0], tq1, ta[2], ta[3], ta[4])
    with pytest.raises(ValueError, match="activation"):
        gg.grouped_ffn(*ta, activation="softsign", impl="pallas")
    with pytest.raises(ValueError, match="do not match"):
        gg.grouped_ffn_fwd(ta[0], ta[3], ta[2], ta[1], ta[4])


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    arrs = _operands(2, 8, 16, 32, seed=29)
    ta = _torch_args(arrs, "float32")
    _, (q1, q2) = _quantized(arrs)
    before = (gg.grouped_ffn.launches, gg.grouped_ffn_q.launches)
    got = gg.grouped_ffn_fwd(*ta)
    assert torch.equal(got, gg.grouped_ffn_reference(*ta))
    gotq = gg.grouped_ffn_q(ta[0], q1["qweight"], q1["scale"], ta[2],
                            q2["qweight"], q2["scale"], ta[4])
    assert torch.equal(gotq, gg.grouped_ffn_q_reference(
        ta[0], q1["qweight"], q1["scale"], ta[2], q2["qweight"],
        q2["scale"], ta[4]))
    assert (gg.grouped_ffn.launches, gg.grouped_ffn_q.launches) == before


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false); chip_smoke.py runs this check on the card")
    return torch.device("cuda")


def _hold_on_card(got, want, dtype):
    """bf16: one ulp (2^-7 |want|) plus 1e-3 of max |want| for the f32
    sums before rounding; f32: 1e-5 relative plus 1e-5 of max |want|, for
    sums of up to 2048 products in another order (their rounding scales
    with the terms, not with the result)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if dtype == "bfloat16":
        bound = 2 ** -7 * w.abs() + 1e-3 * w.abs().max()
    else:
        bound = 1e-5 * w.abs() + 1e-5 * w.abs().max()
    assert bool(((g - w).abs() <= bound).all()), \
        float(((g - w).abs() - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,act", SHAPES + [
    ((2, 40, 256, 384), "gelu"), ((3, 70, 2176, 192), "tanh"),
    ((2, 33, 136, 200), "sigmoid")])
def test_kernel_matches_plain_on_card(cuda_device, shape, act, dtype):
    """Every kernel path: vector and element loads, column slices past
    2048, F splits, ragged C, H and F."""
    arrs = _operands(*shape, seed=31 + sum(shape))
    args = [a.to(cuda_device) for a in _torch_args(arrs, dtype)]
    got = gg.grouped_ffn_fwd(*args, activation=act)
    torch.cuda.synchronize()
    _hold_on_card(got, gg.grouped_ffn_reference(*args, activation=act),
                  dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 24, 32, 64), (2, 40, 256, 384),
                                   (3, 20, 2048, 640)])
def test_int8_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    arrs = _operands(*shape, seed=37 + sum(shape))
    _, (q1, q2) = _quantized(arrs)
    x, _, b1, _, b2 = [a.to(cuda_device) for a in _torch_args(arrs, dtype)]
    args = (x, q1["qweight"].to(cuda_device), q1["scale"].to(cuda_device),
            b1, q2["qweight"].to(cuda_device), q2["scale"].to(cuda_device),
            b2)
    got = gg.grouped_ffn_q(*args)
    torch.cuda.synchronize()
    _hold_on_card(got, gg.grouped_ffn_q_reference(*args), dtype)


@pytest.mark.cuda
def test_kernel_route_backward_on_card(cuda_device):
    """The kernel route's gradients on the card equal the CPU's within
    f32 summation order."""
    arrs = _operands(4, 24, 128, 256, seed=41)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        ta = [a.to(dev).requires_grad_(True)
              for a in _torch_args(arrs, "float32")]
        gg.grouped_ffn(*ta, impl="pallas").square().sum().backward()
        grads.append([t.grad.cpu() for t in ta])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
