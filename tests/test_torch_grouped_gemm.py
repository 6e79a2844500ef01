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


# -- the tensor-core kernels' rounding points -------------------------------------

def _seq_mm(a, b):
    """``a [E, M, K] @ b [E, K, N]`` in f32 with each sum taken over k in
    order (``cumsum``), so trailing zero terms leave it bit for bit."""
    return (a.unsqueeze(-1) * b.unsqueeze(1)).cumsum(2)[:, :, -1]


def tensor_core_model(x, w1, b1, w2, b2, activation="gelu", s1=None,
                      s2=None):
    """The arithmetic of the bf16-x CUDA kernels: bf16 (or int8) products
    exact in f32, summed in f32; s1 on the first product before b1 and
    the activation; h carried as two bf16 terms hi = bf16(h), lo =
    bf16(h - hi), each multiplied by w2; s2 once on the f32 sum over F,
    then b2; one cast to x's dtype.  Biases and scales ``[E, n]``."""
    f = torch.float32
    E = x.shape[0]
    p = _seq_mm(x.to(f), w1.to(f))
    if s1 is not None:
        p = p * s1.to(f).reshape(E, 1, -1)
    h = gg._act_fn(activation)(p + b1.to(f).reshape(E, 1, -1))
    hi = h.bfloat16().to(f)
    lo = (h - hi).bfloat16().to(f)
    acc = _seq_mm(hi, w2.to(f)) + _seq_mm(lo, w2.to(f))
    if s2 is not None:
        acc = acc * s2.to(f).reshape(E, 1, -1)
    return (acc + b2.to(f).reshape(E, 1, -1)).to(x.dtype)


@pytest.mark.parametrize("act", ["gelu", "sigmoid"])
def test_tensor_core_model_matches_pallas_interpret_at_f5504(act):
    """At the MoE config's real F = 5504 (small E, C, H), the kernels'
    rounding points (h as bf16 hi + lo, products exact in f32) stay
    within the file's bf16 tolerance of ``_pallas_ffn``, which keeps h
    in f32."""
    arrs = _operands(2, 16, 128, 5504, seed=43)
    want = _jax(jgg.grouped_ffn, *_jax_args(arrs, "bfloat16"),
                activation=act, impl="pallas")
    got = tensor_core_model(*_torch_args(arrs, "bfloat16"), activation=act)
    _close(got, want, "bfloat16")


def test_int8_tensor_core_model_matches_pallas_q_interpret_at_f5504():
    """The same for ``_pallas_ffn_q``: int8 weights widened to bf16
    (exact), s1 before b1, s2 once on the f32 sum over F where the TPU
    kernel scales each F block's contribution."""
    arrs = _operands(2, 16, 128, 5504, seed=47)
    (jq1, jq2), (tq1, tq2) = _quantized(arrs)
    jx, _, jb1, _, jb2 = _jax_args(arrs, "bfloat16")
    tx, _, tb1, _, tb2 = _torch_args(arrs, "bfloat16")
    want = _jax(jgg.grouped_ffn, jx, jq1, jb1, jq2, jb2, impl="pallas")
    got = tensor_core_model(tx, tq1["qweight"], tb1, tq2["qweight"], tb2,
                            s1=tq1["scale"], s2=tq2["scale"])
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "sigmoid", "tanh"])
def test_padding_for_tma_is_exact(act, int8):
    """H, F off the multiples TMA takes are zero-padded by the wrapper;
    the padded F columns give act(0) (0.5 for sigmoid) times zero rows of
    w2, the padded H columns are sliced off: the padded model sliced back
    equals the unpadded one bit for bit."""
    E, C, H, F = 2, 9, 20, 30
    arrs = _torch_args(_operands(E, C, H, F, seed=53), "bfloat16")
    x, w1, b1, w2, b2 = arrs
    s1 = s2 = None
    if int8:
        _, (q1, q2) = _quantized(_operands(E, C, H, F, seed=53))
        w1, s1, w2, s2 = q1["qweight"], q1["scale"], q2["qweight"], \
            q2["scale"]
    Hp, Fp = gg.tma_padding(H, F, int8)
    assert (Hp, Fp) == ((32, 32) if int8 else (24, 32))
    padded = gg.pad_operands(x, w1, s1, b1.float(), w2, s2, b2.float(), Hp,
                             Fp)
    px, pw1, ps1, pb1, pw2, ps2, pb2 = padded
    assert tuple(px.shape) == (E, C, Hp) and tuple(pw1.shape) == (E, Hp, Fp)
    assert tuple(pw2.shape) == (E, Fp, Hp) and pw1.dtype == w1.dtype
    got = tensor_core_model(px, pw1, pb1, pw2, pb2, act, ps1, ps2)[..., :H]
    want = tensor_core_model(x, w1, b1.float(), w2, b2.float(), act, s1,
                             s2)
    assert torch.equal(got, want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C", [2560, 20])
def test_tensor_core_kernels_at_moe_shapes_on_card(cuda_device, C, int8):
    """Kernels 10 and 11 at the MoE bench bucket (C = 2560) and a decode
    bucket (C = 20, where GEMM 2 splits F), E = 8, H = 2048, F = 5504,
    against the plain version on the card."""
    E, H, F = 8, 2048, 5504
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(59 + C)
    x = torch.randn(E, C, H, generator=gen, device=cuda_device).bfloat16()
    w1, w2 = (torch.randn(E, a, b, generator=gen, device=cuda_device) * 0.02
              for a, b in ((H, F), (F, H)))
    b1 = torch.randn(E, 1, F, generator=gen, device=cuda_device) * 0.02
    b2 = torch.randn(E, 1, H, generator=gen, device=cuda_device) * 0.02
    if int8:
        q1, q2 = tq.quantize_linear(w1), tq.quantize_linear(w2)
        args = (x, q1["qweight"], q1["scale"], b1, q2["qweight"],
                q2["scale"], b2)
        got, want = gg.grouped_ffn_q(*args), gg.grouped_ffn_q_reference(
            *args)
    else:
        args = (x, w1.bfloat16(), b1, w2.bfloat16(), b2)
        got, want = gg.grouped_ffn_fwd(*args), gg.grouped_ffn_reference(
            *args)
    torch.cuda.synchronize()
    _hold_on_card(got, want, "bfloat16")
