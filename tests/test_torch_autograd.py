"""The port's autograd (``paddle_tpu_torch/autograd``: ``grad``,
``backward``, hooks, saved-tensor hooks, ``PyLayer``, ``jacobian`` /
``hessian`` / ``jvp`` / ``vjp``) against ``paddle_tpu``'s on the CPU, on
the same seeded numpy inputs, and the second-order behaviour of every
``torch.autograd.Function`` of the port against the reference's for the
same op.

Second order: ``g = grad(f(x), x, create_graph=True)``, then
``h = grad(reduce(g), x)``.  Where the reference computes h the port
must give the same (fp32, within 1e-5 of the largest magnitude); where
the reference raises (its kernels' backwards are Pallas calls, which
have no derivative: the fused RMSNorm, short and long attention, the
grouped expert FFN), the port's kernel Function raises too.  The three
cases of fault 2 (the fused RMSNorm, a train-mode BatchNorm2D, the cross
entropy) are tests of their own.  The reference's kernels run in Pallas
interpret mode, as its own tests run them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.kernels import grouped_gemm as pgg
from paddle_tpu_torch.ops.kernels import long_attention as pla
from paddle_tpu_torch.ops.kernels import short_attention as psa

RNG = np.random.default_rng(23)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _f(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a._data if hasattr(a, "_data") else a)


def close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def both(*arrays, grad=True):
    """The same numpy arrays as (port tensors, reference tensors)."""
    p = [paddle.to_tensor(a, stop_gradient=not grad) for a in arrays]
    r = [ref.to_tensor(a, stop_gradient=not grad) for a in arrays]
    return p, r


def second_order(P, x, f, reduce):
    (g,) = P.grad(f(x), x, create_graph=True)
    (h,) = P.grad(reduce(g), x)
    return g, h


# -- grad / backward / hooks ---------------------------------------------------------

def test_grad_contract_matches_reference():
    """A list with one gradient per input; ``.grad`` untouched; an unused
    input raises unless ``allow_unused`` (then None); ``grad_outputs``
    weight a non-scalar output; the graph is freed without
    ``retain_graph`` (a second call raises)."""
    a, b = _f(3, 4), _f(3, 4)
    outs = {}
    for P, (x, y, z) in ((paddle, both(a, b, a)[0]), (ref, both(a, b, a)[1])):
        out = P.tanh(x) * y + x * x
        gx, gy = P.grad(out, [x, y], grad_outputs=P.ones_like(out),
                        retain_graph=True)
        assert x.grad is None and y.grad is None
        with pytest.raises(RuntimeError, match="appears unused"):
            P.grad(out.sum(), [x, z], retain_graph=True)
        gz = P.grad(out.sum(), [x, z], allow_unused=True)
        assert gz[1] is None
        outs[P.__name__] = (gx, gy, gz[0])
    for g, w in zip(outs["paddle_tpu_torch"], outs["paddle_tpu"]):
        close(g, w)
    x = paddle.to_tensor(a, stop_gradient=False)
    out = (x * x).sum()
    paddle.grad(out, x)
    with pytest.raises(RuntimeError):
        paddle.grad(out, x)


def test_backward_and_hooks_match_reference():
    """``autograd.backward`` accumulates into ``.grad``; a hook on a
    leaf used twice sees the summed gradient once and its return value
    replaces it; a hook on an intermediate rewrites what flows on."""
    a = _f(4, 3)
    res = {}
    for P in (paddle, ref):
        x = P.to_tensor(a, stop_gradient=False)
        seen = []
        x.register_hook(lambda g: seen.append(g) or g * 2)
        mid = P.sin(x)
        mid.register_hook(lambda g: g + 1)
        P.autograd.backward([(mid * x).sum() + (x * 3).sum()])
        P.autograd.backward([(x * x).sum()])
        assert len(seen) == 2
        res[P.__name__] = (x.grad, seen[0])
    for g, w in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        close(g, w)


def test_saved_tensors_hooks_round_trip():
    """Pack and unpack run on what a backward keeps; the gradients equal
    the unhooked ones (and the reference's)."""
    a = _f(5, 4)
    packed = []

    def pack(t):
        packed.append(1)
        return t.clone()

    x = paddle.to_tensor(a, stop_gradient=False)
    with paddle.autograd.saved_tensors_hooks(pack, lambda t: t):
        y = (paddle.exp(x) * x).sum()
    (g,) = paddle.grad(y, x)
    assert packed
    r = ref.to_tensor(a, stop_gradient=False)
    with ref.autograd.saved_tensors_hooks(lambda t: t, lambda t: t):
        ry = (ref.exp(r) * r).sum()
    (rg,) = ref.grad(ry, r)
    close(g, rg)


class _Cube:
    @staticmethod
    def forward(ctx, x, y, scale=1.0):
        ctx.save_for_backward(x, y)
        ctx.scale = scale
        return x ** 3 * scale, x * y

    @staticmethod
    def backward(ctx, g1, g2):
        x, y = ctx.saved_tensor
        return 3 * x * x * g1 * ctx.scale + g2 * y      # y's grad omitted


def test_pylayer_matches_reference():
    """A PyLayer with two outputs, a keyword argument, ``saved_tensor``
    and fewer gradients than inputs (the rest None): the same values
    and gradients in both packages; differentiating it twice raises in
    both."""
    a, b = _f(3, 4), _f(3, 4)
    res = {}
    for P, (x, y) in ((paddle, both(a, b)[0]), (ref, both(a, b)[1])):
        layer = type("Cube", (P.autograd.PyLayer,), dict(vars(_Cube)))
        o1, o2 = layer.apply(x, y, scale=2.0)
        (o1.sum() + o2.sum()).backward()
        res[P.__name__] = (o1, o2, x.grad)
        assert y.grad is None or not _np(y.grad).any()
        x2 = P.to_tensor(a, stop_gradient=False)
        with pytest.raises(NotImplementedError, match="PyLayer"):
            (g,) = P.grad(layer.apply(x2, y)[0].sum(), x2,
                          create_graph=True)
            P.grad(g.sum(), x2)
    for g, w in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        close(g, w)
    ctx = paddle.autograd.PyLayerContext()
    ctx.save_for_backward(1, 2)
    assert ctx.saved_tensor == (1, 2) and ctx.saved_tensor_list() == [1, 2]


def test_functional_transforms_match_reference():
    """vjp (default and given v), jvp, jacobian (one and two inputs) and
    hessian, values as the reference's."""
    a, b = _f(4), _f(4)

    def f(P):
        return lambda x: P.sin(x) * x + x * x * x

    def g2(P):
        return lambda x, y: P.tanh(x) * y

    pa, ra = both(a)
    got = [paddle.autograd.vjp(f(paddle), pa[0]),
           paddle.autograd.vjp(f(paddle), pa[0], paddle.to_tensor(b)),
           paddle.autograd.jvp(f(paddle), pa[0], paddle.to_tensor(b)),
           (paddle.autograd.jacobian(f(paddle), pa[0]),),
           paddle.autograd.jacobian(g2(paddle), [pa[0], paddle.to_tensor(b)]),
           (paddle.autograd.hessian(lambda x: (x ** 3).sum(), pa[0]),)]
    want = [ref.autograd.vjp(f(ref), ra[0]),
            ref.autograd.vjp(f(ref), ra[0], ref.to_tensor(b)),
            ref.autograd.jvp(f(ref), ra[0], ref.to_tensor(b)),
            (ref.autograd.jacobian(f(ref), ra[0]),),
            ref.autograd.jacobian(g2(ref), [ra[0], ref.to_tensor(b)]),
            (ref.autograd.hessian(lambda x: (x ** 3).sum(), ra[0]),)]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            close(g, w)
    assert paddle.incubate.autograd.hessian is paddle.autograd.hessian


# -- second order of every autograd Function ----------------------------------------

def test_fault2_fused_rms_norm_refuses_as_reference():
    """Fault 2, case 1: the fused RMSNorm (``FusedRMSNorm``) under
    create_graph.  The reference raises at the first create_graph grad
    (its backward is a Pallas call); the port raised nothing and gave a
    partial second derivative (56.84 against the true 159.77): it now
    raises at the same point.  The plain route keeps the true one."""
    a, w = _f(4, 8), _f(8)
    for P, err in ((paddle, RuntimeError), (ref, ValueError)):
        P.set_flags({"FLAGS_use_fused_rms_norm": True})
        try:
            x, wt = P.to_tensor(a, stop_gradient=False), P.to_tensor(w)
            with pytest.raises(err):
                second_order(P, x, lambda u: (
                    P.nn.functional.rms_norm(u, wt) ** 3).sum(),
                    lambda g: g.sum())
        finally:
            P.set_flags({"FLAGS_use_fused_rms_norm": False})
    x = paddle.to_tensor(a, stop_gradient=False)
    _, h = second_order(paddle, x, lambda u: (paddle.nn.functional.rms_norm(
        u, paddle.to_tensor(w)) ** 3).sum(), lambda g: g.sum())
    rx = ref.to_tensor(a, stop_gradient=False)
    _, rh = second_order(ref, rx, lambda u: (ref.nn.functional.rms_norm(
        u, ref.to_tensor(w)) ** 3).sum(), lambda g: g.sum())
    close(h, rh)


def test_fault2_batch_norm_train_second_order():
    """Fault 2, case 2: a train-mode BatchNorm2D (``_BatchNormTrain``).
    The port gave Σ|h| = 88.03; the true h is 0 (a train-mode batch
    norm's dx sums to 0 per channel), as the reference computes."""
    a = _f(4, 3, 5, 5)
    res = {}
    for P, (x,) in ((paddle, both(a)[0]), (ref, both(a)[1])):
        bn = P.nn.BatchNorm2D(3)
        bn.train()
        res[P.__name__] = second_order(P, x, lambda u: (bn(u) ** 3).sum(),
                                       lambda g: g.sum())
    for g, w in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        close(g, w)
    assert float(np.abs(_np(res["paddle_tpu_torch"][1])).sum()) < 1e-3


def test_fault2_cross_entropy_second_order():
    """Fault 2, case 3: ``F.cross_entropy`` (``_SoftmaxCrossEntropy``),
    reduce = Σg².  The port raised ("does not require grad"); the
    reference gives 0.08460 at its inputs."""
    a, lab = _f(6, 5), np.array([0, 1, 2, 3, 4, 0])
    res = {}
    for P in (paddle, ref):
        x, y = P.to_tensor(a, stop_gradient=False), P.to_tensor(lab)
        res[P.__name__] = second_order(
            P, x, lambda u: P.nn.functional.cross_entropy(u, y),
            lambda g: (g ** 2).sum())
    for g, w in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        close(g, w)


@pytest.mark.parametrize("case", ["conv2d", "hardswish", "maximum", "max",
                                  "soft_label_ce"])
def test_second_order_matches_reference(case):
    """``_Conv``, ``_Hardswish``, ``_MaxMin``, the reduction ``max`` and
    the soft-label cross entropy: the reference's second derivative."""
    a, b = _f(2, 3, 6, 6), _f(4, 3, 3, 3)
    z, z2 = _f(6, 5), _f(6, 5)
    soft = np.abs(_f(6, 5))
    res = {}
    for P in (paddle, ref):
        F = P.nn.functional
        if case == "conv2d":
            x, w = P.to_tensor(a, stop_gradient=False), P.to_tensor(b)
            f = (lambda u: (F.conv2d(u, w, padding=1) ** 2).sum())
        else:
            x = P.to_tensor(z, stop_gradient=False)
            y, s = P.to_tensor(z2), P.to_tensor(soft / soft.sum(1,
                                                               keepdims=True))
            f = {"hardswish": lambda u: (F.hardswish(u * 3) ** 3).sum(),
                 "maximum": lambda u: (P.maximum(u, y) ** 3).sum(),
                 "max": lambda u: (P.max(u, axis=1) ** 2).sum(),
                 "soft_label_ce": lambda u: F.cross_entropy(
                     u, s, soft_label=True)}[case]
        res[P.__name__] = second_order(P, x, f, lambda g: (g ** 3).sum())
    for g, w in zip(res["paddle_tpu_torch"], res["paddle_tpu"]):
        close(g, w)


def test_linear_functions_have_no_second_derivative():
    """``_MaxUnpool`` and the embedding are linear in their
    differentiable input: g does not depend on it, so the second
    derivative is zero in both packages (None with ``allow_unused``, or
    zeros where the reference records its grad op on the input)."""

    def zero(h):
        return h is None or not _np(h).any()

    x = _f(1, 2, 4, 4)
    for P in (paddle, ref):
        F = P.nn.functional
        t = P.to_tensor(x)
        pooled, idx = F.max_pool2d(t, 2, return_mask=True)
        p = P.to_tensor(_np(pooled), stop_gradient=False)
        (g,) = P.grad((F.max_unpool2d(p, idx, 2) * 2).sum(), p,
                      create_graph=True)
        assert zero(P.grad(g.sum(), p, allow_unused=True)[0])
        w = P.to_tensor(_f(7, 3), stop_gradient=False)
        ids = P.to_tensor(np.array([1, 4, 1]))
        (gw,) = P.grad((F.embedding(ids, w) * 3).sum(), w, create_graph=True)
        assert zero(P.grad(gw.sum(), w, allow_unused=True)[0])


def test_fused_linear_cross_entropy_second_order():
    """``FusedLinearCrossEntropy``: the reference's custom VJP
    differentiated again by JAX (its backward is jnp code) against the
    port's create_graph backward (the plain forward's VJP, recomputed)."""
    from paddle_tpu.ops import nn_ops as jn

    h, w = _f(6, 8), _f(8, 11) * 0.3
    lab = np.array([1, 3, -100, 10, 0, 2])

    def first(hh, ww):
        return jax.grad(lambda a, b: jn.fused_linear_cross_entropy(
            a, b, jnp.asarray(lab)), argnums=(0, 1))(hh, ww)

    def red(hh, ww):
        gh, gw = first(hh, ww)
        return (gh ** 2).sum() + (gw ** 3).sum()

    want = jax.jit(jax.grad(red, argnums=(0, 1)))(jnp.asarray(h),
                                                    jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = nn_ops.fused_linear_cross_entropy(th, tw, torch.tensor(lab))
    gh, gw = paddle.grad(loss, [th, tw], create_graph=True)
    got = paddle.grad((gh ** 2).sum() + (gw ** 3).sum(), [th, tw])
    for g, wv in zip(got, want):
        close(g, wv)
    wfirst = jax.jit(first)(jnp.asarray(h), jnp.asarray(w))
    close(gh, wfirst[0])
    close(gw, wfirst[1])


def _refuses(fn_port, fn_ref):
    """The port's kernel Function raises under create_graph, and so does
    the reference's kernel (interpret mode), at the same inputs."""
    with pytest.raises(RuntimeError, match="create_graph"):
        fn_port()
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        with pytest.raises(Exception):
            fn_ref()


def _jax_second(f, ins, g):
    def first(*xs):
        return jax.vjp(f, *xs)[1](g)

    out, vjp = jax.vjp(first, *ins)
    return vjp(tuple(jnp.ones_like(o) for o in out))


def test_kernel_functions_refuse_create_graph_as_reference():
    """``ShortAttention``, ``LongAttention`` and ``GroupedFFN`` (their
    plain versions on the CPU, the same Function) refuse a second
    derivative, as the reference's Pallas kernels do."""
    import importlib

    jsa = importlib.import_module(
        "paddle_tpu.ops.pallas_kernels.short_attention")
    jla = importlib.import_module(
        "paddle_tpu.ops.pallas_kernels.long_attention")
    jgg = importlib.import_module(
        "paddle_tpu.ops.pallas_kernels.grouped_gemm")
    q, k, v = (_f(1, 1, 128, 64) for _ in range(3))
    g = _f(1, 1, 128, 64)

    def port_attention(fn):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        (gq,) = paddle.grad((fn(*ts) * torch.tensor(g)).sum(), ts[0],
                            create_graph=True)
        paddle.grad(gq.sum(), ts[0])

    jq = [jnp.asarray(a) for a in (q, k, v)]
    _refuses(lambda: port_attention(lambda *t: psa.short_attention(*t)),
             lambda: _jax_second(lambda a, b, c: jsa.short_attention(
                 a, b, c, jnp.asarray(3, jnp.int32), None, 0.0, False), jq,
                 jnp.asarray(g)))
    _refuses(lambda: port_attention(lambda *t: pla.long_attention(*t)),
             lambda: _jax_second(lambda a, b, c: jla.long_attention(
                 a, b, c, None, 128, True, None), jq, jnp.asarray(g)))
    x, w1, w2 = _f(2, 8, 16), _f(2, 16, 32) * 0.1, _f(2, 32, 16) * 0.1
    b1, b2 = np.zeros((2, 1, 32), np.float32), np.zeros((2, 1, 16),
                                                       np.float32)

    def port_ffn():
        ts = [torch.tensor(a, requires_grad=True)
              for a in (x, w1, b1, w2, b2)]
        out = pgg.GroupedFFN.apply(*ts, "gelu")
        (gx,) = paddle.grad(out.sum(), ts[0], create_graph=True)
        paddle.grad(gx.sum(), ts[0])

    _refuses(port_ffn, lambda: _jax_second(
        lambda *a: jgg._fused(*a, "gelu"),
        [jnp.asarray(a) for a in (x, w1, b1, w2, b2)],
        jnp.ones((2, 8, 16), jnp.float32)))


def test_registered_op_function_and_torch_func():
    """``register_op(name, fn, fwd=, bwd=)``: dispatched under its name,
    its hand-written backward on the first order, the plain ``fn``'s
    VJP under create_graph, and ``torch.func`` transforms it
    (``setup_context``); with only ``fn`` torch's autograd
    differentiates it."""
    from paddle_tpu_torch.ops import registry

    calls = []

    def fwd(x, scale=1.0):
        return torch.sin(x) * scale, (x,)

    def bwd(saved, g, scale=1.0):
        calls.append(1)
        return torch.cos(saved[0]) * g * scale

    op = registry.register_op("test_sin_scaled",
                              lambda x, scale=1.0: torch.sin(x) * scale,
                              fwd=fwd, bwd=bwd)
    assert registry.get_op("test_sin_scaled") is op
    assert "test_sin_scaled" in registry.all_ops()
    x = torch.tensor(_f(5), requires_grad=True)
    (g,) = paddle.grad(registry.apply(op, x, scale=2.0).sum(), x,
                       create_graph=True)
    close(g, 2 * np.cos(_np(x)))
    assert not calls                        # create_graph: the plain VJP
    (h,) = paddle.grad(g.sum(), x)
    close(h, -2 * np.sin(_np(x)))
    (g1,) = paddle.grad(registry.apply(op, x, scale=2.0).sum(), x)
    assert calls and np.allclose(_np(g1), 2 * np.cos(_np(x)))
    tf = torch.func.grad(lambda t: op(t, scale=3.0).sum())(x.detach())
    close(tf, 3 * np.cos(_np(x)))
    plain = registry.register_op("test_sq", lambda t: t * t)
    (gp,) = paddle.grad(registry.apply(plain, x).sum(), x)
    close(gp, 2 * _np(x))
    out = registry.cached_apply("test_cached", lambda t, p: t ** p, x, p=3)
    close(out, _np(x) ** 3)
    gop = registry.grad_op(op, {"scale": 2.0}, 1, (0,), 1)
    assert gop.name == "grad[test_sin_scaled]"
    assert registry.grad_op(op, {"scale": 2.0}, 1, (0,), 1) is gop
    ones = torch.ones(5)
    (gg,) = paddle.grad(registry.apply(gop, ones, x).sum(), x)
    close(gg, -2 * np.sin(_np(x)))
