"""The N-d convolutions and pools of the PyTorch port
(``paddle_tpu_torch/ops/nn_ops_nd.py``, the routes of
``nn/functional.py``, ``nn/conv.py``'s ``Conv1D`` / ``Conv2DTranspose``
and ``nn/layers_nd.py``) against ``paddle_tpu``'s on the CPU, with the
same seeded numpy inputs; also ``gelu(approximate=True)``.

The reference's side of each group of cases runs as one ``jax.jit`` of
its public functions (values, and ``jax.vjp`` for gradients), computed
once per module; its max pooling with indices and its unpool
differentiate through their registered backward functions
(``_max_pool_with_index_bwd``, ``_max_unpool_bwd``), called directly.

Tolerances: values and gradients within 1e-5 of the largest magnitude
(at least 1) (fp32 on both sides, sums in other orders); output shapes
and pooling indices exactly.  The ceil-mode edges are
``tests/test_nn_nd_tail.py:350-408``'s, held against the reference here
(that file holds the reference against torch).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import nn_ops_nd as jnd
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models.convert import load_numpy_state
from paddle_tpu_torch.nn import functional as PF


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    if isinstance(a, Tensor):
        a = a._data
    return np.asarray(a)


def _close(got, want, atol=1e-5):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _j(a):
    return paddle.to_tensor(np.asarray(a))


def _jitted(fn, cases):
    """``fn(case, *arrays)`` of the reference for every case, in one
    ``jax.jit``: {name: output}."""
    names = list(cases)
    run = jax.jit(lambda arrs: {n: fn(cases[n], *a)
                                for n, a in zip(names, arrs)})
    out = run([[jnp.asarray(a) for a in cases[n]["arrays"]]
               for n in names])
    return jax.tree_util.tree_map(np.asarray, out)


def _ref_vjp(fn):
    """``fn``'s output and, under the case's cotangent, the gradients of
    its array arguments."""
    def run(case, *arrays):
        out, vjp = jax.vjp(lambda *a: fn(case, *a), *arrays)
        return out, vjp(jnp.asarray(case["g"]))
    return run


# -- convolutions ---------------------------------------------------------------

CONVS = {
    "conv1d": ("conv1d", (2, 4, 11), (6, 2, 3),
               dict(stride=2, padding=1, dilation=2, groups=2)),
    "conv2d_transpose": ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 2),
                         dict(stride=2, padding=1, output_padding=1)),
    "conv2d_transpose NHWC": ("conv2d_transpose", (2, 5, 4, 3),
                              (3, 2, 3, 4),
                              dict(stride=2, data_format="NHWC")),
    "conv1d_transpose": ("conv1d_transpose", (2, 3, 7), (3, 5, 4),
                         dict(stride=3, padding=1, output_padding=2)),
    "conv3d": ("conv3d", (1, 4, 5, 6, 5), (6, 2, 3, 2, 3),
               dict(stride=(1, 2, 1), padding=1, groups=2)),
    "conv3d_transpose": ("conv3d_transpose", (1, 3, 3, 4, 3),
                         (3, 2, 2, 3, 2),
                         dict(stride=2, padding=(0, 1, 0),
                              output_padding=1)),
}


def _conv(case, x, w, b):
    return getattr(JF, case["fn"])(Tensor(x), Tensor(w), Tensor(b),
                                   **case["kw"])._data


@pytest.fixture(scope="module")
def conv_ref():
    cases = {}
    for i, (name, (fn, xs, ws, kw)) in enumerate(CONVS.items()):
        rng = np.random.RandomState(i)
        if kw.get("data_format") == "NHWC":
            cout = ws[-1]                       # HWIO
        else:
            cout = ws[1] if "transpose" in name else ws[0]
        arrays = [rng.randn(*xs).astype(np.float32),
                  (rng.randn(*ws) * 0.3).astype(np.float32),
                  rng.randn(cout).astype(np.float32)]
        shape = jax.eval_shape(lambda *a: _conv(dict(fn=fn, kw=kw), *a),
                               *arrays).shape
        cases[name] = dict(fn=fn, kw=kw, arrays=arrays,
                           g=rng.randn(*shape).astype(np.float32))
    return cases, _jitted(_ref_vjp(_conv), cases)


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_values_and_grads(name, conv_ref):
    cases, ref = conv_ref
    case = cases[name]
    want, grads = ref[name]
    ts = [_t(a, True) for a in case["arrays"]]
    out = getattr(PF, case["fn"])(*ts, **case["kw"])
    out.backward(_t(case["g"]))
    _close(out, want)
    for t, g in zip(ts, grads):
        _close(t.grad, g)


LAYERS = {
    "Conv1D": (dict(in_channels=4, out_channels=6, kernel_size=3,
                    padding=1, groups=2), (2, 4, 9)),
    "Conv2DTranspose": (dict(in_channels=4, out_channels=6, kernel_size=3,
                             stride=2, padding=1), (2, 4, 5, 5)),
    "Conv3D": (dict(in_channels=2, out_channels=4, kernel_size=(2, 3, 3),
                    stride=2), (1, 2, 5, 6, 6)),
    "Conv1DTranspose": (dict(in_channels=3, out_channels=4, kernel_size=3,
                             stride=2, output_padding=1), (2, 3, 6)),
    "Conv3DTranspose": (dict(in_channels=2, out_channels=3, kernel_size=2,
                             stride=2, bias_attr=False), (1, 2, 3, 3, 2)),
}


@pytest.fixture(scope="module")
def layer_ref():
    """The reference's layers (constant-initialised, then given seeded
    weights), their numpy states and their forwards in one jit."""
    const = paddle.ParamAttr(initializer=jnn.initializer.Constant(0.0))
    layers, states, xs = {}, {}, {}
    for i, (name, (kw, shape)) in enumerate(LAYERS.items()):
        rng = np.random.RandomState(10 + i)
        kw = dict(kw, weight_attr=const)
        if kw.get("bias_attr") is not False:
            kw["bias_attr"] = const
        layer = getattr(jnn, name)(**kw)
        for p in layer.parameters():
            p._data = jnp.asarray(rng.randn(*p.shape).astype(np.float32)
                                  * 0.3)
        layers[name] = layer
        states[name] = {k: _np(v) for k, v in layer.state_dict().items()}
        xs[name] = rng.randn(*shape).astype(np.float32)
    out = jax.jit(lambda a: {n: layers[n](Tensor(a[n]))._data
                             for n in LAYERS})(
        {n: jnp.asarray(x) for n, x in xs.items()})
    return states, xs, out


@pytest.mark.parametrize("name", list(LAYERS))
def test_conv_layers(name, layer_ref):
    """Parameter names and shapes are the reference's (the port's layer
    loads the reference layer's numpy state with no mapping) and the
    forwards agree on those weights; ``Conv2DTranspose`` ignores
    ``output_size`` as the reference does."""
    states, xs, out = layer_ref
    kw, _ = LAYERS[name]
    pl = getattr(pnn, name)(**kw, device="cpu")
    assert {k: v.shape for k, v in states[name].items()} == {
        k: tuple(v.shape) for k, v in pl.state_dict().items()}
    load_numpy_state(pl, states[name])
    _close(pl(_t(xs[name])), out[name])
    if name == "Conv2DTranspose":
        _close(pl(_t(xs[name]), output_size=(99, 99)), out[name])


# -- pools: ceil mode, divisor, padding; Lp, adaptive, fractional ----------------

R = np.random.RandomState(0)
X1 = R.randn(2, 3, 5).astype(np.float32)
X3 = R.randn(1, 2, 5, 5, 5).astype(np.float32)
XP = R.randn(1, 1, 5).astype(np.float32)
ONES3 = np.ones((1, 1, 4, 4, 4), np.float32)
ONES2 = np.ones((1, 1, 5, 5), np.float32)
NHWC = R.randn(2, 5, 6, 3).astype(np.float32)
POOLS = {
    "max1d ceil": ("max_pool1d", X1, (2, 2), dict(ceil_mode=True)),
    "avg1d ceil": ("avg_pool1d", X1, (2, 2), dict(ceil_mode=True)),
    "max3d ceil": ("max_pool3d", X3, (2, 2), dict(ceil_mode=True)),
    "avg3d ceil": ("avg_pool3d", X3, (2, 2), dict(ceil_mode=True)),
    "avg3d divisor": ("avg_pool3d", X3, (2, 2), dict(divisor_override=1)),
    "avg3d pad divisor": ("avg_pool3d", ONES3, (2, 2),
                          dict(padding=1, divisor_override=8)),
    "avg1d pad ceil": ("avg_pool1d", XP, (2, 2),
                       dict(padding=1, ceil_mode=True)),
    "avg3d pad ceil inclusive": ("avg_pool3d", ONES3, (2, 2),
                                 dict(padding=1, ceil_mode=True,
                                      exclusive=False)),
    "max1d window in padding dropped": ("max_pool1d", XP, (2, 2),
                                        dict(padding=1, ceil_mode=True)),
    "avg2d ceil divisor": ("avg_pool2d", ONES2, (2, 2),
                           dict(ceil_mode=True, divisor_override=3)),
    "avg2d ceil pad": ("avg_pool2d", R.randn(1, 2, 6, 7).astype(np.float32),
                       (3, 2), dict(padding=1, ceil_mode=True)),
    "max2d ceil ignored": ("max_pool2d", R.randn(1, 1, 5, 5).astype(
        np.float32), (2, 2), dict(ceil_mode=True)),
    "max1d pad past half": ("max_pool1d", X1, (2, 1), dict(padding=1)),
    "avg2d ceil NHWC": ("avg_pool2d", NHWC, (2, 2),
                        dict(ceil_mode=True, data_format="NHWC")),
    "lp1d p2": ("lp_pool1d", X1, (2, 3, 2), dict(padding=1)),
    "lp1d p3": ("lp_pool1d", X1, (3, 2, 1), dict()),
    "lp2d inf": ("lp_pool2d", ONES2 * X3[0, :1, 0, :, :1],
                 (float("inf"), (2, 3), 2), dict()),
    "lp2d p2": ("lp_pool2d", R.randn(1, 2, 7, 6).astype(np.float32),
                (2, (2, 3), 2), dict()),
    "adaptive avg1d": ("adaptive_avg_pool1d", R.randn(2, 3, 10).astype(
        np.float32), (4,), dict()),
    "adaptive avg3d": ("adaptive_avg_pool3d", R.randn(1, 2, 5, 7, 6).astype(
        np.float32), ((2, 3, 4),), dict()),
    "adaptive max1d": ("adaptive_max_pool1d", R.randn(2, 3, 10).astype(
        np.float32), (3,), dict()),
    "adaptive max2d": ("adaptive_max_pool2d", R.randn(1, 2, 7, 9).astype(
        np.float32), ((3, 4),), dict()),
    "adaptive max3d": ("adaptive_max_pool3d", R.randn(1, 2, 5, 6, 7).astype(
        np.float32), (3,), dict()),
    "fractional 2d": ("fractional_max_pool2d", R.randn(2, 3, 11, 9).astype(
        np.float32), ((4, 5),), dict(random_u=0.37)),
    "fractional 3d": ("fractional_max_pool3d", R.randn(1, 2, 7, 8, 9).astype(
        np.float32), ((3, 4, 5),), dict(random_u=0.37)),
    "fractional 2d u from generator": (
        "fractional_max_pool2d", R.randn(1, 2, 9, 9).astype(np.float32),
        ((4, 4),), dict(random_u=float(torch.rand(
            (), generator=torch.Generator().manual_seed(0))))),
}


@pytest.fixture(scope="module")
def pool_ref():
    cases = {n: dict(fn=fn, args=args, kw=kw, arrays=[x])
             for n, (fn, x, args, kw) in POOLS.items()}
    return _jitted(lambda c, x: getattr(JF, c["fn"])(
        Tensor(x), *c["args"], **c["kw"])._data, cases)


@pytest.mark.parametrize("case", list(POOLS))
def test_pools(case, pool_ref):
    """The reference's ``_ceil_extension`` (a window starting wholly in
    the right padding is dropped), the divisor rules, ``max_pool2d``'s
    ``ceil_mode`` (which the reference ignores), the Lp pools (whose
    ``ceil_mode`` it ignores too), the adaptive pools and the fractional
    ones with a given ``u``."""
    fn, x, args, kw = POOLS[case]
    _close(getattr(PF, fn)(_t(x), *args, **kw), pool_ref[case])


def test_pool_refusals_and_generator_draw():
    """Where the reference raises, the port raises; ``u`` drawn from the
    generator when none is given (the ``u from generator`` case above
    holds that draw's regions against the reference)."""
    x = _t(POOLS["fractional 2d u from generator"][1])
    with pytest.raises(NotImplementedError):
        PF.adaptive_max_pool2d(x, 3, return_mask=True)
    with pytest.raises(NotImplementedError):
        PF.max_pool2d(x, 2, 2, ceil_mode=True, return_mask=True)
    with pytest.raises(ValueError, match="generator"):
        PF.fractional_max_pool2d(x, (4, 4))
    want = PF.fractional_max_pool2d(
        x, (4, 4), random_u=POOLS["fractional 2d u from generator"][3][
            "random_u"])
    np.testing.assert_array_equal(
        pnn.FractionalMaxPool2D((4, 4))(x).numpy(), want.numpy())
    np.testing.assert_array_equal(
        PF.fractional_max_pool2d(
            x, (4, 4), generator=torch.Generator().manual_seed(0)).numpy(),
        want.numpy())


LAYER_POOLS = {f"{kind}{nd}D {tag}": (f"{kind}{nd}D", nd, kw)
               for nd in (1, 3)
               for kind, tag, kw in (
                   ("MaxPool", "ceil", dict(ceil_mode=True)),
                   ("MaxPool", "mask", dict(return_mask=True)),
                   ("AvgPool", "inclusive", dict(
                       padding=1, exclusive=False, ceil_mode=True)))}


@pytest.fixture(scope="module")
def layer_pool_ref():
    cases = {n: dict(cls=cls, kw=kw, arrays=[np.random.RandomState(nd)
                                             .randn(*((2, 3, 9) if nd == 1
                                                      else (1, 2, 5, 6, 5)))
                                             .astype(np.float32)])
             for n, (cls, nd, kw) in LAYER_POOLS.items()}

    def run(c, x):
        out = getattr(jnn, c["cls"])(3, 2, **c["kw"])(Tensor(x))
        return tuple(o._data for o in out) if isinstance(out, tuple) \
            else out._data
    return cases, _jitted(run, cases)


@pytest.mark.parametrize("name", list(LAYER_POOLS))
def test_pool_layers(name, layer_pool_ref):
    """``MaxPool1D`` / ``3D`` pass ``return_mask`` and ``AvgPool1D`` /
    ``3D`` ``exclusive``, but neither ``ceil_mode``, as the reference's
    layers."""
    cases, ref = layer_pool_ref
    c = cases[name]
    got = getattr(pnn, c["cls"])(3, 2, **c["kw"])(_t(c["arrays"][0]))
    if isinstance(got, tuple):
        _close(got[0], ref[name][0])
        np.testing.assert_array_equal(got[1].numpy(), ref[name][1])
    else:
        _close(got, ref[name])


# -- indices and unpool ---------------------------------------------------------

INDEX = {"1d": ((2, 3, 9), 3, 2, 1), "2d": ((2, 2, 7, 8), 2, 2, 0),
         "2d overlapping": ((1, 2, 6, 7), 3, 2, 1),
         "3d": ((1, 2, 4, 6, 5), 2, 2, 0),
         "2d padding past half": ((1, 1, 5, 6), 2, 2, 2)}


@pytest.fixture(scope="module")
def index_ref():
    """Per case: the input (on a coarse grid, so maxima tie), the
    reference's values and indices, the gradient of x by its registered
    backward, the unpool of the values and its gradient by
    ``_max_unpool_bwd``; one jit."""
    cases = {}
    for i, (name, (shape, k, s, p)) in enumerate(INDEX.items()):
        rng = np.random.RandomState(20 + i)
        x = rng.randint(0, 5, shape).astype(np.float32)
        nd = len(shape) - 2
        pooled = [(n - k + 2 * p) // s + 1 for n in shape[2:]]
        out_sp = tuple((n - 1) * s - 2 * p + k for n in pooled)
        cases[name] = dict(nd=nd, k=k, s=s, p=p, out_sp=out_sp, arrays=[
            x, rng.randn(*shape[:2], *pooled).astype(np.float32),
            rng.randn(*shape[:2], *out_sp).astype(np.float32)])

    def run(c, x, g, gu):
        nd, k, s, p = c["nd"], c["k"], c["s"], c["p"]
        v, i = getattr(JF, f"max_pool{nd}d")(Tensor(x), k, s, p,
                                             return_mask=True)
        v, i = v._data, i._data
        (dx,) = jnd._max_pool_with_index_bwd((i, jnp.zeros_like(x)), g)
        u = getattr(JF, f"max_unpool{nd}d")(Tensor(v), Tensor(i), k, s,
                                            p)._data
        dv, _ = jnd._max_unpool_bwd((i,), gu)
        return v, i, dx, u, dv
    return cases, _jitted(run, cases)


@pytest.mark.parametrize("case", list(INDEX))
def test_max_pool_with_index_and_unpool(case, index_ref):
    """Values, int64 flat indices (the first maximum wins ties), the
    gradient to the argmax, and the unpool back (its layer: an index
    past the output is dropped) with its gradient."""
    cases, ref = index_ref
    c = cases[case]
    v, i, dx, u, dv = ref[case]
    nd, k, s, p = c["nd"], c["k"], c["s"], c["p"]
    x, g, gu = c["arrays"]
    xt = _t(x, True)
    vt, it = getattr(PF, f"max_pool{nd}d")(xt, k, s, p, return_mask=True)
    vt.backward(_t(g))
    assert it.dtype == torch.int64
    _close(vt, v)
    np.testing.assert_array_equal(it.numpy(), i)
    _close(xt.grad, dx)
    vt2 = _t(v, True)
    ut = getattr(pnn, f"MaxUnPool{nd}D")(k, s, p)(vt2, it)
    ut.backward(_t(gu))
    _close(ut, u)
    _close(vt2.grad, dv)


# -- gelu -----------------------------------------------------------------------

def test_gelu_tanh_form():
    rng = np.random.RandomState(9)
    x = (rng.randn(4, 33) * 3).astype(np.float32)
    g = rng.randn(4, 33).astype(np.float32)
    ref = _jitted(_ref_vjp(lambda c, a: JF.gelu(
        Tensor(a), approximate=True)._data), {"gelu": dict(arrays=[x], g=g)})
    want, grad = ref["gelu"]
    xt = _t(x, True)
    out = pnn.GELU(approximate=True)(xt)
    out.backward(_t(g))
    _close(out, want)
    _close(xt.grad, grad[0])


def test_amp_names_of_the_new_ops():
    """Under ``auto_cast`` O1 the reference casts by op name: ``conv1d``
    and ``conv2d_transpose`` are on the white list (bf16), ``conv3d``
    and the pools on neither list (their inputs as they are); the port's
    ops carry the same names and come out in the same dtypes."""
    from paddle_tpu_torch import amp as pamp

    x1 = np.random.RandomState(10).randn(1, 4, 9).astype(np.float32)
    x3 = np.random.RandomState(11).randn(1, 2, 4, 4, 4).astype(np.float32)
    w1 = np.ones((2, 4, 3), np.float32)
    w3 = np.ones((2, 2, 1, 1, 1), np.float32)
    cases = (("conv1d", x1, w1), ("conv3d", x3, w3))
    for name, x, w in cases:
        with paddle.amp.auto_cast(level="O1"):
            want = getattr(JF, name)(_j(x), _j(w))
        with pamp.auto_cast(level="O1"):
            got = getattr(PF, name)(_t(x), _t(w))
        assert str(got.dtype).split(".")[-1] == str(
            want.dtype).split(".")[-1], name
    with pamp.auto_cast(level="O1"):
        assert PF.conv2d_transpose(
            _t(x3[:, :, 0]), _t(w3[:, :, 0])).dtype == torch.bfloat16
        assert PF.max_pool3d(_t(x3), 2, 2, ceil_mode=True).dtype == \
            torch.float32
