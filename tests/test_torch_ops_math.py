"""The port's elementwise math, activation and in-place op families
(``paddle_tpu_torch/ops/math.py``, ``activation.py``, ``inplace.py`` and
the names ``ops/__init__.py`` defines) against ``paddle_tpu``'s on the
CPU, on the same seeded numpy inputs.

The reference's side of each family runs as one ``jax.jit`` over its
public functions (each argument wrapped in ``paddle_tpu``'s ``Tensor``,
``._data`` read back), computed once per module; gradients come from
``jax.vjp`` of the same functions.  ``maximum`` / ``minimum`` register a
hand-written backward that decides ties, so they are held on ties
against the reference's eager tape.

Tolerances: result dtypes, shapes, integer and bool values exactly;
float values within 2e-6 (fp32), 1e-12 (fp64) or 1.6e-2 (bf16) of the
largest reference magnitude (at least 1), NaN where the reference has
NaN; gradients within 1e-5 of the largest magnitude (fp32 on both
sides).  In-place ops: the value and the dtype of the same object after
the op.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ref
from paddle_tpu.core.tensor import Tensor as RT
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import dtype as pdt

RNG = np.random.default_rng(0)
TOL = {"float32": 2e-6, "float64": 1e-12, "bfloat16": 1.6e-2,
       "float16": 2e-3}


@pytest.fixture(autouse=True)
def _cpu():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def _name(dt):
    return str(dt).replace("torch.", "")


def check(got, want, what=""):
    """``got`` (port) against ``want`` (reference array): dtype, shape,
    values at the stated tolerance."""
    want = np.asarray(want)
    assert _name(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    g = _np(got)
    assert g.shape == want.shape, (what, g.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(g, want, err_msg=what)
        return
    w = want.astype(np.float64)
    g = g.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    ok = ~np.isnan(w)
    scale = max(1.0, float(np.abs(w[ok & np.isfinite(w)]).max(initial=0)))
    np.testing.assert_allclose(g[ok], w[ok], rtol=0,
                               atol=TOL[str(want.dtype)] * scale,
                               err_msg=what)


def _arr(shape, dtype, lo=-2.0, hi=2.0):
    if dtype == "bool":
        return RNG.random(shape) > 0.5
    if dtype in ("int32", "int64", "int8", "uint8", "int16"):
        lo_i = 0 if dtype == "uint8" else int(lo)
        return RNG.integers(lo_i, int(hi) + 4, shape).astype(dtype)
    a = RNG.uniform(lo, hi, shape)
    if dtype == "bfloat16":
        import ml_dtypes

        return a.astype(np.float32).astype(ml_dtypes.bfloat16)
    return a.astype(dtype)


def _port(a):
    """A numpy array or numpy scalar as the port's tensor; Python
    scalars pass as they are."""
    if isinstance(a, np.ndarray):
        return paddle.to_tensor(a, dtype=str(a.dtype) if a.dtype.name
                                != "float64" else "float64")
    return a


def _ref(a):
    return RT(a) if isinstance(a, (jax.Array, jax.core.Tracer)) else a


def ref_jit(cases):
    """{name: reference output arrays} for ``cases`` = {name: (fn, args)}:
    every case in one ``jax.jit``; numpy arrays are its arguments, other
    arguments constants."""
    names = list(cases)
    arrs = {n: [a for a in cases[n][1] if isinstance(a, np.ndarray)]
            for n in names}

    def run(arrays):
        out = {}
        for n in names:
            fn, args = cases[n]
            it = iter(arrays[n])
            call = [_ref(next(it)) if isinstance(a, np.ndarray) else a
                    for a in args]
            res = fn(*call)
            out[n] = jax.tree_util.tree_map(
                lambda t: t._data, res,
                is_leaf=lambda t: isinstance(t, RT))
        return out

    got = jax.jit(run)({n: [jnp.asarray(a) for a in arrs[n]]
                        for n in names})
    return jax.tree_util.tree_map(np.asarray, got)


# -- binary ops: values and result dtypes -------------------------------------------

FLOAT_BIN = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
             "remainder", "floor_divide", "fmax", "fmin", "logaddexp",
             "atan2", "equal", "not_equal", "greater_than", "greater_equal",
             "less_than", "less_equal", "mod", "floor_mod"]
INT_BIN = ["add", "subtract", "multiply", "maximum", "minimum", "remainder",
           "floor_divide", "gcd", "lcm", "bitwise_and", "bitwise_or",
           "bitwise_xor", "equal", "less_than", "divide", "pow"]
BOOL_BIN = ["logical_and", "logical_or", "logical_xor", "bitwise_and",
            "bitwise_or", "bitwise_xor", "equal", "not_equal"]


def _bin_operands():
    """(label, x, y, op names): mixed dtypes, Python and numpy scalars,
    broadcasting."""
    f32 = _arr([3, 4], "float32")
    return [
        ("f32_f32", f32, _arr([3, 4], "float32", 0.5, 2.0), FLOAT_BIN),
        ("f32_bcast", _arr([3, 1], "float32"), _arr([4], "float32", 0.5),
         FLOAT_BIN),
        ("bf16_f32", _arr([3, 4], "bfloat16"), _arr([3, 4], "float32", 0.5),
         ["add", "multiply", "divide", "maximum", "less_than"]),
        ("bf16_bf16", _arr([3, 4], "bfloat16"),
         _arr([3, 4], "bfloat16", 0.5),
         ["add", "subtract", "multiply", "divide", "maximum"]),
        ("f64_f32", _arr([4], "float64"), _arr([4], "float32", 0.5),
         ["add", "multiply", "divide"]),
        ("f32_pyfloat", f32, 1.5, ["add", "multiply", "divide", "pow",
                                   "subtract", "maximum", "greater_than"]),
        ("f32_pyint", f32, 3, ["add", "multiply", "divide", "pow",
                               "remainder"]),
        ("i32_pyfloat", _arr([5], "int32"), 2.5,
         ["add", "multiply", "divide", "subtract", "less_than"]),
        ("i64_pyfloat", _arr([5], "int64"), 2.5, ["add", "multiply"]),
        ("i32_pyint", _arr([5], "int32"), 3, ["add", "multiply",
                                              "floor_divide", "remainder",
                                              "divide", "pow"]),
        ("i32_f32", _arr([5], "int32"), _arr([5], "float32", 0.5),
         ["add", "multiply", "divide", "maximum"]),
        ("i64_f32", _arr([5], "int64"), _arr([5], "float32", 0.5),
         ["add", "subtract"]),
        ("i32_i64", _arr([5], "int32", 1, 5), _arr([5], "int64", 1, 5),
         INT_BIN),
        ("u8_i8", _arr([5], "uint8"), _arr([5], "int8"), ["add",
                                                          "multiply"]),
        ("i32_npf32", _arr([5], "int32"), np.float32(1.5), ["add",
                                                            "multiply"]),
        ("f32_npf64", f32, np.float64(1.5), ["add", "multiply"]),
        ("i32_npi64", _arr([5], "int32"), np.int64(2), ["add", "multiply"]),
        ("f16_npi64", _arr([5], "float16"), np.int64(2), ["add"]),
        ("bool_pyint", _arr([5], "bool"), 2, ["add", "multiply"]),
        ("bool_pyfloat", _arr([5], "bool"), 2.5, ["add"]),
        ("bool_bool", _arr([5], "bool"), _arr([5], "bool"), BOOL_BIN),
        ("i32_i32", _arr([3, 4], "int32", 1, 6), _arr([4], "int32", 1, 6),
         INT_BIN + ["left_shift", "right_shift", "not_equal"]),
        ("pyfloat_i32", 2.5, _arr([5], "int32"), ["add", "subtract"]),
    ]


BIN_CASES = {f"{op}[{label}]": (op, x, y)
             for label, x, y, ops in _bin_operands() for op in ops}


@pytest.fixture(scope="module")
def bin_ref():
    cases = {n: (getattr(ref, op), (x, y))
             for n, (op, x, y) in BIN_CASES.items()}
    return ref_jit(cases)


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_binary(case, bin_ref):
    op, x, y = BIN_CASES[case]
    got = getattr(paddle, op)(_port(x), _port(y))
    check(got, bin_ref[case], case)


# -- unary ops ------------------------------------------------------------------------

UNARY_F = ["exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
           "square", "abs", "neg", "sign", "floor", "ceil", "trunc", "frac",
           "reciprocal", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
           "cosh", "asinh", "acosh", "atanh", "erf", "erfinv", "lgamma",
           "digamma", "i0", "isnan", "isinf", "isfinite", "logical_not",
           "tanh", "sigmoid", "relu", "relu6", "silu", "gelu", "leaky_relu",
           "elu", "selu", "celu", "softplus", "softsign", "hardtanh",
           "hardsigmoid", "hardswish", "swish", "mish", "tanhshrink",
           "softshrink", "hardshrink", "thresholded_relu", "log_sigmoid",
           "stanh", "nan_to_num", "rint", "negative"]
UNARY_I = ["abs", "neg", "sign", "floor", "square", "exp", "sqrt",
           "bitwise_not", "isnan", "logical_not", "reciprocal", "frac",
           "ceil", "sin", "nan_to_num"]
# Domains where the op is finite.
_POS = {"log", "log2", "log10", "sqrt", "rsqrt", "lgamma", "digamma",
        "acosh", "reciprocal"}
_UNIT = {"asin", "acos", "atanh", "erfinv"}


def _unary_input(op, dtype):
    if op in _UNIT:
        return _arr([3, 4], dtype, -0.9, 0.9)
    if op == "acosh":
        return _arr([3, 4], dtype, 1.1, 3.0)
    if op in _POS:
        return _arr([3, 4], dtype, 0.2, 3.0)
    if op == "log1p":
        return _arr([3, 4], dtype, -0.5, 3.0)
    return _arr([3, 4], dtype, -3.0, 3.0)


UNARY_CASES = {}
for _op in UNARY_F:
    for _dt in ("float32", "bfloat16"):
        UNARY_CASES[f"{_op}[{_dt}]"] = (_op, _unary_input(_op, _dt))
for _op in UNARY_I:
    for _dt in ("int32", "int64"):
        UNARY_CASES[f"{_op}[{_dt}]"] = (_op, _arr([5], _dt, 1, 6))
UNARY_CASES["abs[bool]"] = ("abs", _arr([5], "bool"))
UNARY_CASES["square[bool]"] = ("square", _arr([5], "bool"))
UNARY_CASES["floor[bool]"] = ("floor", _arr([5], "bool"))
UNARY_CASES["exp[bool]"] = ("exp", _arr([5], "bool"))
UNARY_CASES["nan_to_num[nan]"] = (
    "nan_to_num", np.array([np.nan, np.inf, -np.inf, 1.0], np.float32))
UNARY_CASES["isnan[nan]"] = (
    "isnan", np.array([np.nan, np.inf, -np.inf, 1.0], np.float32))
UNARY_CASES["isinf[nan]"] = (
    "isinf", np.array([np.nan, np.inf, -np.inf, 1.0], np.float32))


@pytest.fixture(scope="module")
def unary_ref():
    return ref_jit({n: (getattr(ref, op), (x,))
                    for n, (op, x) in UNARY_CASES.items()})


@pytest.mark.parametrize("case", sorted(UNARY_CASES))
def test_unary(case, unary_ref):
    op, x = UNARY_CASES[case]
    check(getattr(paddle, op)(_port(x)), unary_ref[case], case)


# -- ops with attributes -------------------------------------------------------

def _attr_cases():
    x = _arr([3, 4], "float32")
    i = _arr([5], "int32")
    w = _arr([3, 4], "float32", 0.0, 1.0)
    return {
        "clip[f32]": ("clip", (x, -0.5, 0.7), {}),
        "clip[min_only]": ("clip", (x, -0.5), {}),
        "clip[i32]": ("clip", (i, 1, 4), {}),
        "scale[f32]": ("scale", (x, 2.0, 0.5), {}),
        "scale[before]": ("scale", (x, 2.0, 0.5, False), {}),
        "scale[i32]": ("scale", (i, 2.0, 1.0), {}),
        "scale[bf16]": ("scale", (_arr([4], "bfloat16"), 3.0, 1.0), {}),
        "lerp[f32]": ("lerp", (x, _arr([3, 4], "float32"), w), {}),
        "lerp[scalar_w]": ("lerp", (x, _arr([4], "float32"), 0.3), {}),
        "stanh[f32]": ("stanh", (x, 0.5, 2.0), {}),
        "leaky_relu[slope]": ("leaky_relu", (x, 0.2), {}),
        "elu[alpha]": ("elu", (x, 0.5), {}),
        "celu[alpha]": ("celu", (x, 2.0), {}),
        "softplus[beta]": ("softplus", (x * 8, 2.0, 5.0), {}),
        "hardtanh[bounds]": ("hardtanh", (x, -0.3, 0.4), {}),
        "softshrink[t]": ("softshrink", (x, 0.7), {}),
        "hardshrink[t]": ("hardshrink", (x, 0.7), {}),
        "thresholded_relu[t]": ("thresholded_relu", (x, 0.2, -1.0), {}),
        "gelu[tanh]": ("gelu", (x, True), {}),
        "prelu[channel]": ("prelu", (_arr([2, 3, 4], "float32"),
                                     _arr([3], "float32", 0.0, 0.5)), {}),
        "prelu[scalar]": ("prelu", (x, _arr([1], "float32", 0.0, 0.5)), {}),
        "glu[axis0]": ("glu", (_arr([4, 3], "float32"), 0), {}),
        "swiglu[one]": ("swiglu", (_arr([3, 8], "float32"),), {}),
        "swiglu[two]": ("swiglu", (x, _arr([3, 4], "float32")), {}),
        "softmax[axis0]": ("softmax", (x, 0), {}),
        "softmax[dtype]": ("softmax", (_arr([3, 4], "bfloat16"), -1,
                                       "float32"), {}),
        "log_softmax[f32]": ("log_softmax", (x,), {}),
        "nan_to_num[args]": ("nan_to_num", (
            np.array([np.nan, np.inf, -np.inf, 1.0], np.float32), 1.0, 9.0,
            -9.0), {}),
        "isclose[f32]": ("isclose", (x, x + np.float32(1e-6)), {}),
        "isclose[mixed]": ("isclose", (x, x.astype(np.float64) + 1e-3,
                                       1e-3, 1e-3), {}),
    }


ATTR_CASES = _attr_cases()


@pytest.fixture(scope="module")
def attr_ref():
    return ref_jit({n: (getattr(ref, op), args)
                    for n, (op, args, kw) in ATTR_CASES.items()})


@pytest.mark.parametrize("case", sorted(ATTR_CASES))
def test_attr_ops(case, attr_ref):
    op, args, kw = ATTR_CASES[case]
    got = getattr(paddle, op)(*[_port(a) for a in args], **kw)
    check(got, attr_ref[case], case)


@pytest.mark.parametrize("fn", ["allclose", "equal_all"])
def test_host_predicates(fn):
    """``allclose`` and ``equal_all`` (host predicates in the reference:
    0-d bool tensors)."""
    x = _arr([3, 4], "float32")
    pairs = [(x, x), (x, x + np.float32(1e-3)), (x, x[:2]),
             (x.astype(np.int32), x.astype(np.int32))]
    for a, b in pairs:
        if fn == "allclose" and a.shape != b.shape:
            continue
        want = getattr(ref, fn)(ref.to_tensor(a), ref.to_tensor(b))
        got = getattr(paddle, fn)(_port(a), _port(b))
        check(got, np.asarray(want._data), fn)


# -- gradients ----------------------------------------------------------------------

GRAD_OPS = {
    "add": 2, "subtract": 2, "multiply": 2, "divide": 2, "pow": 2,
    "maximum": 2, "minimum": 2, "atan2": 2, "logaddexp": 2, "lerp": 3,
    "exp": 1, "expm1": 1, "log": 1, "log2": 1, "log10": 1, "log1p": 1,
    "sqrt": 1, "rsqrt": 1, "square": 1, "abs": 1, "neg": 1, "frac": 1,
    "reciprocal": 1, "sin": 1, "cos": 1, "tan": 1, "asin": 1, "acos": 1,
    "atan": 1, "sinh": 1, "cosh": 1, "asinh": 1, "atanh": 1, "erf": 1,
    "erfinv": 1, "lgamma": 1, "digamma": 1, "tanh": 1, "sigmoid": 1,
    "relu": 1, "silu": 1, "gelu": 1, "elu": 1, "selu": 1, "celu": 1,
    "softplus": 1, "softsign": 1, "hardswish": 1, "mish": 1,
    "tanhshrink": 1, "log_sigmoid": 1, "leaky_relu": 1, "softmax": 1,
    "log_softmax": 1, "clip": 1, "scale": 1, "stanh": 1, "i0": 1,
    "acosh": 1, "relu6": 1, "hardtanh": 1, "hardsigmoid": 1,
    "softshrink": 1, "hardshrink": 1, "thresholded_relu": 1, "swish": 1,
    "prelu": 2, "glu": 1, "swiglu": 2, "fmax": 2, "fmin": 2,
}


def _grad_inputs(op, n):
    if op == "acosh":
        return [_arr([3, 4], "float32", 1.2, 3.0)]
    if op in _UNIT:
        return [_arr([3, 4], "float32", -0.8, 0.8) for _ in range(n)]
    if op in _POS or op in ("pow", "log1p"):
        return [_arr([3, 4], "float32", 0.3, 2.0) for _ in range(n)]
    shapes = [[3, 4], [4], [3, 1]][:n]
    return [_arr(s, "float32", -2.0, 2.0) for s in shapes]


GRAD_CASES = {op: _grad_inputs(op, n) for op, n in GRAD_OPS.items()}


def _cotangent(shape):
    return np.linspace(-1, 1, int(np.prod(shape))).reshape(shape).astype(
        np.float32)


def _grad_fn(op):
    return {"clip": lambda x: (x, -0.5, 0.7),
            "scale": lambda x: (x, 2.0, 0.5)}.get(op, lambda *a: a)


@pytest.fixture(scope="module")
def grad_ref():
    names = list(GRAD_CASES)

    def run(arrays):
        out = {}
        for n in names:
            xs = arrays[n]
            fn = getattr(ref, n)
            wrap = _grad_fn(n)

            def f(*a, fn=fn, wrap=wrap):
                return fn(*wrap(*[RT(v) for v in a]))._data

            val, vjp = jax.vjp(f, *xs)
            out[n] = (val, vjp(jnp.asarray(_cotangent(val.shape))))
        return out

    got = jax.jit(run)({n: [jnp.asarray(v) for v in xs]
                        for n, xs in GRAD_CASES.items()})
    return jax.tree_util.tree_map(np.asarray, got)


@pytest.mark.parametrize("op", sorted(GRAD_CASES))
def test_gradients(op, grad_ref):
    """Gradients through torch's autograd against ``jax.vjp`` of the
    reference, broadcasting operands reduced over the broadcast axes."""
    xs = GRAD_CASES[op]
    ts = [torch.from_numpy(x.copy()).requires_grad_(True) for x in xs]
    out = getattr(paddle, op)(*_grad_fn(op)(*ts))
    out.backward(torch.from_numpy(_cotangent(tuple(out.shape))))
    want_val, want_grads = grad_ref[op]
    check(out, want_val, op)
    for t, w in zip(ts, want_grads):
        check(t.grad, w, f"d{op}")


@pytest.mark.parametrize("op", ["maximum", "minimum"])
def test_tie_gradients_eager_tape(op):
    """On ties the reference's hand-written backward sends the whole
    gradient to x (its eager tape; ``jax.vjp`` of ``jnp.maximum`` would
    split it)."""
    x = np.array([1.0, 2.0, 3.0, 2.0], np.float32)
    y = np.array([1.0, 1.0, 3.0, 5.0], np.float32)
    rx = ref.to_tensor(x, stop_gradient=False)
    ry = ref.to_tensor(y, stop_gradient=False)
    ref.sum(getattr(ref, op)(rx, ry) * ref.to_tensor(
        np.arange(1, 5, dtype=np.float32))).backward()
    px = torch.from_numpy(x).requires_grad_(True)
    py = torch.from_numpy(y).requires_grad_(True)
    (getattr(paddle, op)(px, py) * torch.arange(1, 5).float()).sum().backward()
    check(px.grad, np.asarray(rx.grad._data), op)
    check(py.grad, np.asarray(ry.grad._data), op)


#: inputs on the boundaries of the piecewise activations: 0, +-1, +-3, 6
#: and the clip bounds, where a hand-written backward (``relu6``,
#: ``hardswish``) or ``jnp.clip``'s split tie (``hardtanh``,
#: ``hardsigmoid``) differ from a plain autograd of clamp
BOUNDARY_X = np.array([-6, -3, -1, -0.5, 0, 0.5, 0.7, 1, 3, 6, 7],
                      np.float32)
BOUNDARY_OPS = {"relu": (), "relu6": (), "hardswish": (), "hardtanh": (),
                "hardsigmoid": (), "clip": (-0.5, 0.7), "leaky_relu": (),
                "elu": (), "softshrink": (), "hardshrink": (),
                "thresholded_relu": (), "abs": ()}


@pytest.mark.parametrize("op", sorted(BOUNDARY_OPS))
def test_boundary_gradients_eager_tape(op):
    """Gradients at the boundaries against the reference's eager tape
    (its registered backward where it has one); the ``nn.functional``
    name, where there is one, is the same function."""
    args = BOUNDARY_OPS[op]
    w = np.arange(1, len(BOUNDARY_X) + 1, dtype=np.float32)
    rx = ref.to_tensor(BOUNDARY_X, stop_gradient=False)
    ref.sum(getattr(ref, op)(rx, *args) * ref.to_tensor(w)).backward()
    px = torch.from_numpy(BOUNDARY_X.copy()).requires_grad_(True)
    (getattr(paddle, op)(px, *args) * torch.from_numpy(w)).sum().backward()
    check(px.grad, np.asarray(rx.grad._data), f"d{op}")
    nn_fn = getattr(paddle.nn.functional, op, None)
    assert nn_fn is None or nn_fn is getattr(paddle, op)


# -- in-place variants ----------------------------------------------------------------

def _inplace_cases():
    """(name, x, extra args): each in-place variant of this slice's
    families, some changing the dtype of the object."""
    f = lambda: _arr([3, 4], "float32", 0.3, 2.0)  # noqa: E731
    i = lambda: _arr([3, 4], "int32", 1, 6)  # noqa: E731
    cases = {}
    for op in ["abs", "acos", "asin", "atan", "asinh", "atanh", "ceil",
               "cos", "cosh", "digamma", "erf", "exp", "expm1", "floor",
               "frac", "lgamma", "log", "log10", "log1p", "log2", "neg",
               "reciprocal", "rsqrt", "sigmoid", "sin", "sinh", "sqrt",
               "square", "tan", "tanh", "trunc", "i0", "nan_to_num",
               "erfinv"]:
        x = f() * 0.4 if op in _UNIT or op == "atanh" else f()
        cases[f"{op}_[f32]"] = (op, x, ())
    cases["acosh_[f32]"] = ("acosh", f() + 1.0, ())
    for op in ["logical_not", "bitwise_not", "abs", "neg", "square",
               "sqrt", "exp"]:
        cases[f"{op}_[i32]"] = (op, i(), ())
    for op in ["add", "subtract", "multiply", "divide", "remainder", "mod",
               "floor_divide", "floor_mod", "pow", "atan2", "fmax", "fmin",
               "maximum", "minimum", "equal", "not_equal", "greater_than",
               "greater_equal", "less_than", "less_equal", "logical_and",
               "logical_or", "logical_xor"]:
        cases[f"{op}_[f32]"] = (op, f(), (f(),))
    for op in ["add", "multiply", "divide", "subtract"]:
        cases[f"{op}_[i32_pyfloat]"] = (op, i(), (2.5,))
        cases[f"{op}_[i32_f32]"] = (op, i(), (f(),))
    for op in ["gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor",
               "floor_divide", "remainder", "add"]:
        cases[f"{op}_[i32]"] = (op, i(), (i(),))
    cases["clip_[f32]"] = ("clip", f(), (0.5, 1.5))
    cases["clip_[i32]"] = ("clip", i(), (2, 4))
    cases["scale_[f32]"] = ("scale", f(), (2.0, 1.0))
    cases["lerp_[f32]"] = ("lerp", f(), (f(), 0.25))
    cases["cumsum_[f32]"] = ("cumsum", f(), (1,))
    cases["cumprod_[f32]"] = ("cumprod", f(), (0,))
    cases["tril_[f32]"] = ("tril", f(), ())
    cases["triu_[f32]"] = ("triu", f(), (1,))
    cases["reshape_[f32]"] = ("reshape", f(), ([4, 3],))
    cases["flatten_[f32]"] = ("flatten", _arr([2, 3, 2], "float32"), ())
    cases["squeeze_[f32]"] = ("squeeze", _arr([3, 1, 4], "float32"), (1,))
    cases["unsqueeze_[f32]"] = ("unsqueeze", f(), (0,))
    cases["transpose_[f32]"] = ("transpose", f(), ([1, 0],))
    cases["t_[square]"] = ("t", _arr([3, 3], "float32"), ())
    cases["cast_[f32]"] = ("cast", f(), ("int32",))
    cases["masked_fill_[f32]"] = ("masked_fill", f(),
                                  (_arr([3, 4], "bool"), 9.0))
    cases["scatter_[f32]"] = ("scatter", f(), (np.array([2, 0]),
                                               _arr([2, 4], "float32")))
    cases["put_along_axis_[f32]"] = ("put_along_axis", f(), (
        np.array([[1], [0], [3]]), 7.0, 1))
    return cases


INPLACE_CASES = _inplace_cases()


def _ref_inplace(name, x, args):
    out = getattr(ref, name + "_")(_ref(x), *[_ref(a) for a in args])
    return out


@pytest.fixture(scope="module")
def inplace_ref():
    return ref_jit({n: (lambda x, *a, op=op: _ref_inplace(op, x, a),
                        (x,) + tuple(args))
                    for n, (op, x, args) in INPLACE_CASES.items()})


@pytest.mark.parametrize("case", sorted(INPLACE_CASES))
def test_inplace(case, inplace_ref):
    """The same object comes back holding the reference's value in the
    reference's dtype."""
    op, x, args = INPLACE_CASES[case]
    t = _port(x)
    out = getattr(paddle, op + "_")(t, *[_port(a) for a in args])
    assert out is t
    check(t, inplace_ref[case], case)


def test_where_inplace_writes_second_argument():
    c = _arr([3, 4], "bool")
    x, y = _arr([3, 4], "float32"), _arr([3, 4], "float32")
    want = ref.where_(ref.to_tensor(c), ref.to_tensor(x), ref.to_tensor(y))
    tx = _port(x)
    out = paddle.where_(_port(c), tx, _port(y))
    assert out is tx
    check(tx, np.asarray(want._data), "where_")


def test_inplace_under_autograd():
    """A same-dtype in-place op on a non-leaf records the op: the
    gradient through it is the functional op's."""
    a = torch.tensor([0.5, 1.0, 2.0], requires_grad=True)
    x = a * 2
    paddle.exp_(x)
    x.sum().backward()
    torch.testing.assert_close(a.grad, 2 * torch.exp(2 * a.detach()),
                               rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError):
        paddle.cast_(a * 1, "float64")


def test_increment():
    x = np.array([1.5], np.float32)
    r = ref.to_tensor(x)
    ref.increment(r, 2.0)
    t = _port(x)
    assert paddle.increment(t, 2.0) is t
    check(t, np.asarray(r._data), "increment")


def test_promotion_lattice_matches_jax():
    """``core.dtype.result_type`` against ``jnp.result_type`` (x64 on) on
    every pair of the port's dtypes and the weak Python scalars."""
    names = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
             "bfloat16", "float32", "float64", "complex64", "complex128"]
    from jax._src import dtypes as jdt

    scalars = [True, 2, 2.5, 1j]
    with jax.enable_x64(True):
        for a in names:
            for b in names + scalars:
                want = jnp.result_type(jnp.dtype(a),
                                       b if not isinstance(b, str)
                                       else jnp.dtype(b))
                got = pdt.result_type(pdt.convert_dtype(a),
                                      b if not isinstance(b, str)
                                      else pdt.convert_dtype(b))
                assert pdt.dtype_name(got) == str(want), (a, b)
            assert pdt.dtype_name(pdt.to_inexact(pdt.convert_dtype(a))) \
                == str(jdt.to_inexact_dtype(jnp.dtype(a))), a
