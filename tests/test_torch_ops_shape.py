"""The port's reduction, manipulation and creation op families
(``paddle_tpu_torch/ops/reduction.py``, ``manipulation.py``,
``creation.py``, ``linalg.matmul``) against ``paddle_tpu``'s on the CPU,
on the same seeded numpy inputs.

The reference's side of each family runs as one ``jax.jit`` over its
public functions, computed once per module, with ``jax.vjp`` for the
gradients; the ops the reference computes on the host with numpy
(``unique``, ``unique_consecutive``, ``nonzero``, ``masked_select``) and
the creation ops run eagerly.  ``max`` / ``min`` split a tie's gradient
evenly through the reference's hand-written backward; that is held on
ties against its eager tape.

Tolerances: result dtypes, shapes, integer, bool and index values
exactly; float values within 2e-6 (fp32), 1e-12 (fp64) or 1.6e-2 (bf16)
of the largest reference magnitude (at least 1); gradients likewise.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ref
from paddle_tpu.core.tensor import Tensor as RT
import paddle_tpu_torch as paddle

from test_torch_ops_math import _arr, _port, check, ref_jit

RNG = np.random.default_rng(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


X = _arr([3, 4, 5], "float32")
XI = _arr([3, 4, 5], "int32", -3, 5)
XB = _arr([3, 4], "bool")
XBF = _arr([3, 4, 5], "bfloat16")
XE = np.array([[3.0, 1.0, 2.0, 2.0], [5.0, 5.0, 4.0, 1.0]], np.float32)


def _reduction_cases():
    cases = {}
    for op in ["sum", "mean", "max", "min", "amax", "amin", "prod",
               "logsumexp", "nansum", "nanmean", "median", "var", "std"]:
        cases[f"{op}[all]"] = (op, (X,), {})
        cases[f"{op}[axis1]"] = (op, (X, 1), {})
        cases[f"{op}[axes_keep]"] = (op, (X, [0, 2]), dict(keepdim=True))
    for op in ["sum", "mean", "max", "min", "prod", "median", "var"]:
        cases[f"{op}[i32]"] = (op, (XI, -1), {})
    for op in ["sum", "mean", "max"]:
        cases[f"{op}[bf16]"] = (op, (XBF, 1), {})
    cases["sum[bool]"] = ("sum", (XB,), {})
    cases["sum[dtype]"] = ("sum", (XI, 0, "float32"), {})
    cases["max[bool]"] = ("max", (XB, 1), {})
    cases["median[even]"] = ("median", (XE, 1), {})
    cases["median[odd]"] = ("median", (X[:, :3, 0], 1), dict(keepdim=True))
    for op in ["any", "all"]:
        cases[f"{op}[bool]"] = (op, (XB, 1), {})
        cases[f"{op}[i32]"] = (op, (XI,), {})
    for op in ["argmax", "argmin"]:
        cases[f"{op}[all]"] = (op, (X,), {})
        cases[f"{op}[axis]"] = (op, (X, 2), {})
        cases[f"{op}[keep]"] = (op, (XI, 1), dict(keepdim=True))
        cases[f"{op}[ties]"] = (op, (XE, 1), {})
        cases[f"{op}[int32]"] = (op, (X, 0, False, "int32"), {})
    for op in ["cumsum", "cumprod"]:
        cases[f"{op}[flat]"] = (op, (X[:, :, 0],), {})
        cases[f"{op}[axis]"] = (op, (X, 1), {})
        cases[f"{op}[i32]"] = (op, (XI, 2), {})
    cases["cumsum[bool]"] = ("cumsum", (XB, 1), {})
    for op in ["cummax", "cummin"]:
        cases[f"{op}[axis]"] = (op, (X, 1), {})
        cases[f"{op}[ties]"] = (op, (XE, 1), {})
        cases[f"{op}[flat]"] = (op, (XI,), {})
    cases["count_nonzero[axis]"] = ("count_nonzero", (XI, 1), {})
    cases["count_nonzero[all]"] = ("count_nonzero", (XI,), {})
    cases["quantile[scalar]"] = ("quantile", (X, 0.3, 1), {})
    cases["var[biased]"] = ("var", (X, 1, False), {})
    return cases


def _manip_cases():
    idx = np.array([2, 0, 2], np.int64)
    m = X > 0
    return {
        "cast[i32]": ("cast", (X, "int32"), {}),
        "cast[bf16]": ("cast", (X, "bfloat16"), {}),
        "reshape[-1]": ("reshape", (X, [4, -1]), {}),
        "transpose[perm]": ("transpose", (X, [2, 0, 1]), {}),
        "t[2d]": ("t", (X[0],), {}),
        "t[1d]": ("t", (X[0, 0],), {}),
        "squeeze[all]": ("squeeze", (X[:, :1, None],), {}),
        "squeeze[axis_not1]": ("squeeze", (X, 1), {}),
        "squeeze[list]": ("squeeze", (X[:, :1, :1], [1, 2]), {}),
        "unsqueeze[int]": ("unsqueeze", (X, 1), {}),
        "unsqueeze[list]": ("unsqueeze", (X, [0, -1]), {}),
        "flatten[all]": ("flatten", (X,), {}),
        "flatten[mid]": ("flatten", (X, 1, 2), {}),
        "expand[-1]": ("expand", (X[:, :1], [2, 3, 4, 5]), {}),
        "broadcast_to": ("broadcast_to", (X[0, 0], [3, 5]), {}),
        "tile": ("tile", (X[0], [2, 1, 3]), {}),
        "concat[mixed]": ("concat", ([X, XI],), {}),
        "concat[axis]": ("concat", ([X, X[:, :1]], 1), {}),
        "stack[axis]": ("stack", ([X, X], 2), {}),
        "split[int]": ("split", (X, 2, 1), {}),
        "split[sections]": ("split", (X, [1, -1, 2], 2), {}),
        "chunk": ("chunk", (X, 3, 0), {}),
        "unstack": ("unstack", (X, 1), {}),
        "unbind": ("unbind", (X, -1), {}),
        "flip[list]": ("flip", (X, [0, 2]), {}),
        "roll[flat]": ("roll", (X, 3), {}),
        "roll[axes]": ("roll", (X, [1, -2], [0, 2]), {}),
        "pad[constant]": ("pad", (X, [1, 2], "constant", 0.5), {}),
        "pad[all_axes]": ("pad", (X, [0, 1, 1, 0, 2, 2]), {}),
        "pad[reflect]": ("pad", (X, [2, 1], "reflect"), {}),
        "pad[replicate]": ("pad", (X, [1, 3, 2, 0], "replicate"), {}),
        "pad[circular]": ("pad", (X, [2, 2], "circular"), {}),
        "gather[axis0]": ("gather", (X, idx), {}),
        "gather[axis2]": ("gather", (X, idx, 2), {}),
        "gather[2d_index]": ("gather", (X, idx.reshape(3, 1), 1), {}),
        "index_select": ("index_select", (X, idx, 1), {}),
        "take_along_axis": ("take_along_axis", (
            X, RNG.integers(0, 4, (3, 2, 5)), 1), {}),
        "take_along_axis[bcast]": ("take_along_axis", (
            X, RNG.integers(0, 5, (1, 4, 2)), 2), {}),
        "put_along_axis[assign]": ("put_along_axis", (
            X, np.array([[[1]], [[0]], [[3]]]), 9.0, 1), {}),
        "put_along_axis[add]": ("put_along_axis", (
            X, RNG.integers(0, 4, (3, 2, 5)), _arr([3, 2, 5], "float32"), 1,
            "add"), {}),
        "put_along_axis[mul]": ("put_along_axis", (
            X, np.array([[[0, 1, 2, 3, 0]]] * 3), 2.0, 1, "multiply"), {}),
        "scatter[overwrite]": ("scatter", (
            X[:, :, 0], np.array([2, 0]), _arr([2, 4], "float32")), {}),
        "scatter[add]": ("scatter", (
            X[:, :, 0], np.array([1, 1, 0]), _arr([3, 4], "float32"),
            False), {}),
        "scatter_nd_add": ("scatter_nd_add", (
            X, np.array([[0, 1], [2, 3], [0, 1]]), _arr([3, 5], "float32")),
            {}),
        "gather_nd": ("gather_nd", (X, np.array([[0, 1], [2, 3]])), {}),
        "gather_nd[full]": ("gather_nd", (X, np.array([[0, 1, 2]])), {}),
        "where[f32]": ("where", (m, X, -X), {}),
        "where[scalar]": ("where", (m, X, 0.0), {}),
        "where[int_float]": ("where", (XB, XI[:, :, 0], 0.5), {}),
        "masked_fill[f32]": ("masked_fill", (X, m, 2.0), {}),
        "masked_fill[i32]": ("masked_fill", (XI, m, 7), {}),
        "topk": ("topk", (XE, 2), {}),
        "topk[smallest]": ("topk", (X, 3, 1, False), {}),
        "sort": ("sort", (X, 1), {}),
        "sort[desc]": ("sort", (XE, -1, True), {}),
        "argsort": ("argsort", (XE,), {}),
        "argsort[desc_ties]": ("argsort", (XE, 1, True), {}),
        "assign": ("assign", (X,), {}),
        "tril": ("tril", (X, -1), {}),
        "triu": ("triu", (X[0], 1), {}),
        "diag[vector]": ("diag", (X[0, 0], 1), {}),
        "diag[matrix]": ("diag", (X[0], -1), {}),
        "diagonal": ("diagonal", (X, 1, 1, 2), {}),
        "repeat_interleave[int]": ("repeat_interleave", (X, 2, 1), {}),
        "repeat_interleave[flat]": ("repeat_interleave", (X[0], 3), {}),
        "one_hot": ("one_hot", (np.array([0, 3, 1]), 4), {}),
        "meshgrid": ("meshgrid", (X[0, 0], XI[0, 0, :3]), {}),
        "moveaxis": ("moveaxis", (X, [0, 1], [2, 0]), {}),
        "view[shape]": ("view", (X, [5, 12]), {}),
        "view[dtype]": ("view", (X, "float64"), {}),
        "slice": ("slice", (X, [0, 2], [1, -3], [3, 100]), {}),
        "matmul": ("matmul", (X, X[0].T.copy()), {}),
        "matmul[transpose]": ("matmul", (X[0], X[1], False, True), {}),
        "matmul[vec]": ("matmul", (X[0], X[0, 0]), {}),
        "matmul[mixed]": ("matmul", (X[0], XI[0].T.astype(np.float64)), {}),
        "broadcast_tensors": ("broadcast_tensors",
                              ([X[:, :1], X[0, :, :1].copy()],), {}),
    }


REDUCTION = _reduction_cases()
MANIP = _manip_cases()


def _run_ref(cases):
    return ref_jit({n: (functools.partial(getattr(ref, op), **kw), args)
                    for n, (op, args, kw) in cases.items()})


@pytest.fixture(scope="module")
def reduction_ref():
    return _run_ref(REDUCTION)


@pytest.fixture(scope="module")
def manip_ref():
    return _run_ref(MANIP)


def _conv(a):
    if isinstance(a, list):
        return [_port(v) for v in a]
    return _port(a)


def _check_tree(got, want, what):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), what
        for g, w in zip(got, want):
            _check_tree(g, w, what)
        return
    check(got, want, what)


@pytest.mark.parametrize("case", sorted(REDUCTION))
def test_reduction(case, reduction_ref):
    op, args, kw = REDUCTION[case]
    got = getattr(paddle, op)(*[_conv(a) for a in args], **kw)
    _check_tree(got, reduction_ref[case], case)


@pytest.mark.parametrize("case", sorted(MANIP))
def test_manipulation(case, manip_ref):
    op, args, kw = MANIP[case]
    got = getattr(paddle, op)(*[_conv(a) for a in args], **kw)
    _check_tree(got, manip_ref[case], case)


def test_numel():
    check(paddle.numel(_port(X)), np.asarray(ref.numel(ref.to_tensor(X))._data),
          "numel")


@pytest.mark.parametrize("case", ["unique", "unique_all", "unique_axis",
                                  "unique_consecutive", "nonzero",
                                  "nonzero_tuple", "masked_select",
                                  "where_one_arg"])
def test_host_ops(case):
    """The ops the reference computes on the host with numpy."""
    xi = RNG.integers(0, 4, (4, 5)).astype(np.int64)
    xs = np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int32)
    calls = {
        "unique": ("unique", (xi,), {}),
        "unique_all": ("unique", (xi,), dict(return_index=True,
                                             return_inverse=True,
                                             return_counts=True)),
        "unique_axis": ("unique", (xi[:, :2],), dict(axis=0,
                                                     return_counts=True)),
        "unique_consecutive": ("unique_consecutive", (xs,), dict(
            return_inverse=True, return_counts=True)),
        "nonzero": ("nonzero", (xi,), {}),
        "nonzero_tuple": ("nonzero", (xi,), dict(as_tuple=True)),
        "masked_select": ("masked_select", (X, X > 0.5), {}),
        "where_one_arg": ("where", (xi > 1,), {}),
    }
    op, args, kw = calls[case]
    want = getattr(ref, op)(*[ref.to_tensor(a) for a in args], **kw)
    want = jax.tree_util.tree_map(lambda t: np.asarray(t._data), want,
                                  is_leaf=lambda t: isinstance(t, RT))
    got = getattr(paddle, op)(*[_port(a) for a in args], **kw)
    _check_tree(got, want, case)


# -- gradients ----------------------------------------------------------------------

GRAD_CASES = {
    "sum": (X, 1), "mean": (X, [0, 2]), "max": (X, 1), "min": (X,),
    "prod": (X, 2), "logsumexp": (X, 1), "var": (X, 1), "std": (X,),
    "median": (XE, 1), "cumsum": (X, 1), "cumprod": (X, 2),
    "amax": (X, 0), "quantile": (X, 0.3, 1), "nansum": (X, 0),
    "transpose": (X, [2, 0, 1]), "reshape": (X, [4, -1]),
    "squeeze": (X[:, :1], 1), "unsqueeze": (X, 1), "flatten": (X, 1, 2),
    "expand": (X[:, :1], [2, 3, 4, 5]), "tile": (X, [2, 1, 1]),
    "flip": (X, [1]), "roll": (X, 2, 1), "pad": (X, [1, 2], "reflect"),
    "gather": (X, np.array([2, 0, 2]), 1),
    "take_along_axis": (X, RNG.integers(0, 4, (3, 2, 5)), 1),
    "put_along_axis": (X, RNG.integers(0, 4, (3, 1, 5)),
                       _arr([3, 1, 5], "float32"), 1),
    "scatter": (X[:, :, 0], np.array([2, 0]), _arr([2, 4], "float32")),
    "scatter_nd_add": (X, np.array([[0, 1], [2, 3]]),
                       _arr([2, 5], "float32")),
    "gather_nd": (X, np.array([[0, 1], [2, 3]])),
    "where": (X > 0, X, -2 * X), "masked_fill": (X, X > 0, 0.0),
    "tril": (X, 0), "diagonal": (X, 0, 1, 2), "cast": (X, "float64"),
    "repeat_interleave": (X, 2, 0), "moveaxis": (X, 0, 2),
    "slice": (X, [1], [1], [3]), "topk": (X, 2),
    "sort": (X, 1), "concat": ([X, X[:, :2]], 1), "stack": ([X, X], 0),
    "split": (X, [1, 3], 1), "unstack": (X, 0), "matmul": (X, X[0].T.copy()),
}


def _is_float_arr(a):
    return isinstance(a, np.ndarray) and a.dtype == np.float32


def _grad_leaves(args):
    """The float32 arrays among ``args`` (lists opened) in order."""
    out = []
    for a in args:
        if isinstance(a, list):
            out += [v for v in a if _is_float_arr(v)]
        elif _is_float_arr(a):
            out.append(a)
    return out


def _rebuild(args, leaves):
    it = iter(leaves)
    out = []
    for a in args:
        if isinstance(a, list):
            out.append([next(it) if _is_float_arr(v) else v for v in a])
        else:
            out.append(next(it) if _is_float_arr(a) else a)
    return out


def _flat_out(o):
    if isinstance(o, (list, tuple)):
        return [v for v in o if v.dtype in (torch.float32, np.float32)
                or str(v.dtype) == "float32"]
    return [o]


@pytest.fixture(scope="module")
def grad_ref():
    names = list(GRAD_CASES)

    def run(arrays):
        out = {}
        for n in names:
            args = GRAD_CASES[n]

            def f(*leaves, n=n, args=args):
                call = _rebuild(args, [RT(v) for v in leaves])
                call = [RT(jnp.asarray(a)) if isinstance(a, np.ndarray)
                        else a for a in call]
                res = getattr(ref, n)(*call)
                res = res if isinstance(res, (list, tuple)) else [res]
                return [r._data for r in res
                        if jnp.issubdtype(r._data.dtype, jnp.floating)]

            vals, vjp = jax.vjp(f, *arrays[n])
            gs = [jnp.asarray(np.linspace(-1, 1, v.size).reshape(v.shape),
                              v.dtype) for v in vals]
            out[n] = (vals, vjp(gs))
        return out

    got = jax.jit(run)({n: [jnp.asarray(v) for v in _grad_leaves(a)]
                        for n, a in GRAD_CASES.items()})
    return jax.tree_util.tree_map(np.asarray, got)


@pytest.mark.parametrize("op", sorted(GRAD_CASES))
def test_gradients(op, grad_ref):
    """Gradients through torch's autograd against ``jax.vjp`` of the
    reference under the same cotangents."""
    args = GRAD_CASES[op]
    leaves = [torch.from_numpy(v.copy()).requires_grad_(True)
              for v in _grad_leaves(args)]
    call = [_conv(a) for a in _rebuild(args, leaves)]
    res = getattr(paddle, op)(*call)
    outs = [o for o in (res if isinstance(res, (list, tuple)) else [res])
            if o.is_floating_point()]
    want_vals, want_grads = grad_ref[op]
    loss = 0
    for o, w in zip(outs, want_vals):
        check(o, w, op)
        g = torch.from_numpy(np.linspace(-1, 1, o.numel())
                             .reshape(tuple(o.shape))).to(o.dtype)
        loss = loss + (o * g).sum()
    loss.backward()
    for t, w in zip(leaves, want_grads):
        check(t.grad, w, f"d{op}")


@pytest.mark.parametrize("op", ["max", "min"])
def test_reduction_ties_eager_tape(op):
    """The reference's ``max`` / ``min`` backward splits a tie's gradient
    evenly among the tied entries (its eager tape)."""
    r = ref.to_tensor(XE, stop_gradient=False)
    ref.sum(getattr(ref, op)(r, axis=1) * ref.to_tensor(
        np.array([1.0, 2.0], np.float32))).backward()
    t = torch.from_numpy(XE.copy()).requires_grad_(True)
    (getattr(paddle, op)(t, axis=1) * torch.tensor([1.0, 2.0])).sum().backward()
    check(t.grad, np.asarray(r.grad._data), op)


# -- creation -----------------------------------------------------------------------

CREATION = {
    "zeros": ("zeros", ([2, 3],), {}),
    "zeros[i32]": ("zeros", ([2, 3], "int32"), {}),
    "ones": ("ones", ([4],), {}),
    "full[float]": ("full", ([2, 2], 1.5), {}),
    "full[int]": ("full", ([2], 3), {}),
    "full[bool]": ("full", ([2], True), {}),
    "full[dtype]": ("full", ([2], 3, "int64"), {}),
    "empty": ("empty", ([2, 1],), {}),
    "arange[int]": ("arange", (5,), {}),
    "arange[float]": ("arange", (0.0, 1.0, 0.1), {}),
    "arange[step]": ("arange", (2, 11, 3), {}),
    "arange[dtype]": ("arange", (0, 5, 1, "float32"), {}),
    "linspace": ("linspace", (0.0, 1.0, 7), {}),
    "linspace[f64]": ("linspace", (-1, 3, 5, "float64"), {}),
    "logspace": ("logspace", (0.0, 2.0, 5), {}),
    "eye": ("eye", (3,), {}),
    "eye[rect]": ("eye", (2, 4, "int32"), {}),
}
LIKE = {
    "zeros_like": ("zeros_like", (X,), {}),
    "ones_like[dtype]": ("ones_like", (XI, "float32"), {}),
    "full_like": ("full_like", (XI, 7), {}),
    "empty_like": ("empty_like", (X,), {}),
    "diag_embed": ("diag_embed", (X[0],), {}),
    "diag_embed[offset]": ("diag_embed", (X[0], 1), {}),
    "clone": ("clone", (X,), {}),
    "complex": ("complex", (X[0], X[1]), {}),
    "as_complex": ("as_complex", (X[:, :, :2],), {}),
    "as_real": ("as_real", ((X[0] + 1j * X[1]).astype(np.complex64),), {}),
}


@pytest.mark.parametrize("case", sorted(CREATION))
def test_creation(case):
    op, args, kw = CREATION[case]
    want = np.asarray(getattr(ref, op)(*args, **kw)._data)
    check(getattr(paddle, op)(*args, **kw), want, case)


@pytest.fixture(scope="module")
def like_ref():
    return _run_ref(LIKE)


@pytest.mark.parametrize("case", sorted(LIKE))
def test_creation_like(case, like_ref):
    op, args, kw = LIKE[case]
    got = getattr(paddle, op)(*[_port(a) for a in args], **kw)
    want = like_ref[case]
    if np.iscomplexobj(want):
        check(torch.view_as_real(got), np.stack([want.real, want.imag], -1),
              case)
    else:
        check(got, want, case)


def test_creation_follows_default_dtype():
    ref.set_default_dtype("float64")
    paddle.set_default_dtype("float64")
    try:
        for op, args in [("zeros", ([2],)), ("full", ([2], 1.5)),
                         ("arange", (0.0, 1.0, 0.25))]:
            check(getattr(paddle, op)(*args),
                  np.asarray(getattr(ref, op)(*args)._data), op)
    finally:
        ref.set_default_dtype("float32")
        paddle.set_default_dtype("float32")
