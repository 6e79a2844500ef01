"""The port's op tail (``paddle_tpu_torch/ops/linalg.py``, ``lowrank.py``,
``extra.py``, ``tail.py`` and their in-place variants) against
``paddle_tpu``'s on the CPU, on the same seeded numpy inputs.

Each case is one function of the package (``P``), called the same way on
both sides.  The reference's side of each family runs as one
``jax.jit`` (each argument wrapped in ``paddle_tpu``'s ``Tensor``,
``._data`` read back), gradients from ``jax.grad`` of the same weighted
sum of the outputs the port differentiates with autograd; the few host
functions of the reference (``histogram``, ``bincount``, ``take``'s
bounds check, ``eig``, ``histogramdd``) run eagerly.

Tolerances: dtypes, shapes, integer and bool values exactly; floats
within 2e-6 (1e-5 for the decompositions, which take other LAPACK paths)
of the largest reference magnitude (at least 1); gradients within 1e-5
of the largest magnitude.  Decompositions are compared through what
they reconstruct or their invariants (signs of singular vectors, QR
columns and LU pivots are each library's choice).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ref
from paddle_tpu.core.tensor import Tensor as RT
import paddle_tpu_torch as paddle

RNG = np.random.default_rng(23)


@pytest.fixture(autouse=True)
def _cpu():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


def _f(*shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


A, B = _f(5, 5), _f(5, 3)
SPD = (A @ A.T + 5 * np.eye(5)).astype(np.float32)
X, Y = _f(3, 4, 5), _f(3, 4, 5, lo=0.2, hi=2.0)
V, W = _f(6), _f(6)
IDS = RNG.integers(0, 6, (12,)).astype(np.int64)
LOW = (_f(6, 2) @ _f(2, 5)).astype(np.float32)
EDGES = np.linspace(-1, 1, 5).astype(np.float32)

# name: (fn(P, *tensors), numpy inputs, differentiable, tolerance)
CASES = {
    "mm": (lambda P, a, b: P.mm(a, b), [A, B], True),
    "bmm": (lambda P, a, b: P.bmm(a, b), [X, np.swapaxes(Y, 1, 2)], True),
    "inner": (lambda P, a, b: P.inner(a, b), [X, Y], True),
    "dot": (lambda P, a, b: P.dot(a, b), [V, W], True),
    "outer": (lambda P, a, b: P.outer(a, b), [V, W], True),
    "addmm": (lambda P, i, a, b: P.addmm(i, a, b, 0.5, 2.0),
              [_f(5, 3), A, B], True),
    "einsum": (lambda P, a, b: P.einsum("bij,bkj->bik", a, b), [X, Y], True),
    "norm": (lambda P, a: P.linalg.norm(a, p=3, axis=1), [X], True),
    "dist": (lambda P, a, b: P.dist(a, b, 2), [X, Y], True),
    "triangular_solve": (lambda P, a, b: P.linalg.triangular_solve(
        a, b, upper=False), [np.tril(A) + 3 * np.eye(5, dtype=np.float32),
                             B], True),
    "cholesky": (lambda P, a: P.linalg.cholesky(a), [SPD], True),
    "inverse": (lambda P, a: P.linalg.inv(a), [SPD], True),
    "det": (lambda P, a: P.linalg.det(a), [SPD], True),
    "slogdet": (lambda P, a: P.linalg.slogdet(a), [SPD], False),
    "solve": (lambda P, a, b: P.linalg.solve(a, b), [SPD, B], True),
    "svd[s]": (lambda P, a: P.linalg.svd(a)[1], [B], False),
    "svdvals": (lambda P, a: P.linalg.svdvals(a), [B], False),
    "eigh[w]": (lambda P, a: P.linalg.eigh(a)[0], [SPD], False),
    "eigvalsh": (lambda P, a: P.linalg.eigvalsh(a), [SPD], False),
    "matrix_power": (lambda P, a: P.linalg.matrix_power(a, 3), [A], True),
    "pinv": (lambda P, a: P.linalg.pinv(a), [B], False),
    "cross": (lambda P, a, b: P.cross(a, b, axis=1), [_f(4, 3), _f(4, 3)],
              True),
    "cholesky_solve": (lambda P, a, b: P.linalg.cholesky_solve(
        b, P.linalg.cholesky(a)), [SPD, B], False),
    "cond": (lambda P, a: P.linalg.cond(a), [SPD], False),
    "corrcoef": (lambda P, a: P.linalg.corrcoef(a), [_f(3, 7)], False),
    "cov": (lambda P, a: P.linalg.cov(a), [_f(3, 7)], False),
    "lstsq": (lambda P, a, b: P.linalg.lstsq(a, b)[0],
              [_f(7, 3), _f(7, 2)], False),
    "matrix_exp": (lambda P, a: P.linalg.matrix_exp(a * 0.3), [A], False),
    "multi_dot": (lambda P, a, b: P.linalg.multi_dot(
        [a, b, P.transpose(b, [1, 0])]), [A, B],
                  True),
    "vector_norm": (lambda P, a: P.linalg.vector_norm(a, 3, axis=[0, 2]),
                    [X], True),
    "matrix_norm": (lambda P, a: (P.linalg.matrix_norm(a),
                                  P.linalg.matrix_norm(a, "nuc"),
                                  P.linalg.matrix_norm(a, 1)), [X], False),
    "kron": (lambda P, a, b: P.kron(a, b), [A[:2, :2], B[:2]], True),
    "trace": (lambda P, a: P.trace(a, 1), [A], True),
    "heaviside": (lambda P, a, b: P.heaviside(a, b), [X, Y], False),
    "copysign": (lambda P, a, b: P.copysign(a, b), [Y, X], True),
    "hypot": (lambda P, a, b: P.hypot(a, b), [X, Y], True),
    "deg2rad": (lambda P, a: P.deg2rad(a), [X], True),
    "rad2deg": (lambda P, a: P.rad2deg(a), [X], True),
    "diff": (lambda P, a: P.diff(a, n=2, axis=-1), [X], True),
    "trapezoid": (lambda P, a: P.trapezoid(a, dx=0.5), [X], True),
    "cumulative_trapezoid": (lambda P, a: P.cumulative_trapezoid(a), [X],
                             True),
    "vander": (lambda P, a: P.vander(a, 4), [V], True),
    "logcumsumexp": (lambda P, a: P.logcumsumexp(a, 1), [X], True),
    "renorm": (lambda P, a: P.renorm(a, 2.0, 1, 1.0), [X], True),
    "cdist": (lambda P, a, b: P.cdist(a, b), [_f(4, 3), _f(5, 3)], True),
    "pdist": (lambda P, a: P.pdist(a), [_f(5, 3)], True),
    "tensordot": (lambda P, a, b: P.tensordot(a, b, [[1, 2], [1, 2]]),
                  [X, Y], True),
    "bucketize": (lambda P, a, e: P.bucketize(a, e), [X, EDGES], False),
    "searchsorted": (lambda P, e, a: P.searchsorted(e, a, right=True),
                     [EDGES, X], False),
    "nanmedian": (lambda P, a: P.nanmedian(a, axis=1), [X], True),
    "nanquantile": (lambda P, a: P.nanquantile(a, 0.3, axis=2), [X], True),
    "mode": (lambda P, a: P.mode(P.round(a * 2), axis=1), [X], False),
    "kthvalue": (lambda P, a: P.kthvalue(a, 2, axis=2), [X], True),
    "rot90": (lambda P, a: P.rot90(a, 1, [1, 2]), [X], True),
    "index_add": (lambda P, a, i, u: P.index_add(a, i, 1, u),
                  [X, np.array([0, 2, 0]), _f(3, 3, 5)], True),
    "index_fill": (lambda P, a, i: P.index_fill(a, i, 1, 0.5),
                   [X, np.array([1, 3])], True),
    "index_put": (lambda P, a, i, u: P.index_put(a, (i,), u, True),
                  [X, np.array([0, 2]), _f(4, 5)], True),
    "unfold": (lambda P, a: P.unfold(a, 2, 2, 1), [X], True),
    "as_strided": (lambda P, a: P.as_strided(a, [3, 4], [5, 2], 1), [X],
                   True),
    "select_scatter": (lambda P, a, u: P.select_scatter(a, u, 1, 2),
                       [X, _f(3, 5)], True),
    "slice_scatter": (lambda P, a, u: P.slice_scatter(
        a, u, [2], [1], [5], [2]), [X, _f(3, 4, 2)], True),
    "diagonal_scatter": (lambda P, a, u: P.diagonal_scatter(a, u, 1),
                         [A, _f(4)], True),
    "masked_scatter": (lambda P, a, u: P.masked_scatter(a, a > 0, u),
                       [X, _f(60)], True),
    "stacks": (lambda P, a: (P.column_stack([a[0, 0], a[1, 0]]),
                             P.row_stack([a[0], a[1]]),
                             P.dstack([a[0], a[1]]), P.hstack([a[0], a[1]]),
                             P.vstack([a[0], a[1]]),
                             *P.atleast_3d(a[0, 0], a[0])), [X], True),
    "splits": (lambda P, a: (*P.tensor_split(a, 3, 2), *P.hsplit(a, [1, 3]),
                             *P.vsplit(a, 3), *P.dsplit(a, [2])), [X], True),
    "diagflat": (lambda P, a: P.diagflat(a, 1), [V], True),
    "complex parts": (lambda P, a: (P.real(a), P.imag(a), P.conj(a),
                                    P.angle(a)), [X], False),
    "polar": (lambda P, a, b: (P.real(P.polar(a, b)),
                               P.imag(P.polar(a, b))), [Y, X], False),
    "sgn": (lambda P, a: P.sgn(a), [X], False),
    "predicates": (lambda P, a: (P.isreal(a), P.isneginf(a / 0 * -1),
                                 P.isposinf(a / 0), P.signbit(a),
                                 P.isin(a, a[0])), [X], False),
    "sinc/logit/round": (lambda P, a: (P.sinc(a), P.logit(a * 0.4 + 0.5,
                                                          1e-3),
                                       P.round(a * 10, 1)), [X], True),
    "nextafter": (lambda P, a, b: P.nextafter(a, b), [X, Y], False),
    "special": (lambda P, a: (P.gammaln(a), P.gammainc(a, a * 2),
                              P.gammaincc(a, a * 2),
                              P.multigammaln(a + 2, 3), P.i0e(a), P.i1(a),
                              P.i1e(a), P.polygamma(a, 1)), [Y], False),
    "block_diag/add_n/cartesian_prod": (lambda P, a: (
        P.block_diag([a[0], a[1, :2]]), P.add_n([a, a, a]),
        P.cartesian_prod([a[0, 0], a[1, 1, :2]])), [X], True),
    "combinations": (lambda P, a: P.combinations(a, 2), [V], True),
    "reverse/crop/unflatten": (lambda P, a: (
        P.reverse(a, [0, 2]), P.crop(a, [2, 2, -1], [1, 1, 2]),
        P.unflatten(a, 2, [5, 1])), [X], True),
    "view_as/strided_slice": (lambda P, a: (
        P.view_as(a, P.reshape(a, [4, 15])),
        P.strided_slice(a, [1, 2], [3, 0], [0, 5], [-1, 2])), [X], True),
    "scatter_nd": (lambda P, i, u: P.scatter_nd(i, u, [5, 4]),
                   [np.array([[1], [3], [1]]), _f(3, 4)], True),
    "index_sample": (lambda P, a, i: P.index_sample(a, i),
                     [B.T.copy(), np.array([[0, 3], [2, 2], [4, 1]])], True),
    "multiplex": (lambda P, a, b, i: P.multiplex([a, b], i),
                  [A, A * 2, np.array([[1], [0], [1], [0], [0]])], True),
    "shard_index": (lambda P, i: P.shard_index(P.reshape(i, [-1, 1]), 6, 2,
                                               1), [IDS], False),
    "reduce_as": (lambda P, a: P.reduce_as(a, a[0, :, :1]), [X], True),
    "frexp": (lambda P, a: P.frexp(a), [X], False),
    "bit shifts": (lambda P, i: (P.bitwise_left_shift(i, 2),
                                 P.bitwise_right_shift(-i, 1, False),
                                 P.bitwise_right_shift(-i, 1)), [IDS],
                   False),
    "mv": (lambda P, a, v: P.mv(a, v), [A, V[:5]], True),
}
TOL = {"cholesky": 1e-5, "inverse": 1e-5, "det": 1e-5, "solve": 1e-5,
       "svd[s]": 1e-5, "svdvals": 1e-5, "pinv": 1e-5, "cond": 1e-5,
       "lstsq": 1e-5, "matrix_exp": 1e-5, "matrix_norm": 1e-5,
       "eigh[w]": 1e-5, "eigvalsh": 1e-5, "cholesky_solve": 1e-5,
       "triangular_solve": 1e-5, "slogdet": 1e-5, "special": 1e-5}

# host functions of the reference: run eagerly on both sides
EAGER = {
    "histogram": (lambda P, a: P.histogram(a, 7, -1, 1), [X]),
    "bincount": (lambda P, i: P.bincount(i, minlength=8), [IDS]),
    "bincount[weights]": (lambda P, i, w: P.bincount(i, w), [IDS, _f(12)]),
    "take": (lambda P, a, i: P.take(a, i), [X, np.array([0, 7, -1, 33])]),
    "take[wrap]": (lambda P, a, i: P.take(a, i, mode="wrap"),
                   [X, np.array([0, 70, -1])]),
    "histogramdd": (lambda P, a: P.histogramdd(a, 3), [_f(20, 2)]),
    "tril/triu_indices": (lambda P: (P.tril_indices(4, 5, 1),
                                     P.triu_indices(4, None, -1)), []),
    "matrix_rank": (lambda P, a: P.linalg.matrix_rank(a), [LOW]),
    "is_*": (lambda P, a: (P.is_empty(a), P.shape(a)), [X]),
}


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def _check(got, want, tol, what):
    want = np.asarray(want)
    g = _np(got)
    assert str(g.dtype) == str(want.dtype), (what, g.dtype, want.dtype)
    assert g.shape == want.shape, (what, g.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(g, want, err_msg=what)
        return
    w, g = want.astype(np.float64), g.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    ok = ~np.isnan(w)
    fin = ok & np.isfinite(w)
    np.testing.assert_array_equal(g[ok & ~fin], w[ok & ~fin], err_msg=what)
    scale = max(1.0, float(np.abs(w[fin]).max(initial=0)))
    np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=tol * scale,
                               err_msg=what)


def _weights(n):
    return np.linspace(-1, 1, n).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """{name: (output arrays, gradient arrays)} of every CASES entry, in
    one ``jax.jit``."""
    def run(arrays):
        out = {}
        for name, (fn, args, diff) in CASES.items():
            def f(*xs, fn=fn):
                res = fn(ref, *[RT(x) for x in xs])
                return [r._data for r in _leaves(res)]

            xs = arrays[name]
            vals = f(*xs)
            grads = None
            if diff:
                fl = [i for i, a in enumerate(args)
                      if np.asarray(a).dtype.kind == "f"]

                def loss(*d, xs=xs, f=f, fl=fl):
                    full = list(xs)
                    for i, v in zip(fl, d):
                        full[i] = v
                    return sum((o * jnp.asarray(_weights(o.size)).reshape(
                        o.shape)).sum() for o in f(*full)
                        if jnp.issubdtype(o.dtype, jnp.floating))

                grads = jax.grad(loss, argnums=tuple(range(len(fl))))(
                    *[xs[i] for i in fl])
            out[name] = (vals, grads)
        return out

    got = jax.jit(run)({n: [jnp.asarray(a) for a in c[1]]
                        for n, c in CASES.items()})
    return jax.tree_util.tree_map(np.asarray, got)


@pytest.mark.parametrize("name", list(CASES))
def test_op_matches_reference(reference, name):
    fn, args, diff = CASES[name]
    ts = [paddle.to_tensor(a) for a in args]
    if diff:
        for t in ts:
            if t.is_floating_point():
                t.stop_gradient = False
    outs = _leaves(fn(paddle, *ts))
    want, wgrads = reference[name]
    tol = TOL.get(name, 2e-6)
    assert len(outs) == len(want), name
    for i, (g, w) in enumerate(zip(outs, want)):
        _check(g, w, tol, f"{name} out {i}")
    if not diff:
        return
    terms = [(o * torch.from_numpy(_weights(o.numel())).reshape(
        o.shape)).sum() for o in outs if o.is_floating_point()]
    sum(terms).backward()
    got = [t.grad for t in ts if t.is_floating_point()]
    for i, (g, w) in enumerate(zip(got, wgrads)):
        _check(g, w, 1e-5, f"{name} grad {i}")


@pytest.mark.parametrize("name", list(EAGER))
def test_host_op_matches_reference(name):
    fn, args = EAGER[name]
    outs = _leaves(fn(paddle, *[paddle.to_tensor(a) for a in args]))
    want = _leaves(fn(ref, *[ref.to_tensor(a) for a in args]))
    assert len(outs) == len(want)
    for i, (g, w) in enumerate(zip(outs, want)):
        w = w if isinstance(w, (bool, np.bool_)) else np.asarray(w._data)
        if isinstance(g, bool):
            assert g == bool(w), name
            continue
        _check(g, w, 2e-6, f"{name} out {i}")


def test_decompositions_reconstruct():
    """svd, qr, lu (and lu_unpack), eig, eigh: each factorisation
    reconstructs its input, as the reference's does."""
    a = paddle.to_tensor(A)
    b = paddle.to_tensor(B)
    u, s, v = paddle.linalg.svd(b)
    np.testing.assert_allclose(_np(u @ torch.diag(s) @ v.T), B, atol=1e-5)
    q, r = paddle.linalg.qr(b)
    np.testing.assert_allclose(_np(q @ r), B, atol=1e-5)
    lu, piv = paddle.linalg.lu(a)
    p, lo, up = paddle.linalg.lu_unpack(lu, piv)
    np.testing.assert_allclose(_np(p @ lo @ up), A, atol=1e-5)
    rlu, rpiv = ref.linalg.lu(ref.to_tensor(A))
    np.testing.assert_array_equal(_np(piv), np.asarray(rpiv._data))
    w, vv = paddle.linalg.eig(a)
    np.testing.assert_allclose(_np(vv @ torch.diag(w) @ torch.linalg.inv(vv)),
                               A, atol=1e-4)
    wr = np.sort_complex(np.asarray(ref.linalg.eig(ref.to_tensor(A))[0]
                                    ._data))
    np.testing.assert_allclose(np.sort_complex(_np(w)), wr, atol=1e-5)
    lr = paddle.linalg.svd_lowrank(paddle.to_tensor(LOW), q=2)[1]
    np.testing.assert_allclose(_np(lr), np.linalg.svd(LOW)[1][:2],
                               atol=1e-5)


def test_fp8_gemm_matches_reference():
    """fp8 x fp8 -> half: both round the operands to float8_e4m3fn and
    accumulate in fp32; one bf16 rounding of the product apart."""
    a, b = _f(16, 32), _f(16, 32)
    got = paddle.fp8_fp8_half_gemm_fused(
        paddle.to_tensor(a), paddle.to_tensor(b), transpose_y=True,
        output_dtype="bfloat16", act="gelu")
    want = ref.fp8_fp8_half_gemm_fused(
        ref.to_tensor(a), ref.to_tensor(b), transpose_y=True,
        output_dtype="bfloat16", act="gelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(
        want._data.astype(jnp.float32)), rtol=2 ** -7, atol=1e-3)


INPLACE = [("addmm_", [_f(5, 3), A, B]), ("copysign_", [Y, X]),
           ("hypot_", [X, Y]), ("ldexp_", [X, np.full((3, 4, 5), 2)]),
           ("gammainc_", [Y, Y]), ("gammaincc_", [Y, Y]),
           ("gammaln_", [Y]), ("logit_", [Y * 0.3]), ("sinc_", [X]),
           ("multigammaln_", [Y + 2, 2]), ("polygamma_", [Y, 1]),
           ("renorm_", [X, 2.0, 0, 1.0]),
           ("index_add_", [X, np.array([0, 3]), 1, _f(3, 2, 5)]),
           ("index_fill_", [X, np.array([1]), 0, 3.0]),
           ("masked_scatter_", [X, X > 0, _f(60)]),
           ("bitwise_left_shift_", [IDS, np.ones(12, np.int64)]),
           ("bitwise_right_shift_", [IDS * 8, np.ones(12, np.int64)])]


@pytest.mark.parametrize("name,args", INPLACE, ids=[n for n, _ in INPLACE])
def test_inplace_variant_matches_reference(name, args):
    """The 17 in-place variants: the same object back, holding the
    reference's value and dtype."""
    def conv(P, a):
        return P.to_tensor(a) if isinstance(a, np.ndarray) else a

    t = conv(paddle, args[0])
    assert getattr(paddle, name)(t, *[conv(paddle, a) for a in args[1:]]) \
        is t
    r = conv(ref, args[0])
    getattr(ref, name)(r, *[conv(ref, a) for a in args[1:]])
    _check(t, np.asarray(r._data), 2e-6, name)
