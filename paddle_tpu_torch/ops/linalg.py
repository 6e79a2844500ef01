"""Linear algebra ops of the port.

Counterpart of ``paddle_tpu/ops/linalg.py``: ``matmul`` and the rest of
the module (``mm`` ... ``inv``), with the linalg tail of ``ops/tail.py``
and the low-rank family of ``ops/lowrank.py`` re-exported.  The
operands promote as ``jax.numpy`` does (``torch.matmul`` refuses mixed
dtypes), each op is dispatched under the reference's name with the
reference's operands and attrs (so its InferMeta validator and AMP
policy apply), and the decompositions are ``torch.linalg``'s on x's
device (``eig`` included: the reference computes it on the host with
LAPACK, the port where x lies).
"""
from __future__ import annotations

import torch

from .math import prep
from .manipulation import _t
from .registry import apply, dispatch, register_op


@dispatch("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, with the last two axes of an operand swapped first
    when its ``transpose_*`` is set (a 1-D operand is not swapped)."""
    x, y = prep(x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return matmul(x, y)


def _op(name, fn):
    op = register_op(name, fn)

    def call(*args, **attrs):
        return apply(op, *args, **attrs)
    return call


_inner = _op("inner", lambda x, y: torch.inner(*prep(x, y)))
_dot = _op("dot", lambda x, y: (x * y).sum(-1))
_outer = _op("outer", lambda x, y: torch.outer(
    *[t.reshape(-1) for t in prep(x, y)]))
_addmm = _op("addmm", lambda inp, x, y, beta=1.0, alpha=1.0:
             beta * inp + alpha * torch.matmul(x, y))


def inner(x, y, name=None):
    return _inner(x, _t(y))


def dot(x, y, name=None):
    x, y = prep(x, y)
    return _dot(x, y)


def outer(x, y, name=None):
    return _outer(x, _t(y))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return _addmm(input, x, y, beta=float(beta), alpha=float(alpha))


def einsum(equation, *operands):
    from .nn_ops import einsum as _einsum

    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return _einsum(equation, *[_t(o) for o in operands])


# -- norms and decompositions ---------------------------------------------------

def norm(x, p=None, axis=None, keepdim=False, name=None):
    """The reference's composition: 2 / fro as sqrt(sum(x * x)), 1,
    +-inf and other p from |x|."""
    x = _t(x)
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if dims is None:
        dims = tuple(range(x.dim()))
    if p is None or p == "fro" or p == 2:
        return torch.sqrt((x * x).sum(dim=dims, keepdim=keepdim))
    if p == 1:
        return x.abs().sum(dim=dims, keepdim=keepdim)
    if p == float("inf"):
        return x.abs().amax(dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return x.abs().amin(dim=dims, keepdim=keepdim)
    return (x.abs() ** p).sum(dim=dims, keepdim=keepdim) ** (1.0 / p)


@dispatch("dist", datas=("x", "y"), validate_only=True)
def dist(x, y, p=2, name=None):
    x, y = prep(x, y)
    return norm(x - y, p=p)


_tri_solve = _op(
    "triangular_solve",
    lambda x, y, upper=True, transpose=False, unitriangular=False:
    torch.linalg.solve_triangular(
        x.transpose(-2, -1) if transpose else x, y,
        upper=upper != transpose, unitriangular=unitriangular))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return _tri_solve(x, y, upper=bool(upper), transpose=bool(transpose),
                      unitriangular=bool(unitriangular))


_cholesky = _op("cholesky", lambda x, upper=False: torch.linalg.cholesky(
    x, upper=upper))


def cholesky(x, upper=False, name=None):
    return _cholesky(x, upper=bool(upper))


_inverse = _op("inverse", torch.linalg.inv)
_det = _op("det", torch.linalg.det)
_slogdet_op = register_op("slogdet", lambda x: tuple(torch.linalg.slogdet(x)),
                          n_outputs=2)
_solve = _op("solve", lambda x, y: torch.linalg.solve(x, y))


def inverse(x, name=None):
    return _inverse(x)


inv = inverse


def det(x, name=None):
    return _det(x)


def slogdet(x, name=None):
    return apply(_slogdet_op, x)


def solve(x, y, name=None):
    return _solve(x, y)


_svd_op = register_op("svd", lambda x, full_matrices=False: _svd(
    x, full_matrices), n_outputs=3)


def _svd(x, full_matrices):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2)


def svd(x, full_matrices=False, name=None):
    """(u, s, v), ``x = u diag(s) v^T``."""
    return apply(_svd_op, x, full_matrices=bool(full_matrices))


_qr_op = register_op("qr", lambda x, mode="reduced": _qr(x, mode),
                     n_outputs=2)


def _qr(x, mode):
    if mode == "r":
        return torch.linalg.qr(x, mode="r").R
    return tuple(torch.linalg.qr(x, mode=mode))


def qr(x, mode="reduced", name=None):
    return apply(_qr_op, x, mode=mode)


_eigh_op = register_op("eigh", lambda x, UPLO="L": tuple(
    torch.linalg.eigh(x, UPLO=UPLO)), n_outputs=2)


def eigh(x, UPLO="L", name=None):
    return apply(_eigh_op, x, UPLO=UPLO)


_matrix_power = _op("matrix_power", lambda x, n: torch.linalg.matrix_power(
    x, n))


def matrix_power(x, n, name=None):
    return _matrix_power(x, n=int(n))


_pinv = _op("pinv", lambda x, rcond=1e-15, hermitian=False:
            torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return _pinv(x, rcond=rcond, hermitian=bool(hermitian))


def _matrix_rank_impl(x, hermitian=False, tol=None):
    if tol is not None:
        return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0,
                                        hermitian=hermitian)
    return torch.linalg.matrix_rank(x, hermitian=hermitian)


_matrix_rank = _op("matrix_rank", _matrix_rank_impl)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return _matrix_rank(x, hermitian=bool(hermitian), tol=tol)


_cross = _op("cross", lambda x, y, axis: torch.linalg.cross(x, y, dim=axis))


def cross(x, y, axis=9, name=None):
    x, y = prep(x, y)
    ax = axis if axis != 9 else None
    if ax is None:
        ax = next(i for i, s in enumerate(x.shape) if s == 3)
    return _cross(x, y, axis=int(ax))


def _histogram_impl(x, bins=100, min=0, max=0):  # noqa: A002
    xf = x.double() if x.is_floating_point() else x.to(torch.float64)
    if min != 0 or max != 0:
        lo, hi = float(min), float(max)
    else:
        lo, hi = float(xf.min()), float(xf.max())
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                           device=x.device)
    k = torch.searchsorted(edges, xf.reshape(-1), right=True) - 1
    k = torch.where(xf.reshape(-1) == edges[-1], torch.full_like(k, bins - 1),
                    k)
    keep = (k >= 0) & (k < bins)
    return torch.bincount(k[keep], minlength=bins).to(torch.int64)


_histogram = _op("histogram", _histogram_impl)


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """``np.histogram``'s counts over ``bins`` equal bins of [min, max]
    (the data's range when both are 0), int64, on the input's device."""
    return _histogram(_t(input), bins=int(bins), min=min, max=max)


def _bincount_impl(x, w=None, minlength=0):
    # np.bincount's result: int64 counts, float64 weighted sums
    return torch.bincount(x.reshape(-1), weights=None if w is None
                          else w.double(), minlength=minlength)


_bincount = _op("bincount", _bincount_impl)


def bincount(x, weights=None, minlength=0, name=None):
    x = _t(x)
    if weights is None:
        return _bincount(x, minlength=minlength)
    return _bincount(x, _t(weights), minlength=minlength)


# -- linalg tail (reference python/paddle/tensor/linalg.py) --------------------

_lu_op = register_op("lu", lambda x, pivot=True: _lu(x), n_outputs=2)


def _lu(x):
    packed, piv = torch.linalg.lu_factor(x)
    return packed, piv.to(torch.int64)


def lu(x, pivot=True, get_infos=False, name=None):
    """Packed LU and 1-based pivots."""
    out = tuple(apply(_lu_op, x, pivot=bool(pivot)))
    if get_infos:
        info = torch.zeros(out[0].shape[:-2], dtype=torch.int64,
                           device=out[0].device)
        return out + (info,)
    return out


@dispatch("lu_unpack", datas=("lu_data", "lu_pivots"), validate_only=True)
def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """(P, L, U) from packed LU; the outputs not asked for are None."""
    P, L, U = torch.lu_unpack(lu_data, lu_pivots.to(torch.int32),
                              unpack_data=True, unpack_pivots=True)
    if not unpack_ludata:
        L = U = None
    return (P if unpack_pivots else None), L, U


_cholesky_solve = _op(
    "cholesky_solve",
    lambda x, y, upper=False: torch.cholesky_solve(x, y, upper=upper))


def cholesky_solve(x, y, upper=False, name=None):
    """Solve A X = B with y the Cholesky factor of A, x = B."""
    return _cholesky_solve(x, y, upper=bool(upper))


_eig_op = register_op("eig", lambda x: tuple(torch.linalg.eig(x)),
                      n_outputs=2)


def eig(x, name=None):
    return apply(_eig_op, x)


def eigvals(x, name=None):
    return torch.linalg.eigvals(_t(x))


_eigvalsh = _op("eigvalsh", lambda x, UPLO="L": torch.linalg.eigvalsh(
    x, UPLO=UPLO))


def eigvalsh(x, UPLO="L", name=None):
    return _eigvalsh(x, UPLO=UPLO)


def svdvals(x, name=None):
    return torch.linalg.svdvals(_t(x))


_cond = _op("cond", lambda x, p=None: torch.linalg.cond(x, p=p))


def cond(x, p=None, name=None):
    return _cond(x, p=p)


_corrcoef = _op("corrcoef", lambda x, rowvar=True: torch.corrcoef(
    x if rowvar else x.transpose(-2, -1)))


def corrcoef(x, rowvar=True, name=None):
    return _corrcoef(x, rowvar=rowvar)


def _cov_impl(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.transpose(-2, -1),
                     correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


_cov = _op("cov", _cov_impl)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None,
        name=None):
    return _cov(x, rowvar=rowvar, ddof=ddof, fweights=fweights,
                aweights=aweights)


def _lstsq_impl(x, y, rcond=None, driver=None):
    sol, res, rank, sv = torch.linalg.lstsq(
        x, y, rcond=rcond,
        driver=driver or ("gelsd" if x.device.type == "cpu" else "gels"))
    return sol, res, rank, sv


_lstsq_op = register_op("lstsq", _lstsq_impl, n_outputs=4)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values)."""
    return apply(_lstsq_op, x, y, rcond=rcond, driver=driver)


def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(_t(x))


_multi_dot = _op("multi_dot", lambda *xs: torch.linalg.multi_dot(list(xs)))


def multi_dot(tensors, name=None):
    return _multi_dot(*tensors)


# The declared tail of paddle.linalg: re-exports of the shared tail
# modules and the low-rank family.
from .lowrank import (  # noqa: F401,E402
    fp8_fp8_half_gemm_fused, matrix_norm, pca_lowrank, svd_lowrank,
    vector_norm,
)
from .tail import (  # noqa: F401,E402
    cholesky_inverse, householder_product, ormqr,
)

