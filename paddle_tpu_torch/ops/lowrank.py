"""Low-rank factorizations, the linalg norms and the fp8 GEMM.

Counterpart of ``paddle_tpu/ops/lowrank.py``: ``svd_lowrank`` (the
randomized range finder of Halko et al.: a Gaussian sketch drawn from the
port's generator of x's device, ``niter`` QR-orthogonalized power
iterations, one small exact SVD), ``pca_lowrank``, ``vector_norm``,
``matrix_norm`` and ``fp8_fp8_half_gemm_fused`` (an XLA dot in the
reference, not a Pallas kernel: on the card ``torch._scaled_mm`` on
float8 operands, on the CPU the operands upcast after the same float8
rounding).  Everything runs on x's device.
"""
from __future__ import annotations

import torch

from .manipulation import _t
from .random import generator


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized truncated SVD: ``(u, s, v)`` with ``x ~ u diag(s) v^T``."""
    a = _t(x)
    if M is not None:
        a = a - _t(M)
    m, n = a.shape[-2], a.shape[-1]
    q = int(min(q, m, n))
    omega = torch.randn(a.shape[:-2] + (n, q), dtype=a.dtype,
                        device=a.device, generator=generator(a.device))
    qb = torch.linalg.qr(a @ omega).Q
    for _ in range(int(niter)):
        qz = torch.linalg.qr(a.transpose(-2, -1) @ qb).Q
        qb = torch.linalg.qr(a @ qz).Q
    u_b, s, vt = torch.linalg.svd(qb.transpose(-2, -1) @ a,
                                  full_matrices=False)
    return qb @ u_b, s, vt.transpose(-2, -1)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """PCA through :func:`svd_lowrank` of the column-centred x."""
    a = _t(x)
    m, n = a.shape[-2], a.shape[-1]
    if q is None:
        q = min(6, m, n)
    if center:
        a = a - a.mean(dim=-2, keepdim=True)
    return svd_lowrank(a, q=q, niter=niter)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """The p-norm over ``axis`` (all axes as one vector when None)."""
    a = _t(x)
    if axis is None:
        a = a.reshape(-1)
        axis = 0
    axis = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    p = float(p)
    if p == float("inf"):
        return a.abs().amax(dim=axis, keepdim=keepdim)
    if p == float("-inf"):
        return a.abs().amin(dim=axis, keepdim=keepdim)
    if p == 0:
        return (a != 0).to(a.dtype).sum(dim=axis, keepdim=keepdim)
    return (a.abs() ** p).sum(dim=axis, keepdim=keepdim) ** (1.0 / p)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    """Frobenius, nuclear and operator norms over two axes."""
    a = _t(x)
    axis = tuple(int(v) for v in axis)
    if p in ("fro", "f"):
        return torch.sqrt((a.abs() ** 2).sum(dim=axis, keepdim=keepdim))
    if p == "nuc" or p in (2, -2, 2.0, -2.0):
        s = torch.linalg.svdvals(torch.movedim(a, axis, (-2, -1)))
        if p == "nuc":
            out = s.sum(-1)
        elif float(p) > 0:
            out = s.amax(-1)
        else:
            out = s.amin(-1)
        if keepdim:
            for ax in sorted(v % a.dim() for v in axis):
                out = out.unsqueeze(ax)
        return out
    row_axis, col_axis = axis
    if p in (1, -1, 1.0, -1.0):
        sums = a.abs().sum(dim=row_axis, keepdim=True)
        out = sums.amax(dim=col_axis, keepdim=True) if float(p) > 0 \
            else sums.amin(dim=col_axis, keepdim=True)
    elif p in (float("inf"), float("-inf")):
        sums = a.abs().sum(dim=col_axis, keepdim=True)
        out = sums.amax(dim=row_axis, keepdim=True) if p > 0 \
            else sums.amin(dim=row_axis, keepdim=True)
    else:
        raise ValueError(f"unsupported matrix norm order {p!r}")
    if not keepdim:
        out = out.squeeze(axis)
    return out


_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def fp8_fp8_half_gemm_fused(x, y, transpose_x=False, transpose_y=False,
                            bias=None, scale=1.0, output_dtype="float16",
                            act="identity", name=None):
    """fp8 x fp8 -> half GEMM: operands rounded to float8_e4m3fn (unless
    already float8), the product accumulated in fp32, then ``scale``,
    ``bias`` and ``act`` (identity, relu, tanh-gelu as ``jax.nn.gelu``)
    and one cast to
    ``output_dtype`` (float16 or bfloat16)."""
    a, b = _t(x), _t(y)
    a = a if a.dtype in _FP8 else a.to(torch.float8_e4m3fn)
    b = b if b.dtype in _FP8 else b.to(torch.float8_e4m3fn)
    if transpose_x:
        a = a.transpose(-2, -1)
    if transpose_y:
        b = b.transpose(-2, -1)
    if a.is_cuda and a.dim() == 2 and b.dim() == 2:
        one = torch.ones((), dtype=torch.float32, device=a.device)
        out = torch._scaled_mm(a.contiguous(), b.t().contiguous().t(),
                               scale_a=one, scale_b=one,
                               out_dtype=torch.float32)
    else:
        out = torch.matmul(a.float(), b.float())
    out = out * scale
    if bias is not None:
        out = out + _t(bias).to(out.dtype)
    if act == "relu":
        out = torch.relu(out)
    elif act == "gelu":
        out = torch.nn.functional.gelu(out, approximate="tanh")
    elif act != "identity":
        raise ValueError(f"unsupported act {act!r}")
    dt = torch.bfloat16 if "bfloat16" in str(output_dtype) \
        else torch.float16
    return out.to(dt)


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """The fp32 bin edges ``histogram`` uses (on the input's device)."""
    x = _t(input).double()
    lo, hi = (float(min), float(max)) if (min != 0 or max != 0) else (
        float(x.min()), float(x.max()))
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.linspace(lo, hi, int(bins) + 1, dtype=torch.float64,
                          device=x.device).float()


def create_tensor(dtype, name=None, persistable=False):
    """An empty typed holder (shape [0]) on the current place."""
    from ..core.dtype import convert_dtype
    from ..device import resolve_device

    t = torch.zeros((0,), dtype=convert_dtype(dtype),
                    device=resolve_device(None))
    t.persistable = persistable
    return t


def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1, k=0,
                   mode="truncated", return_top=False, name=None):
    """Nucleus sampling over probabilities ``x [B, V]`` with per-row
    ``ps [B]``: the smallest prefix of the descending distribution whose
    mass reaches p (the crossing token kept), renormalised, one id a row
    drawn from the port's generator (or from ``seed`` / per-row
    ``topp_seed``).  Returns (scores, ids) [B, 1], and the top-k values
    and ids with ``return_top``."""
    probs = _t(x).float()
    p = _t(ps).float().reshape(-1, 1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    csum = torch.cumsum(sorted_p, dim=-1)
    keep = (csum - sorted_p) < p
    kept = torch.where(keep, sorted_p, torch.zeros_like(sorted_p)) \
        if mode == "truncated" else sorted_p
    if threshold is not None:
        kept = torch.where(sorted_p >= _t(threshold).reshape(-1, 1), kept,
                           torch.zeros_like(kept))
    kept = torch.where(keep.any(-1, keepdim=True), kept, sorted_p)
    if topp_seed is not None:
        seeds = _t(topp_seed).reshape(-1).tolist()
        pick = torch.cat([torch.multinomial(
            kept[i:i + 1], 1, generator=torch.Generator(
                device=kept.device).manual_seed(int(s)))
            for i, s in enumerate(seeds)])
    else:
        gen = torch.Generator(device=kept.device).manual_seed(int(seed)) \
            if seed != -1 else generator(kept.device)
        pick = torch.multinomial(kept, 1, generator=gen)
    ids = order.gather(-1, pick)
    scores = probs.gather(-1, ids).to(_t(x).dtype)
    if return_top and k > 0:
        topv, topi = torch.topk(probs, k, dim=-1)
        return scores, ids, topv.to(_t(x).dtype), topi
    return scores, ids
