"""Fused RMSNorm, forward and backward: the hand-written CUDA kernels and
their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas_kernels/
rms_norm.py``: ``_fused_fwd_2d`` (out in x's dtype, fp32 ``rstd``) and
``_fused_bwd_2d`` (``dx`` in x's dtype), reached on the training path
through ``nn.functional.rms_norm`` under ``FLAGS_use_fused_rms_norm``.
The kernels are ``csrc/rms_norm.cu``: one block per row, the row read
once into shared memory as fp32 (read a second time from device memory
where it does not fit: the forward past h = 58112, the backward past
h = 29056), an fp32 block reduction, and the output written with ONE cast
(``x * rstd * w`` in fp32, then x's dtype).  Any hidden size (a vector
body with a scalar head and tail) and x, w each fp32, bf16 or fp16, as
the reference sends any h and dtype to its kernel.  That
is the fused rounding rule, which differs from the plain op
(``ops.nn_ops.rms_norm`` casts ``x * rstd`` first, then multiplies by the
weight cast to x's dtype): with fp32 norm weights on a bf16 stream the
two round differently, and the plain versions here follow the fused rule.

What bounds them on an H100: bytes (x, w in; out, rstd out; and x, dy,
w, rstd in, dx out for the backward) at 3.35 TB/s.  The design reads
each input row once and keeps no row-block padding (the TPU version pads
rows to 256).  ``dw = sum_rows(dy * x * rstd)`` is a plain contraction,
as in the TPU version.

Routing: CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise.  ``rms_norm_fwd.launches`` / ``rms_norm_bwd.launches``
count kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ..registry import refuse_create_graph
from . import _build

#: x and w dtypes the kernels are instantiated for (every pair)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SMEM_LIMIT = 232448            # bytes of shared memory a block may use


def smem_bytes(h) -> dict:
    """Dynamic shared memory a block takes at hidden size ``h`` (mirrors
    the .cu: the row, and in the backward the row of dy too, in fp32; 0
    past the limit, where the row is read twice from device memory)."""
    return {k: (b if b <= _SMEM_LIMIT else 0)
            for k, b in (("fwd", 4 * h), ("bwd", 8 * h))}


def rms_norm_fwd_reference(x2, w, eps):
    """Plain version of ``_fused_fwd_2d``: x2 [N, h], w [h] ->
    (out [N, h] in x's dtype, rstd [N] fp32)."""
    xf = x2.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1) + eps)
    out = (xf * rstd[:, None] * w.float()).to(x2.dtype)
    return out, rstd


def rms_norm_bwd_reference(x2, w, rstd, dy2):
    """Plain version of ``_fused_bwd_2d``: dx [N, h] in x's dtype."""
    dxhat = dy2.float() * w.float()
    xhat = x2.float() * rstd[:, None]
    m = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (rstd[:, None] * (dxhat - xhat * m)).to(x2.dtype)


def _lib():
    lib = _build.load("rms_norm")
    fwd, bwd = lib.rms_norm_fwd_launch, lib.rms_norm_bwd_launch
    if fwd.argtypes is None:
        fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                        + [ctypes.c_float] + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(name, x2, w, *others):
    if x2.dim() != 2 or w.shape != (x2.shape[1],):
        raise ValueError(f"{name}: expected x [N, h] and w [h], got "
                         f"{tuple(x2.shape)} and {tuple(w.shape)}")
    for t in (w, *others):
        if t.device != x2.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{x2.device}")
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x2.device}")
    if x2.device.type == "cpu":
        return
    if x2.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtypes x={x2.dtype}, w={w.dtype} not "
                        "supported by the kernel (fp32, bf16, fp16)")
    for t in (x2, w, *others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: a tensor is not contiguous")


def _aligned(t):
    """``t``, or a fresh copy when its data does not start on 16 bytes
    (the kernels' vector loads assume x, dy and w start aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rms_norm_fwd(x2, w, eps):
    """Fused RMSNorm forward over rows: x2 [N, h], w [h] -> (out [N, h]
    in x's dtype, rstd [N] fp32).  CPU tensors take
    :func:`rms_norm_fwd_reference`; CUDA tensors launch the kernel, or
    raise on what it does not take: x or w not fp32, bf16 or fp16; a
    non-contiguous input."""
    _check("rms_norm_fwd", x2, w)
    if x2.device.type == "cpu":
        return rms_norm_fwd_reference(x2, w, eps)
    x2, w = _aligned(x2), _aligned(w)
    n, h = x2.shape
    out = torch.empty_like(x2)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    if n == 0:
        return out, rstd
    launch, _ = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream()
        rc = launch(x2.data_ptr(), w.data_ptr(), out.data_ptr(),
                    rstd.data_ptr(), n, h, float(eps),
                    _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype],
                    stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    rms_norm_fwd.launches += 1
    return out, rstd


def rms_norm_bwd(x2, w, rstd, dy2):
    """Fused RMSNorm backward (dx only) over rows; same routing and
    limits as :func:`rms_norm_fwd`.  rstd is fp32 [N], dy2 like x2."""
    _check("rms_norm_bwd", x2, w, rstd, dy2)
    if dy2.shape != x2.shape or rstd.shape != (x2.shape[0],):
        raise ValueError("rms_norm_bwd: dy / rstd do not match x")
    if x2.device.type == "cpu":
        return rms_norm_bwd_reference(x2, w, rstd, dy2)
    if dy2.dtype != x2.dtype or rstd.dtype != torch.float32:
        raise TypeError("rms_norm_bwd: dy must have x's dtype and rstd "
                        "must be float32")
    x2, w, dy2 = _aligned(x2), _aligned(w), _aligned(dy2)
    n, h = x2.shape
    dx = torch.empty_like(x2)
    if n == 0:
        return dx
    _, launch = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream()
        rc = launch(x2.data_ptr(), w.data_ptr(), rstd.data_ptr(),
                    dy2.data_ptr(), dx.data_ptr(), n, h,
                    _DTYPE_CODE[x2.dtype], _DTYPE_CODE[w.dtype],
                    stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    rms_norm_bwd.launches += 1
    return dx


rms_norm_fwd.launches = 0
rms_norm_bwd.launches = 0


class FusedRMSNorm(torch.autograd.Function):
    """out = fused RMSNorm of x over its last axis with weight w; the
    backward gives dx from :func:`rms_norm_bwd` and ``dw = sum_rows(dy *
    x * rstd)`` (fp32, cast to w's dtype), as ``_fused_b`` does."""

    @staticmethod
    def forward(ctx, x, w, eps):
        h = x.shape[-1]
        x2 = x.reshape(-1, h).contiguous()
        out, rstd = rms_norm_fwd(x2, w.contiguous(), eps)
        ctx.save_for_backward(x2, w, rstd)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        if torch.is_grad_enabled():
            refuse_create_graph("fused_rms_norm")
        x2, w, rstd = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).to(x2.dtype).contiguous()
        dx = rms_norm_bwd(x2, w.contiguous(), rstd, dy2)
        xhat = x2.float() * rstd[:, None]
        dw = (dy2.float() * xhat).sum(dim=0).to(w.dtype)
        return dx.reshape(dy.shape), dw, None


def fused_rms_norm(x, w, epsilon=1e-6):
    """Differentiable fused RMSNorm over the last axis (the counterpart
    of ``fused_rms_norm_fn``)."""
    return FusedRMSNorm.apply(x, w, float(epsilon))
