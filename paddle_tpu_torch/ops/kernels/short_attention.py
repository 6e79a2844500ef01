"""Short-sequence attention, forward and backward, with in-kernel hash
dropout: the hand-written CUDA kernels and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas_kernels/
short_attention.py``: ``_fwd_call_impl`` (out in q's dtype, fp32 ``lse``
``[B, H, 1, S]``) and ``_bwd_call`` (dq, dk, dv in q's dtype), which
``nn_ops.sdpa`` reaches for Sq == Sk <= 1024 with S % 128 == 0,
D in {64, 128}, no mask and the same heads for q and k/v — every layer of
BERT, and causal Llama training below S = 1024.  The kernels are
``csrc/short_attention.cu``.

Dropout is the TPU kernel's: a keep mask from a murmur3-style hash of
(seed, ``b·H + h``, ``row·S + col``) in uint32 arithmetic, applied to the
normalised probabilities, so the backward regenerates the same mask
instead of storing it.  :func:`keep_mask` reproduces ``_keep_mask`` bit
for bit.  The seed is an int32 ``[1]`` tensor on the inputs' device (the
TPU kernel's scalar-prefetch ``seed_ref``): ``nn_ops.sdpa`` draws it from
the caller's generator on that device and the kernel reads it from device
memory, so no host sync is needed per layer; the autograd function saves
it for the backward.

What bounds the kernels on an H100: at BERT-base's shape, bytes (q, k, v,
out once each) ahead of the two [S, S, D] products forward and five
backward, with the mask's integer hash besides.  The TPU kernel kept one
head's whole [S, S] score matrix in VMEM; S = 1024 fp32 scores are 4 MB
and an SM has 227 KB of shared memory, so the CUDA kernels are
flash-style, with an fp32 online softmax whose sum ``l`` takes the
undropped exponentials, the mask and ``1/(1-p)`` multiplying only the
numerator (equal to the TPU's ``p = e/l`` followed by the mask).  bf16
inputs run on the tensor cores (``wgmma`` fed by TMA, two consumer
warpgroups and a producer; the dropped numerator and ``ds`` enter the
products as bf16 hi + lo); fp32 inputs on the fp32 cores.  The dtype
picks one family, with no fallback between them.  The backward sums
dK/dV in a pass over K tiles and dQ in a pass over q tiles (no atomics,
deterministic).  Its ``delta = rowsum(g · out)`` reads the forward's
output in fp32, which the forward keeps beside a bf16 ``out``: from the
bf16 output it would miss the TPU's ``rowsum(dp · p)`` by a rounding of
``out``, enough to put early causal rows of dq outside the bf16
tolerance.

Routing: CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise.  ``short_attention_fwd.launches`` /
``short_attention_bwd.launches`` count kernel launches only.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..registry import refuse_create_graph
from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)          # the .cu's instantiations
TILE = 128                     # S must be a multiple (the .cu's tiles)
_NEG = -1e30                   # the TPU kernel's causal mask value
_U32 = 0xFFFFFFFF


# -- the dropout mask -----------------------------------------------------------

def dropout_constants(dropout_p: float):
    """(threshold, inverse keep) as the TPU kernel forms them: the uint32
    threshold ``min(int(keep * 2^32), 2^32 - 1)`` in Python double, and
    ``1 / (1 - p)`` rounded to fp32 where it meets the fp32 probabilities
    (a weakly typed scalar in JAX)."""
    keep = 1.0 - float(dropout_p)
    threshold = min(int(keep * 4294967296.0), 4294967295)
    return threshold, float(np.float32(1.0 / keep))


def _mul_u32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a uint32
    constant, without signed overflow: ``c`` split into 16-bit halves
    keeps every product under 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def keep_mask(seed, B: int, H: int, S: int, keep_prob: float,
              device=None):
    """The keep mask ``[B, H, S, S]`` (bool) of ``_keep_mask``, bit for
    bit: per (b, h) the offset ``seed + (b·H + h)·747796405`` wrapped to
    32 bits, plus the element index ``row·S + col``, through the murmur3
    finalizer, kept where the hash is below ``min(int(keep·2^32),
    2^32 - 1)``.  ``seed`` is an int or an int32 tensor of one element;
    the arithmetic runs in int64 on ``device`` (default: the seed's),
    every product reduced mod 2^32 as uint32 arithmetic would."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        s = seed.reshape(-1)[:1].to(device=device, dtype=torch.int64)
    else:
        s = torch.tensor([int(seed)], dtype=torch.int64, device=device)
    i64 = dict(dtype=torch.int64, device=s.device)
    bh = torch.arange(B * H, **i64).reshape(B, H, 1, 1)
    per = ((s & _U32) + bh * 747796405) & _U32
    idx = (torch.arange(S, **i64)[:, None] * S
           + torch.arange(S, **i64)[None, :])
    x = (idx + per) & _U32
    x = _mul_u32(x, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul_u32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    threshold = min(int(keep_prob * 4294967296.0), 4294967295)
    return x < threshold


# -- plain versions ---------------------------------------------------------------

def _scores(q, k, scale, causal):
    """fp32 scores ``(q k^T) * scale`` over the widened inputs, causal
    pairs above the diagonal set to the TPU kernel's -1e30."""
    S = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.tensor(_NEG, device=q.device))
    return s


def _dropped(x, seed, dropout_p, B, H, S):
    """``x`` with the keep mask applied and the kept entries times the
    fp32 ``1/(1-p)``, or ``x`` when ``dropout_p`` is 0."""
    if dropout_p <= 0.0:
        return x
    _, inv = dropout_constants(dropout_p)
    keep = keep_mask(seed, B, H, S, 1.0 - dropout_p, device=x.device)
    return torch.where(keep, x * inv, torch.zeros((), device=x.device))


def short_attention_fwd_reference(q, k, v, seed, scale, dropout_p=0.0,
                                  causal=False):
    """Plain version of ``_fwd_call_impl``: q/k/v [B, H, S, D] -> (out in
    q's dtype, lse [B, H, 1, S] fp32, the output before its cast in fp32),
    as the TPU kernel computes them: ``p = e / l``, then the mask and
    ``1/(1-p)``, then ``p @ v``."""
    B, H, S, _ = q.shape
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = _dropped(e / l, seed, dropout_p, B, H, S)
    out32 = torch.matmul(p, v.float())
    lse = (m + torch.log(l))[..., 0][:, :, None, :]
    return out32.to(q.dtype), lse, out32


def short_attention_bwd_reference(q, k, v, out, lse, g, seed, scale,
                                  dropout_p=0.0, causal=False):
    """Plain version of ``_bwd_call``: (dq, dk, dv) in q's dtype, with
    ``p = exp(s - lse)``, the regenerated mask on ``p`` and on
    ``dp = g v^T``, ``ds = p (dp - delta)``, ``dq = ds k · scale``,
    ``dk = ds^T q · scale``, ``dv = pd^T g``.  ``out`` is the forward's
    output in fp32 (its third result), and ``delta = rowsum(g · out)`` as the
    CUDA kernel forms it; the TPU kernel takes ``rowsum(dp · p)``, equal
    in exact arithmetic (with dropout too)."""
    B, H, S, _ = q.shape
    s = _scores(q, k, scale, causal)
    p = torch.exp(s - lse[:, :, 0, :, None])
    gf = g.float()
    pd = _dropped(p, seed, dropout_p, B, H, S)
    dv = torch.matmul(pd.transpose(-1, -2), gf)
    dp = _dropped(torch.matmul(gf, v.float().transpose(-1, -2)), seed,
                  dropout_p, B, H, S)
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# -- the kernels ------------------------------------------------------------------

def _lib():
    lib = _build.load("short_attention")
    fwd, bwd = lib.short_attention_fwd_launch, lib.short_attention_bwd_launch
    if fwd.argtypes is None:
        fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float]
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float]
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(name, q, seed, dropout_p, *others):
    if q.dim() != 4:
        raise ValueError(f"{name}: expected [B, H, S, D], got "
                         f"{tuple(q.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"{name}: dropout_p must be in [0, 1), got "
                         f"{dropout_p}")
    for t in others:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{q.device}")
    if dropout_p > 0.0 and (not isinstance(seed, torch.Tensor)
                            or seed.numel() != 1):
        raise ValueError(f"{name}: dropout needs an int32 seed tensor of "
                         "one element")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.device.type == "cpu":
        return
    B, H, S, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported by the "
                        "kernel")
    if D not in HEAD_DIMS or S % TILE:
        raise ValueError(f"{name}: the kernel takes D in {HEAD_DIMS} and "
                         f"S a multiple of {TILE}; got S={S}, D={D}")
    for t in (q, *others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: a tensor is not contiguous")
    if dropout_p > 0.0 and (seed.device != q.device
                            or seed.dtype != torch.int32):
        raise ValueError(f"{name}: the seed must be an int32 tensor on "
                         f"{q.device}")


def _dropout_args(seed, dropout_p):
    if dropout_p <= 0.0:
        return None, 0, 1.0
    threshold, inv = dropout_constants(dropout_p)
    return seed.data_ptr(), threshold, inv


def short_attention_fwd(q, k, v, seed, scale, dropout_p=0.0, causal=False):
    """Attention forward over q/k/v [B, H, S, D] (the same heads for all
    three) -> (out in q's dtype, lse [B, H, 1, S] fp32, the output in fp32
    for the backward's delta: ``out`` itself for fp32 inputs; for bf16 the
    kernel writes both in one pass).  ``seed`` is an int32 tensor of one
    element on q's device, or None when ``dropout_p`` is 0.  CPU
    tensors take :func:`short_attention_fwd_reference`; CUDA tensors
    launch the kernel, or raise on what it does not take: dtypes other
    than f32 or bf16 (the same for q, k, v), D not 64 or 128, S not a
    multiple of :data:`TILE` (128), a non-contiguous input."""
    dropout_p = float(dropout_p)
    _check("short_attention_fwd", q, seed, dropout_p, k, v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("short_attention_fwd: q, k and v shapes differ")
    if q.device.type == "cpu":
        return short_attention_fwd_reference(q, k, v, seed, scale,
                                             dropout_p, causal)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("short_attention_fwd: q, k, v dtypes differ")
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    out32 = out if q.dtype == torch.float32 \
        else torch.empty_like(q, dtype=torch.float32)
    lse = torch.empty(B, H, 1, S, dtype=torch.float32, device=q.device)
    launch, _ = _lib()
    seed_ptr, threshold, inv = _dropout_args(seed, dropout_p)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream()
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), seed_ptr,
                    out.data_ptr(),
                    None if out32 is out else out32.data_ptr(),
                    lse.data_ptr(), B * H, S, D,
                    float(scale), threshold, inv, int(bool(causal)),
                    _DTYPE_CODE[q.dtype], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"short_attention_fwd kernel launch failed: "
                           f"CUDA error {rc}")
    short_attention_fwd.launches += 1
    return out, lse, out32


def short_attention_bwd(q, k, v, out, lse, g, seed, scale, dropout_p=0.0,
                        causal=False):
    """Attention backward -> (dq, dk, dv) in q's dtype, regenerating the
    forward's mask from ``seed``.  ``out`` is the forward's output in fp32
    (its third result), from which the kernel forms ``delta = rowsum(g ·
    out)``.  Same routing and limits as :func:`short_attention_fwd`."""
    dropout_p = float(dropout_p)
    _check("short_attention_bwd", q, seed, dropout_p, k, v, out, lse, g)
    if any(t.shape != q.shape for t in (k, v, out, g)):
        raise ValueError("short_attention_bwd: shapes of q, k, v, out, g "
                         "differ")
    if q.device.type == "cpu":
        return short_attention_bwd_reference(q, k, v, out, lse, g, seed,
                                             scale, dropout_p, causal)
    if any(t.dtype != q.dtype for t in (k, v, g)) \
            or out.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError("short_attention_bwd: q, k, v, g must share a "
                        "dtype, and out and lse must be float32")
    B, H, S, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(B * H * S, dtype=torch.float32, device=q.device)
    _, launch = _lib()
    seed_ptr, threshold, inv = _dropout_args(seed, dropout_p)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream()
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), g.data_ptr(), lse.data_ptr(), seed_ptr,
                    delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B * H, S, D, float(scale), threshold,
                    inv, int(bool(causal)), _DTYPE_CODE[q.dtype],
                    stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"short_attention_bwd kernel launch failed: "
                           f"CUDA error {rc}")
    short_attention_bwd.launches += 1
    return dq, dk, dv


short_attention_fwd.launches = 0
short_attention_bwd.launches = 0


class ShortAttention(torch.autograd.Function):
    """``short_attention``'s custom VJP: saves q, k, v, the fp32 output,
    lse and the seed (None without dropout), so the backward regenerates
    the forward's mask."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, dropout_p, causal):
        out, lse, out32 = short_attention_fwd(q, k, v, seed, scale,
                                              dropout_p, causal)
        ctx.save_for_backward(q, k, v, out32, lse, seed)
        ctx.cfg = (scale, dropout_p, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            refuse_create_graph("short_attention")
        q, k, v, out, lse, seed = ctx.saved_tensors
        dq, dk, dv = short_attention_bwd(q, k, v, out, lse,
                                         g.to(q.dtype).contiguous(), seed,
                                         *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def short_attention(q, k, v, seed=None, scale=None, dropout_p=0.0,
                    causal=False):
    """[B, H, S, D] attention, differentiable, with the TPU kernel's hash
    dropout at rate ``dropout_p`` drawn from ``seed`` (an int, or an
    int32 tensor of one element on q's device; read only when
    ``dropout_p`` > 0, so without dropout nothing is copied to the
    device).  ``scale`` defaults to ``1/sqrt(D)``.  The counterpart of
    ``paddle_tpu``'s ``short_attention``."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    dropout_p = float(dropout_p)
    if dropout_p <= 0.0:
        seed = None
    elif isinstance(seed, torch.Tensor):
        seed = seed.reshape(1)
    elif seed is not None:
        seed = torch.tensor([int(seed)], dtype=torch.int32,
                            device=q.device)
    return ShortAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), seed, scale, dropout_p,
                                bool(causal))
