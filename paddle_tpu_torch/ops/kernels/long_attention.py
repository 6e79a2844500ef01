"""Causal attention, forward and backward, with optional fused RoPE: the
hand-written CUDA kernels and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas_kernels/
long_attention.py``: ``_fwd_call`` (out in q's dtype, fp32 ``lse``
``[B, H, 1, S]``) and ``_bwd_call`` (dq in q's dtype; dk, dv summed in
fp32 and cast to k's / v's dtype), which the training path reaches for
causal S in [1024, 2048] through ``nn_ops.sdpa``.  The kernels are
``csrc/long_attention.cu``.

What bounds them on an H100: operations (the causal half of QK^T and
PV, 2·B·H·S²·D multiply-adds in the forward and five such products in
the backward).  The TPU kernel kept one head's whole K/V and a
``[block_q, S]`` score row in VMEM; an SM has 227 KB of shared memory,
so the CUDA kernel is flash-style instead: 64-row q tiles against 64-row
K/V tiles with an fp32 online softmax, K tiles above the diagonal never
loaded.  The backward sums dK/dV over q tiles in a separate pass over K
tiles (no atomics, deterministic), then forms dQ in a pass over q tiles.
This first version runs its products on the fp32 cores (bf16 inputs are
widened on load, as on the TPU); tensor cores come later.

Routing: CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise.  ``attention_fwd.launches`` / ``attention_bwd.launches``
count kernel launches only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 128                 # kD in the .cu
TILE = 64                      # kB in the .cu: S must be a multiple
_NEG = -2.3819763e38           # the TPU kernel's mask value


def smem_bytes() -> dict:
    """Dynamic shared memory a block of each kernel takes (mirrors the
    .cu: fp32 tiles with padded strides)."""
    tile, sq = TILE * (HEAD_DIM + 1), TILE * (TILE + 1)
    return {"fwd": 4 * (3 * tile + sq),
            "bwd_dkdv": 4 * (4 * tile + 2 * sq + 2 * TILE),
            "bwd_dq": 4 * (4 * tile + sq + 2 * TILE)}


def rope_tables(S, D, base, device):
    """fp32 ``(cos, sin)``, each ``[S, D/2]``, for half-split RoPE with
    angle ``pos * base ** (-2 i / D)`` — the same arithmetic as the TPU
    module's ``_rope_tables``."""
    inv = 1.0 / (float(base) ** (torch.arange(
        0, D // 2, dtype=torch.float32, device=device) * 2.0 / D))
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin, sign=1.0):
    """Rotate half-split pairs of the last axis; ``sign=-1`` applies the
    transposed (inverse) rotation."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - sign * x2 * sin,
                      sign * x1 * sin + x2 * cos], dim=-1)


def _scores(q, k, v, scale, causal, rope_base):
    """fp32 (q, k, v, masked scores, cos, sin) as the TPU kernel forms
    them: inputs widened, q/k rotated, ``s = (q k^T) * scale``."""
    S, D = q.shape[-2:]
    qf, kf, vf = q.float(), k.float(), v.float()
    cos = sin = None
    if rope_base is not None:
        cos, sin = rope_tables(S, D, rope_base, q.device)
        qf, kf = _rope(qf, cos, sin), _rope(kf, cos, sin)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.tensor(_NEG, device=q.device))
    return qf, kf, vf, s, cos, sin


def attention_fwd_reference(q, k, v, scale, causal=True, rope_base=None):
    """Plain version of ``_fwd_call``: q/k/v [B, H, S, D] ->
    (out [B, H, S, D] in q's dtype, lse [B, H, 1, S] fp32)."""
    _, _, vf, s, _, _ = _scores(q, k, v, scale, causal, rope_base)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e / l, vf).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return out, lse[:, :, None, :]


def attention_bwd_reference(q, k, v, out, lse, g, scale, causal=True,
                            rope_base=None):
    """Plain version of ``_bwd_call`` plus the cast of ``_vjp_bwd``:
    (dq in q's dtype, dk in k's dtype, dv in v's dtype), with
    ``ds = p * (dp - delta) * scale`` and ``delta = rowsum(g * out)``
    over the saved output, as the CUDA kernel forms it.  The TPU kernel
    takes ``delta = rowsum(dp * p)``: equal in exact arithmetic, but a
    bf16 ``out`` moves it by about one bf16 rounding of ``out``."""
    qf, kf, vf, s, cos, sin = _scores(q, k, v, scale, causal, rope_base)
    p = torch.exp(s - lse[:, :, 0, :, None])
    gf = g.float()
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    if rope_base is not None:
        dq, dk = _rope(dq, cos, sin, -1.0), _rope(dk, cos, sin, -1.0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    lib = _build.load("long_attention")
    fwd, bwd = lib.long_attention_fwd_launch, lib.long_attention_bwd_launch
    if fwd.argtypes is None:
        fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                        + [ctypes.c_float] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                        + [ctypes.c_float] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(name, q, *others):
    if q.dim() != 4:
        raise ValueError(f"{name}: expected [B, H, S, D], got "
                         f"{tuple(q.shape)}")
    for t in others:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.device.type == "cpu":
        return
    B, H, S, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported by the "
                        "kernel")
    if D != HEAD_DIM or S % TILE:
        raise ValueError(f"{name}: the kernel takes D == {HEAD_DIM} and S "
                         f"a multiple of {TILE}; got S={S}, D={D}")
    for t in (q, *others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: a tensor is not contiguous")


def _tables(q, rope_base):
    if rope_base is None:
        return None, None, 0
    S, D = q.shape[-2:]
    cos, sin = rope_tables(S, D, rope_base, q.device)
    return cos.contiguous(), sin.contiguous(), 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def attention_fwd(q, k, v, scale, causal=True, rope_base=None):
    """Attention forward over q/k/v [B, H, S, D] (the same heads for all
    three) -> (out in q's dtype, lse [B, H, 1, S] fp32).  CPU tensors take
    :func:`attention_fwd_reference`; CUDA tensors launch the kernel, or
    raise on what it does not take: dtypes other than f32 or bf16 (the
    same for q, k, v), D != 128, S not a multiple of 64, a non-contiguous
    input."""
    _check("attention_fwd", q, k, v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention_fwd: q, k and v shapes differ")
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, scale, causal, rope_base)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("attention_fwd: q, k, v dtypes differ")
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, 1, S, dtype=torch.float32, device=q.device)
    launch, _ = _lib()
    with torch.cuda.device(q.device):
        cos, sin, use_rope = _tables(q, rope_base)
        stream = torch.cuda.current_stream()
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(cos),
                    _ptr(sin), out.data_ptr(), lse.data_ptr(), B * H, S, D,
                    float(scale), int(bool(causal)), use_rope,
                    _DTYPE_CODE[q.dtype], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    attention_fwd.launches += 1
    return out, lse


def attention_bwd(q, k, v, out, lse, g, scale, causal=True,
                  rope_base=None):
    """Attention backward -> (dq, dk, dv) in q's, k's and v's dtype; the
    kernel forms ``delta = rowsum(g * out)`` from the saved output.  Same
    routing and limits as :func:`attention_fwd`."""
    _check("attention_bwd", q, k, v, out, lse, g)
    if any(t.shape != q.shape for t in (k, v, out, g)):
        raise ValueError("attention_bwd: shapes of q, k, v, out, g differ")
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, out, lse, g, scale, causal,
                                       rope_base)
    if any(t.dtype != q.dtype for t in (k, v, out, g)) \
            or lse.dtype != torch.float32:
        raise TypeError("attention_bwd: q, k, v, out, g must share a "
                        "dtype and lse must be float32")
    B, H, S, D = q.shape
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    delta = torch.empty(B * H * S, dtype=torch.float32, device=q.device)
    _, launch = _lib()
    with torch.cuda.device(q.device):
        cos, sin, use_rope = _tables(q, rope_base)
        stream = torch.cuda.current_stream()
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), g.data_ptr(), _ptr(cos), _ptr(sin),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B * H, S, D,
                    float(scale), int(bool(causal)), use_rope,
                    _DTYPE_CODE[q.dtype], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_fwd.launches = 0
attention_bwd.launches = 0


class LongAttention(torch.autograd.Function):
    """``long_attention``'s custom VJP: saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, rope_base):
        out, lse = attention_fwd(q, k, v, scale, causal, rope_base)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (scale, causal, rope_base)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse,
                                   g.to(q.dtype).contiguous(), *ctx.cfg)
        return dq, dk, dv, None, None, None


def long_attention(q, k, v, scale=None, causal=True, rope_base=None):
    """[B, H, S, D] attention (causal by default), differentiable, with
    fused RoPE when ``rope_base`` is set (e.g. 10000.0).  ``scale``
    defaults to ``1/sqrt(D)``.  The counterpart of ``paddle_tpu``'s
    ``long_attention``; its ``block_q`` is a TPU tiling choice that the
    CUDA kernel does not need (it tiles by 64 rows)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return LongAttention.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), scale, bool(causal),
                               rope_base)
