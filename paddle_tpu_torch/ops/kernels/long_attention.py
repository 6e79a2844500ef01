"""Attention, forward and backward, causal or not, with GQA and optional
fused RoPE: the hand-written CUDA kernels and their plain PyTorch
versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas_kernels/
long_attention.py``: ``_fwd_call`` (out in q's dtype, fp32 ``lse``
``[B, H, 1, S]``) and ``_bwd_call`` (dq in q's dtype; dk, dv summed in
fp32 and cast to k's / v's dtype), which the training path reaches for
causal S in [1024, 2048] through ``nn_ops.sdpa``; and serves the region
``paddle_tpu`` sends to the stock Pallas flash kernel
(``_flash_attention_tpu``: GQA, S > 2048, ``impl="flash"``, causal or
not).  The kernels are ``csrc/long_attention.cu``.

What bounds them on an H100: operations (the causal half of QK^T and
PV, 2·B·H·S²·D multiply-adds in the forward and five such products in
the backward).  The TPU kernel kept one head's whole K/V and a
``[block_q, S]`` score row in VMEM; an SM has 227 KB of shared memory,
so the CUDA kernels are flash-style: q tiles against streamed K/V tiles
with an fp32 online softmax, K tiles above the diagonal never loaded, a
backward that sums dK/dV in a pass over K tiles and dQ in a pass over q
tiles (no atomics, deterministic).

Two kernel families, one per case, chosen by dtype:

* bf16 without RoPE (the training path): tensor-core kernels
  (``wgmma`` + TMA).  Per block two consumer warpgroups (64 rows each,
  one ``wgmma`` m64 tile, 240 registers) and a producer warpgroup whose
  one thread streams K/V (forward, dQ pass) or q/dO (dK/dV pass) tiles
  by TMA into a two-stage ring guarded by mbarriers; S = Q·Kᵀ with both
  operands in shared memory; P (and dS) kept in registers as
  ``wgmma``'s A operand, as two bf16 terms hi + lo (rounded to bf16
  once, out and the gradients leave their tolerances:
  ``testing/attention_rounding.py``); a deterministic backward (delta,
  then a dK/dV pass over K tiles, one warpgroup summing dV and the other
  dK, and a dQ pass over q tiles; no atomics); GQA by indexing (q head h reads kv head h // (H / Hkv), the
  dK/dV block sums its group's q heads).  D = 128 (D = 256 raises), S a
  multiple of 128.
* fp32, and bf16 with fused RoPE: the first port's fp32-core kernels
  (exact in fp32; RoPE rotated in fp32 on load), D = 128, S a multiple
  of 64, the same heads for q and k/v: the wrapper repeats K/V for GQA
  and sums dK/dV over each group, as ``paddle_tpu``'s flash route
  repeats them.

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
WG_TILE = 128                  # wg::kFM / wg::kQM: bf16 S must be a multiple
_NEG = -2.3819763e38           # the TPU kernel's mask value


def smem_bytes() -> dict:
    """Dynamic shared memory a block of each kernel takes (mirrors the
    .cu).  fp32-core kernels: fp32 tiles with padded strides.
    Tensor-core kernels (``wg_*``): bf16 tiles of 128-byte swizzled rows,
    a two-stage ring, 8-byte mbarriers, 1 KB of slack to align the tiles
    to 1024 bytes."""
    tile, sq = TILE * (HEAD_DIM + 1), TILE * (TILE + 1)

    def t(rows):
        return rows * HEAD_DIM * 2

    stages = 2
    return {"fwd": 4 * (3 * tile + sq),
            "bwd_dkdv": 4 * (4 * tile + 2 * sq + 2 * TILE),
            "bwd_dq": 4 * (4 * tile + sq + 2 * TILE),
            "wg_fwd": 1024 + t(128) + 2 * stages * t(128)
            + 8 * (1 + 4 * stages),
            "wg_dkdv": 1024 + 2 * t(64) + stages * (2 * t(64) + 2 * 64 * 4)
            + 8 * (1 + 2 * stages),
            "wg_dq": 1024 + 2 * t(128) + 2 * stages * t(64)
            + 8 * (1 + 2 * stages)}


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
        fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                        + [ctypes.c_float] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                        + [ctypes.c_float] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(name, q, k, others):
    """Shapes: q (and others) [B, H, S, D], k and v [B, Hkv, S, D] with H a
    multiple of Hkv.  Returns True when the tensor-core kernels take the
    call (CUDA, bf16, no RoPE)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: expected [B, H, S, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, D) or Hkv == 0 or H % Hkv:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need [B, Hkv, S, D], H % Hkv "
                         f"== 0)")
    for t in (k, *others):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.device.type == "cpu":
        return False
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported by the "
                        "kernel")
    if D != HEAD_DIM:
        raise ValueError(f"{name}: the kernels take D == {HEAD_DIM}, got "
                         f"D={D} (D = 256 is not instantiated: ROADMAP.md "
                         "Queue 3)")
    for t in (q, k, *others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: a tensor is not contiguous")
    return q.dtype == torch.bfloat16


def _tile_ok(name, S, tile):
    if S % tile:
        raise ValueError(f"{name}: this kernel takes S a multiple of "
                         f"{tile}; got S={S}")


def _repeat_kv(k, H):
    """k/v ``[B, Hkv, S, D]`` repeated to H heads (q head h reads kv head
    h // (H / Hkv)), as ``paddle_tpu``'s flash route repeats them."""
    G = H // k.shape[1]
    return k if G == 1 else k.repeat_interleave(G, dim=1)


def _sum_groups(dk, Hkv, dtype):
    """dK of the repeated heads summed over each group in fp32, cast to
    ``dtype``."""
    B, H, S, D = dk.shape
    if H == Hkv:
        return dk.to(dtype)
    return dk.float().reshape(B, Hkv, H // Hkv, S, D).sum(2).to(dtype)


def attention_fwd_plain(q, k, v, scale, causal=True, rope_base=None):
    """The plain version of :func:`attention_fwd` with GQA: k/v
    ``[B, Hkv, S, D]`` repeated to q's H heads, then
    :func:`attention_fwd_reference`."""
    H = q.shape[1]
    return attention_fwd_reference(q, _repeat_kv(k, H), _repeat_kv(v, H),
                                   scale, causal, rope_base)


def attention_bwd_plain(q, k, v, out, lse, g, scale, causal=True,
                        rope_base=None):
    """The plain version of :func:`attention_bwd` with GQA:
    :func:`attention_bwd_reference` over k/v repeated to H heads (its
    inputs widened first, so its gradients stay fp32), dk/dv summed over
    each kv head's q heads in fp32, then each gradient cast once to its
    input's dtype."""
    H, Hkv = q.shape[1], k.shape[1]
    dq, dk, dv = attention_bwd_reference(
        q.float(), _repeat_kv(k, H).float(), _repeat_kv(v, H).float(), out,
        lse, g, scale, causal, rope_base)
    return (dq.to(q.dtype), _sum_groups(dk, Hkv, k.dtype),
            _sum_groups(dv, Hkv, v.dtype))


def _tables(q, rope_base):
    if rope_base is None:
        return None, None, 0
    S, D = q.shape[-2:]
    cos, sin = rope_tables(S, D, rope_base, q.device)
    return cos.contiguous(), sin.contiguous(), 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def attention_fwd(q, k, v, scale, causal=True, rope_base=None):
    """Attention forward over q [B, H, S, D] and k/v [B, Hkv, S, D] (H a
    multiple of Hkv) -> (out in q's dtype, lse [B, H, 1, S] fp32).  CPU
    tensors take :func:`attention_fwd_plain`; CUDA tensors launch a
    kernel, or raise on what it does not take: dtypes other than f32 or
    bf16 (the same for q, k, v), D != 128, S not a multiple of 128 (bf16
    without RoPE) or 64 (otherwise), a non-contiguous input."""
    if v.shape != k.shape:
        raise ValueError("attention_fwd: k and v shapes differ")
    wgmma = _check("attention_fwd", q, k, (v,)) and rope_base is None
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, scale, causal, rope_base)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("attention_fwd: q, k, v dtypes differ")
    B, H, S, D = q.shape
    _tile_ok("attention_fwd", S, WG_TILE if wgmma else TILE)
    if not wgmma:
        k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    Hkv = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty(B, H, 1, S, dtype=torch.float32, device=q.device)
    launch, _ = _lib()
    with torch.cuda.device(q.device):
        cos, sin, use_rope = _tables(q, rope_base)
        stream = torch.cuda.current_stream()
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(cos),
                    _ptr(sin), out.data_ptr(), lse.data_ptr(), B, H, Hkv,
                    S, D, float(scale), int(bool(causal)), use_rope,
                    _DTYPE_CODE[q.dtype], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    attention_fwd.launches += 1
    return out, lse


def attention_bwd(q, k, v, out, lse, g, scale, causal=True,
                  rope_base=None):
    """Attention backward -> (dq, dk, dv) in q's, k's and v's dtype, dk/dv
    ``[B, Hkv, S, D]`` summed over each kv head's q heads; the kernels
    form ``delta = rowsum(g * out)`` from the saved output.  Same routing
    and limits as :func:`attention_fwd`."""
    if v.shape != k.shape or out.shape != q.shape or g.shape != q.shape:
        raise ValueError("attention_bwd: shapes of q, k, v, out, g do not "
                         "fit")
    wgmma = _check("attention_bwd", q, k, (v, out, lse, g)) \
        and rope_base is None
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, lse, g, scale, causal,
                                   rope_base)
    if any(t.dtype != q.dtype for t in (k, v, out, g)) \
            or lse.dtype != torch.float32:
        raise TypeError("attention_bwd: q, k, v, out, g must share a "
                        "dtype and lse must be float32")
    _tile_ok("attention_bwd", S, WG_TILE if wgmma else TILE)
    qq, kk, vv, oo, gg = q, k, v, out, g
    if not wgmma and Hkv != H:
        # the fp32-core kernel over K/V repeated to H heads; a bf16 call
        # runs in fp32 (that kernel widens on load, so the arithmetic is
        # the same) so each group sum is rounded once, as in the plain
        # version
        qq, oo, gg = q.float(), out.float(), g.float()
        kk, vv = _repeat_kv(k.float(), H), _repeat_kv(v.float(), H)
    dq, dk, dv = (torch.empty_like(qq), torch.empty_like(kk),
                  torch.empty_like(vv))
    delta = torch.empty(B * H * S, dtype=torch.float32, device=q.device)
    _, launch = _lib()
    with torch.cuda.device(q.device):
        cos, sin, use_rope = _tables(q, rope_base)
        stream = torch.cuda.current_stream()
        rc = launch(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                    oo.data_ptr(), gg.data_ptr(), _ptr(cos), _ptr(sin),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), B, H, kk.shape[1], S, D,
                    float(scale), int(bool(causal)), use_rope,
                    _DTYPE_CODE[qq.dtype], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    attention_bwd.launches += 1
    return (dq.to(q.dtype), _sum_groups(dk, Hkv, k.dtype),
            _sum_groups(dv, Hkv, v.dtype))


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
    """[B, H, S, D] attention over k/v [B, Hkv, S, D] (GQA when Hkv < H),
    causal by default, differentiable, with fused RoPE when ``rope_base``
    is set (e.g. 10000.0).  ``scale`` defaults to ``1/sqrt(D)``.  The
    counterpart of ``paddle_tpu``'s ``long_attention`` (and, through
    ``sdpa``'s flash route, of its ``_flash_attention_tpu``); its
    ``block_q`` is a TPU tiling choice that the CUDA kernels do not
    need."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return LongAttention.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), scale, bool(causal),
                               rope_base)
