"""Grouped expert FFN: the hand-written CUDA kernels, their plain PyTorch
versions, the batched-einsum route and the routing between them.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas_kernels/
grouped_gemm.py``: ``_pallas_ffn`` (kernel 10)

    out[e] = act(x[e] @ w1[e] + b1[e]) @ w2[e] + b2[e]

for every expert over sort-dispatched buckets ``x [E, C, H]`` (w1
``[E, H, F]``, b1 ``[E, 1, F]``, w2 ``[E, F, H]``, b2 ``[E, 1, H]``), with
x and the weights widened to f32, the hidden ``h`` kept in f32 and never
written to device memory, and one cast of the f32 sum to x's dtype; and
``_pallas_ffn_q`` (kernel 11), the same over int8 weights with per-output
channel f32 scales ``s1 [E, 1, F]`` and ``s2 [E, 1, H]``:
``h = act((x @ q1) * s1 + b1)``, ``out = (h @ q2) * s2 + b2``.  The
kernels are ``csrc/grouped_gemm.cu``.

What bounds them on an H100: ``4 * E * C * H * F`` flops at the bf16
tensor-core rate at MoE training sizes; the weight bytes at a decode-sized
C (int8: a quarter of f32's).  The TPU kernel accumulated a ``[bc, H]``
f32 row block in VMEM across F blocks; at bc = 64 and H = 2048 that is
512 KB, and an SM has 227 KB of shared memory.  So the CUDA kernel gives
a block 16 rows and keeps their ``[16, 2048]`` f32 sum in registers
(128 a thread), streams w1 and w2 panels through a 4-stage ``cp.async``
ring, and multiplies with ``mma.sync`` bf16 tiles: the first product
exactly (bf16 x bf16 products are exact in f32), the second from ``h``
split into two bf16 terms (hi + lo), so ``h`` is never rounded to bf16
once.  f32 x takes f32 FMA tiles.  Int8 panels are widened to bf16 in
shared memory (exact), s1 scales the f32 first product before b1 and the
activation, s2 each F block's contribution before it is added, as
``_qkernel`` does.  H above 2048 is cut into 2048-column slices, each
recomputing h; a C too small to fill the card (decode) splits the F
blocks over blocks, whose f32 partial sums a second kernel adds in a
fixed order (no atomics).  On an H100 the 16-row blocks move each weight
byte through shared memory for only 16 rows of products, which bounds
the kernel well before the tensor cores (the .cu's note has the numbers).

Routing (:func:`grouped_ffn`, as ``grouped_gemm.grouped_ffn`` routes):
``impl`` / ``PT_GROUPED_GEMM`` in {auto, pallas, einsum}.  ``auto`` takes
the kernel for CUDA tensors when H and F are multiples of 128, and
:func:`einsum_ffn` otherwise, and always on the CPU (as JAX does off the
TPU).  ``pallas`` forces the kernel route: CUDA tensors launch the
kernel, CPU tensors take its plain version.  The kernel route's VJP is
``_fused_b``'s: plain f32 matmuls (:class:`GroupedFFN`).
``grouped_ffn.launches`` and ``grouped_ffn_q.launches`` count launches
of kernels 10 and 11.  The TPU's tile autotuning (``blocks()``) has no
counterpart: the CUDA kernel's tiles are its own, for any C, H and F.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build
from ..nn_ops import einsum
from ..quant import dequantize, is_quantized

#: the .cu's activation codes
ACTIVATIONS = {"gelu": 0, "relu": 1, "silu": 2, "sigmoid": 3, "tanh": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 16        # kRows in the .cu: rows of x per block
COLS = 2048      # kCols: output columns per block
F_BLOCK = 64     # kFB: the F block


def _gelu(x):
    """Exact GELU as ``jax.nn.gelu(approximate=False)`` forms it:
    ``0.5 * x * erfc(-x * sqrt(0.5))`` with sqrt(0.5) in x's dtype, each
    op rounded to x's dtype (bit for bit JAX's in bf16 on the CPU)."""
    sqrt_half = float(torch.tensor(math.sqrt(0.5), dtype=x.dtype))
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def _silu(x):
    """``x * sigmoid(x)``, rounded after each op as ``jax.nn.silu``."""
    return x * torch.sigmoid(x)


def _act_fn(name):
    """The activation of ``grouped_gemm._act_fn``: ``gelu`` in its exact
    form (``ops.gelu``), else the ``jax.nn`` function of that name."""
    fns = {"gelu": _gelu, "relu": torch.relu, "silu": _silu,
           "sigmoid": torch.sigmoid, "tanh": torch.tanh}
    if name not in fns:
        raise ValueError(f"grouped_ffn: activation {name!r} not supported "
                         f"(one of {sorted(fns)})")
    return fns[name]


# -- plain versions -------------------------------------------------------------

def grouped_ffn_reference(x, w1, b1, w2, b2, activation="gelu"):
    """Kernel 10's math: f32 throughout, one cast to x's dtype."""
    act = _act_fn(activation)
    f = torch.float32
    h = act(torch.bmm(x.to(f), w1.to(f)) + b1.to(f))
    return (torch.bmm(h, w2.to(f)) + b2.to(f)).to(x.dtype)


def grouped_ffn_q_reference(x, q1, s1, b1, q2, s2, b2, activation="gelu"):
    """Kernel 11's math: int8 weights widened to f32, s1 on the first
    product before b1, s2 on the second before b2; f32 throughout, one
    cast to x's dtype."""
    act = _act_fn(activation)
    f = torch.float32
    h = act(torch.bmm(x.to(f), q1.to(f)) * s1.to(f) + b1.to(f))
    return (torch.bmm(h, q2.to(f)) * s2.to(f) + b2.to(f)).to(x.dtype)


def einsum_ffn(x, w1, b1, w2, b2, activation="gelu"):
    """The batched-einsum route (``grouped_gemm.einsum_ffn``), computed in
    the operands' dtype: for bf16 inputs ``h`` is rounded to bf16, which
    the kernels never do.  A different function from the kernels'."""
    h = _act_fn(activation)(einsum("ech,ehf->ecf", x, w1) + b1)
    return einsum("ecf,efh->ech", h, w2) + b2


# -- the kernels ----------------------------------------------------------------

def _lib():
    lib = _build.load("grouped_gemm")
    fn = lib.grouped_ffn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, w1, b1, w2, b2, name):
    for n, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.device != x.device:
            raise ValueError(f"{name}: {n} is on {t.device}, x on "
                             f"{x.device}")
    if x.dim() != 3 or w1.dim() != 3 or w2.dim() != 3:
        raise ValueError(f"{name}: expected x [E, C, H], w1 [E, H, F] and "
                         "w2 [E, F, H]")
    E, C, H = x.shape
    F = w1.shape[-1]
    if (tuple(w1.shape) != (E, H, F) or tuple(w2.shape) != (E, F, H)
            or b1.numel() != E * F or b2.numel() != E * H):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
            f"{tuple(b1.shape)}, w2 {tuple(w2.shape)} and b2 "
            f"{tuple(b2.shape)} do not match")
    return E, C, H, F


def _splits(E, C, H, F, device):
    """F-block splits: 1 when the (row block, expert, column slice)
    blocks fill the SMs, else enough to fill them (at most one F block
    each)."""
    base = -(-C // ROWS) * E * -(-H // COLS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-F // F_BLOCK), sms // base))


def _launch(x, w1, s1, b1, w2, s2, b2, activation, name):
    """Launch the kernel on CUDA tensors (s1/s2 None for dense weights)."""
    E, C, H, F = x.shape[0], x.shape[1], x.shape[2], w1.shape[-1]
    _act_fn(activation)              # raises on an unknown activation
    tensors = [("x", x), ("w1", w1), ("w2", w2), ("b1", b1), ("b2", b2)]
    if s1 is not None:
        tensors += [("s1", s1), ("s2", s2)]
    for n, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} is not contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x is {x.dtype}; the kernel takes float32 "
                        "or bfloat16")
    if min(E, C, H, F) < 1:
        raise ValueError(f"{name}: empty shape E={E} C={C} H={H} F={F}")
    f32 = torch.float32
    b1, b2 = b1.to(f32).contiguous(), b2.to(f32).contiguous()
    out = torch.empty((E, C, H), dtype=x.dtype, device=x.device)
    nsplit = _splits(E, C, H, F, x.device)
    work = (torch.empty((nsplit, E, C, H), dtype=f32, device=x.device)
            if nsplit > 1 else None)
    launch = _lib()
    with torch.cuda.device(x.device):        # the C side launches on the
        stream = torch.cuda.current_stream()  # current device's stream
        rc = launch(x.data_ptr(), w1.data_ptr(),
                    None if s1 is None else s1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), None if s2 is None else s2.data_ptr(),
                    b2.data_ptr(), out.data_ptr(),
                    None if work is None else work.data_ptr(),
                    E, C, H, F, _DTYPE_CODE[x.dtype], int(s1 is not None),
                    ACTIVATIONS[activation], nsplit, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def grouped_ffn_fwd(x, w1, b1, w2, b2, activation="gelu"):
    """Kernel 10, forward only: CPU tensors take
    :func:`grouped_ffn_reference`; CUDA tensors launch the kernel, or
    raise on what it does not take (non-contiguous operands, x not
    float32 or bfloat16, an empty dimension, an unknown activation).
    w1 and w2 must have x's dtype.  Counts into
    ``grouped_ffn.launches``."""
    _check(x, w1, b1, w2, b2, "grouped_ffn")
    if x.device.type == "cpu":
        return grouped_ffn_reference(x, w1, b1, w2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_ffn: unsupported device {x.device}")
    if not x.dtype == w1.dtype == w2.dtype:
        raise TypeError(f"grouped_ffn: x {x.dtype}, w1 {w1.dtype} and w2 "
                        f"{w2.dtype}: the kernel takes one dtype for all "
                        "three")
    out = _launch(x, w1, None, b1, w2, None, b2, activation, "grouped_ffn")
    grouped_ffn.launches += 1
    return out


def grouped_ffn_q(x, q1, s1, b1, q2, s2, b2, activation="gelu"):
    """Kernel 11 (inference only): int8 ``q1 [E, H, F]`` / ``q2 [E, F, H]``
    with f32 scales ``s1 [E, 1, F]`` / ``s2 [E, 1, H]``.  CPU tensors take
    :func:`grouped_ffn_q_reference`; CUDA tensors launch the kernel or
    raise, as :func:`grouped_ffn_fwd`, and on weights that are not int8
    or scales that are not float32."""
    _check(x, q1, b1, q2, b2, "grouped_ffn_q")
    E, _, H, F = x.shape[0], x.shape[1], x.shape[2], q1.shape[-1]
    if s1.numel() != E * F or s2.numel() != E * H:
        raise ValueError(f"grouped_ffn_q: scales {tuple(s1.shape)} / "
                         f"{tuple(s2.shape)} do not match E={E} F={F} "
                         f"H={H}")
    if x.device.type == "cpu":
        return grouped_ffn_q_reference(x, q1, s1, b1, q2, s2, b2,
                                       activation)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_ffn_q: unsupported device {x.device}")
    if (q1.dtype != torch.int8 or q2.dtype != torch.int8
            or s1.dtype != torch.float32 or s2.dtype != torch.float32):
        raise TypeError(
            f"grouped_ffn_q: dtypes q1={q1.dtype}, q2={q2.dtype}, "
            f"s1={s1.dtype}, s2={s2.dtype} not supported by the kernel "
            "(int8 weights, float32 scales)")
    out = _launch(x, q1, s1, b1, q2, s2, b2, activation, "grouped_ffn_q")
    grouped_ffn_q.launches += 1
    return out


grouped_ffn_q.launches = 0


class GroupedFFN(torch.autograd.Function):
    """Kernel 10 forward; ``_fused_b``'s backward: ``pre`` recomputed in
    f32, the activation's VJP, then dw2, db2, dh, dw1, db1 and dx as f32
    batched matmuls, each cast to its operand's dtype (in JAX these are
    plain einsums outside any Pallas kernel; here ``torch.bmm``, in full
    f32 with TF32 off)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation):
        ctx.activation = activation
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return grouped_ffn_fwd(x, w1, b1, w2, b2, activation)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        f = torch.float32
        x32, dy32 = x.to(f), dy.to(f)
        w1_32, w2_32 = w1.to(f), w2.to(f)
        with torch.enable_grad():
            pre = (torch.bmm(x32, w1_32) + b1.to(f).reshape(-1, 1,
                                                            w1.shape[-1]))
            pre = pre.detach().requires_grad_(True)
            h = _act_fn(ctx.activation)(pre)
        dw2 = torch.bmm(h.detach().transpose(1, 2), dy32).to(w2.dtype)
        db2 = dy32.sum(1, keepdim=True).reshape(b2.shape).to(b2.dtype)
        dh = torch.bmm(dy32, w2_32.transpose(1, 2))
        (dpre,) = torch.autograd.grad(h, pre, dh)
        del h, pre, dh
        dw1 = torch.bmm(x32.transpose(1, 2), dpre).to(w1.dtype)
        db1 = dpre.sum(1, keepdim=True).reshape(b1.shape).to(b1.dtype)
        dx = torch.bmm(dpre, w1_32.transpose(1, 2)).to(x.dtype)
        return dx, dw1, db1, dw2, db2, None


# -- routing --------------------------------------------------------------------

def supported(hidden, ffn, accelerated):
    """The shape gate of auto routing (``grouped_gemm.supported``): H and F
    multiples of 128, on an accelerator (CUDA here)."""
    return bool(accelerated) and hidden % 128 == 0 and ffn % 128 == 0


def resolve_impl(hidden, ffn, impl=None, accelerated=False):
    """``"pallas"`` (the kernel route) or ``"einsum"``.  ``impl`` /
    ``PT_GROUPED_GEMM`` in {auto, pallas, einsum}; ``accelerated`` stands
    for JAX's ``on_tpu``: True for CUDA tensors."""
    impl = (impl or os.environ.get("PT_GROUPED_GEMM", "auto")).lower()
    if impl not in ("auto", "pallas", "einsum"):
        raise ValueError(
            f"PT_GROUPED_GEMM={impl!r}: expected auto|pallas|einsum")
    if impl == "auto":
        return "pallas" if supported(hidden, ffn, accelerated) else "einsum"
    return impl


def grouped_ffn(x, w1, b1, w2, b2, activation="gelu", impl=None):
    """Grouped expert FFN over bucketed tokens, ``x [E, C, H] -> [E, C,
    H]``.  Differentiable on both dense routes (:class:`GroupedFFN` on the
    kernel route, autograd over :func:`einsum_ffn`).

    ``w1``/``w2`` may instead be ``{"qweight", "scale"}`` dicts
    (``ops.quant.quantize_linear``): inference only, through kernel 11 on
    the kernel route; the einsum route dequantizes to x's dtype first.
    ``grouped_ffn.launches`` counts kernel-10 launches."""
    accelerated = x.device.type == "cuda"
    if is_quantized(w1) or is_quantized(w2):
        if not (is_quantized(w1) and is_quantized(w2)):
            raise ValueError(
                "grouped_ffn: w1 and w2 must both be quantized")
        F = w1["qweight"].shape[-1]
        if resolve_impl(x.shape[-1], F, impl, accelerated) == "pallas":
            return grouped_ffn_q(x, w1["qweight"], w1["scale"], b1,
                                 w2["qweight"], w2["scale"], b2, activation)
        return einsum_ffn(x, dequantize(w1["qweight"], w1["scale"], x.dtype),
                          b1, dequantize(w2["qweight"], w2["scale"], x.dtype),
                          b2, activation)
    if resolve_impl(x.shape[-1], w1.shape[-1], impl, accelerated) == "pallas":
        return GroupedFFN.apply(x, w1, b1, w2, b2, activation)
    return einsum_ffn(x, w1, b1, w2, b2, activation)


grouped_ffn.launches = 0
