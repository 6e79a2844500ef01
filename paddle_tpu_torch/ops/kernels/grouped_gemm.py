"""Grouped expert FFN: the hand-written CUDA kernels, their plain PyTorch
versions, the batched-einsum route and the routing between them.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas_kernels/
grouped_gemm.py``: ``_pallas_ffn`` (kernel 10)

    out[e] = act(x[e] @ w1[e] + b1[e]) @ w2[e] + b2[e]

for every expert over sort-dispatched buckets ``x [E, C, H]`` (w1
``[E, H, F]``, b1 ``[E, 1, F]``, w2 ``[E, F, H]``, b2 ``[E, 1, H]``), with
x and the weights widened to f32, the hidden ``h`` kept in f32 and one
cast of the f32 sum to x's dtype; and ``_pallas_ffn_q`` (kernel 11), the
same over int8 weights with per-output channel f32 scales ``s1 [E, 1, F]``
and ``s2 [E, 1, H]``: ``h = act((x @ q1) * s1 + b1)``,
``out = (h @ q2) * s2 + b2``.  The kernels are ``csrc/grouped_gemm.cu``.

What bounds them on an H100: ``4 * E * C * H * F`` flops at the bf16
tensor-core rate at MoE training sizes; the weight bytes at a decode-sized
C (int8: half of bf16's).  bf16 x takes two warp-specialised grouped GEMMs
on the tensor cores (``wgmma`` m64n256 tiles of 128 rows fed by TMA
through an mbarrier ring): GEMM 1 ``x @ w1`` with s1, b1 and the
activation in f32, ``h`` stored as two bf16 terms ``hi + lo`` (about 16
bits, never rounded to bf16 once) to scratch the wrapper allocates;
GEMM 2 ``h_hi @ w2 + h_lo @ w2`` with s2 on the f32 sum, b2 and one
cast.  Int8 weights arrive raw and are widened to bf16 in shared memory
(exact); no bf16 copy of them is made.  A C too small to fill the card
splits GEMM 2's F over blocks, whose f32 partial sums a second kernel adds
in a fixed order (no atomics).  TMA needs 16-byte row strides, so H and
F off the multiples of 8 (16 for int8) are zero-padded here first
(:func:`pad_operands`: exact).  f32 x takes the f32 FMA kernel (the
tensor cores would round x to TF32), as the first port wrote it.  The
.cu's note has the design and its reasons.

Routing (:func:`grouped_ffn`, as ``grouped_gemm.grouped_ffn`` routes):
``impl`` / ``PT_GROUPED_GEMM`` in {auto, pallas, einsum}.  ``auto`` takes
the kernel for CUDA tensors when H and F are multiples of 128, and
:func:`einsum_ffn` otherwise, and always on the CPU (as JAX does off the
TPU).  ``pallas`` forces the kernel route: CUDA tensors launch the
kernel, CPU tensors take its plain version.  The kernel route's VJP is
``_fused_b``'s: plain f32 matmuls (:class:`GroupedFFN`).
``grouped_ffn.launches`` and ``grouped_ffn_q.launches`` count calls of
kernels 10 and 11 (one per call, though a call launches two or three
CUDA kernels).  The TPU's tile autotuning (``blocks()``) has no
counterpart: the CUDA kernels' tiles are their own, for any C, H and F.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from ..registry import refuse_create_graph
from . import _build
from ..nn_ops import einsum
from ..quant import dequantize, is_quantized

#: the .cu's activation codes
ACTIVATIONS = {"gelu": 0, "relu": 1, "silu": 2, "sigmoid": 3, "tanh": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 16        # kRows in the .cu: rows of x per f32 block
COLS = 2048      # kCols: output columns per f32 block
F_BLOCK = 64     # kFB: the f32 kernel's F block; the unit of F splits
TILE_M = 128     # kBM: rows per tensor-core tile
TILE_N = 256     # kBN: columns per tensor-core tile


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
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
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


def _splits(E, C, H, F, device, tensor_cores):
    """Splits of F: 1 when the blocks that own output tiles fill the SMs,
    else enough to fill them (at most one 64-wide F chunk each).  Those
    blocks are (16 rows, 2048 columns) on the f32 kernel and GEMM 2's
    (128 rows, 256 columns) on the tensor cores."""
    if tensor_cores:
        base = -(-C // TILE_M) * E * -(-H // TILE_N)
    else:
        base = -(-C // ROWS) * E * -(-H // COLS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-F // F_BLOCK), sms // base))


def tma_padding(H, F, int8):
    """``(H, F)`` rounded up to what the tensor-core kernels' TMA row
    strides take: multiples of 8 (16 bytes of bf16), 16 for int8 weights
    (16 bytes of int8)."""
    m = 16 if int8 else 8
    return -(-H // m) * m, -(-F // m) * m


def pad_operands(x, w1, s1, b1, w2, s2, b2, Hp, Fp):
    """Zero-pad the operands to ``H = Hp`` and ``F = Fp``: x ``[E, C,
    Hp]``, w1 ``[E, Hp, Fp]``, w2 ``[E, Fp, Hp]``, biases and scales
    ``[E, Fp]`` / ``[E, Hp]`` (s1, s2 None for dense weights).  Exact:
    padded H columns of x meet zero rows of w1 and give output columns
    that the caller slices off; padded F columns give ``act(0 + 0)``,
    which need not be zero (sigmoid: 0.5), times zero rows of w2."""
    E, _, H = x.shape
    F = w1.shape[-1]
    dh, df = Hp - H, Fp - F
    pad = torch.nn.functional.pad

    def vec(t, n, d):
        return None if t is None else pad(t.reshape(E, n), (0, d))

    return (pad(x, (0, dh)), pad(w1, (0, df, 0, dh)), vec(s1, F, df),
            vec(b1, F, df), pad(w2, (0, dh, 0, df)), vec(s2, H, dh),
            vec(b2, H, dh))


def _aligned(t):
    """``t``, or a copy of it when its data does not start on 16 bytes
    (TMA's rule for a tensor's base)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w1, s1, b1, w2, s2, b2, activation, name, passes=3):
    """Launch the kernels on CUDA tensors (s1/s2 None for dense weights).
    ``passes`` (bf16 x only): 1 runs GEMM 1 alone, 2 GEMM 2 alone (on
    whatever its h scratch holds), 3 both; 1 and 2 serve timing only."""
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
    dev = x.device
    tensor_cores = x.dtype == torch.bfloat16
    h_hi = h_lo = None
    H0 = H
    if tensor_cores:
        Hp, Fp = tma_padding(H, F, s1 is not None)
        if (Hp, Fp) != (H, F):
            x, w1, s1, b1, w2, s2, b2 = pad_operands(x, w1, s1, b1, w2, s2,
                                                     b2, Hp, Fp)
            H, F = Hp, Fp
        x, w1, w2, b1, b2 = (_aligned(t) for t in (x, w1, w2, b1, b2))
        if s1 is not None:
            s1, s2 = _aligned(s1), _aligned(s2)
        h_hi = torch.empty((E, C, F), dtype=torch.bfloat16, device=dev)
        h_lo = torch.empty_like(h_hi)
    out = torch.empty((E, C, H), dtype=x.dtype, device=dev)
    nsplit = _splits(E, C, H, F, dev, tensor_cores)
    work = (torch.empty((nsplit, E, C, H), dtype=f32, device=dev)
            if nsplit > 1 else None)
    launch = _lib()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):              # the C side launches on the
        stream = torch.cuda.current_stream()  # current device's stream
        rc = launch(x.data_ptr(), w1.data_ptr(), ptr(s1), b1.data_ptr(),
                    w2.data_ptr(), ptr(s2), b2.data_ptr(), out.data_ptr(),
                    ptr(work), ptr(h_hi), ptr(h_lo), E, C, H, F,
                    _DTYPE_CODE[x.dtype], int(s1 is not None),
                    ACTIVATIONS[activation], nsplit, passes,
                    stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out if H == H0 else out[..., :H0].contiguous()


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
        if torch.is_grad_enabled():
            refuse_create_graph("grouped_ffn")
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
