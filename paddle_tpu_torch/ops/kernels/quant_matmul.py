"""Int8-weight matmul (W8A16): the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas_kernels/
quant_matmul.py`` (``quant_matmul`` -> ``_pallas_qmm`` -> ``_kernel``),
the weight GEMM that ``PagedExecutor`` runs for each of the seven
quantized projections of every layer under ``quant="int8"``.  The kernel
is ``csrc/quant_matmul.cu``: ``out = cast((float(x) @ float(qweight)) *
scale)``, the int8 weight widened next to the product and never written
back, the scale applied once to the f32 sum.  M <= 8 (decode) takes a
split-K GEMV on the fp32 cores whose bound is the weight stream; larger
M (prefill) takes 64 x 128 ``mma.sync`` bf16 tiles for bf16 x and
64 x 64 FMA tiles for f32 x.  Any M, K and N.

What bounds it on an H100: at decode, the ``K * N`` int8 weight bytes
(plus x and out) over 3.35 TB/s; at prefill, ``2 * M * K * N`` flops over
the bf16 tensor-core rate.

Routing: :func:`quant_matmul` takes the kernel for CUDA tensors and the
plain version for CPU tensors, decided by where the tensors lie, never
by catching a failure.  ``quant_matmul.launches`` counts calls that
launched the kernel (one per call: the M <= 8 path with more than one K
slice is two CUDA launches, the GEMV and the fixed-order sum of its
slices).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMALL_M = 8          # kSmallM in the .cu: the split-K GEMV path
K_SLICE = 512        # kGemvRows in the .cu: rows of K per GEMV block


def quant_matmul_reference(x, qweight, scale):
    """Plain PyTorch version (the counterpart of ``paddle_tpu``'s
    dequantize-then-dot fallback in ``ops/quant.qmatmul``): f32 product
    of x and the widened weight, times the per-column scale, cast to x's
    dtype.  x [M, K]; qweight int8 [K, N]; scale f32 [N]."""
    out = (x.to(torch.float32) @ qweight.to(torch.float32)) \
        * scale.reshape(1, -1)
    return out.to(x.dtype)


def _lib():
    lib = _build.load("quant_matmul")
    fn = lib.quant_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, qweight, scale):
    for name, t in (("qweight", qweight), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"quant_matmul: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.dim() != 2 or qweight.dim() != 2:
        raise ValueError("quant_matmul: expected x [M, K] and qweight "
                         "[K, N]")
    M, K = x.shape
    K2, N = qweight.shape
    if K2 != K or scale.numel() != N:
        raise ValueError(
            f"quant_matmul: x {tuple(x.shape)}, qweight "
            f"{tuple(qweight.shape)} and scale {tuple(scale.shape)} do not "
            "match")
    return M, K, N


def quant_matmul(x, qweight, scale):
    """``x [M, K] @ int8 qweight [K, N] * scale [N] -> [M, N]`` in x's
    dtype.

    CPU tensors take :func:`quant_matmul_reference`.  CUDA tensors launch
    the kernel, or raise on what it does not take: a non-contiguous
    input, x not float32 or bfloat16, qweight not int8, scale not
    float32, or an empty dimension."""
    M, K, N = _check(x, qweight, scale)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, qweight, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    for name, t in (("x", x), ("qweight", qweight), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} is not contiguous")
    if x.dtype not in _DTYPE_CODE or qweight.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(
            f"quant_matmul: dtypes x={x.dtype}, qweight={qweight.dtype}, "
            f"scale={scale.dtype} not supported by the kernel (x float32 "
            "or bfloat16, qweight int8, scale float32)")
    if min(M, K, N) < 1:
        raise ValueError(f"quant_matmul: empty shape M={M} K={K} N={N}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ksplit = -(-K // K_SLICE) if M <= SMALL_M else 0
    work = (torch.empty((ksplit, M, N), dtype=torch.float32,
                        device=x.device) if ksplit > 1 else None)
    launch = _lib()
    with torch.cuda.device(x.device):        # the C side launches on the
        stream = torch.cuda.current_stream()  # current device's stream
        rc = launch(x.data_ptr(), qweight.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), None if work is None else work.data_ptr(),
                    M, K, N, _DTYPE_CODE[x.dtype], ksplit,
                    stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
