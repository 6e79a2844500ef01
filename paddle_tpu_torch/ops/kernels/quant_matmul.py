"""Int8-weight matmul (W8A16): the hand-written CUDA kernels and their
plain PyTorch version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas_kernels/
quant_matmul.py`` (``quant_matmul`` -> ``_pallas_qmm`` -> ``_kernel``),
the weight GEMM that ``PagedExecutor`` runs for each of the seven
quantized projections of every layer under ``quant="int8"``.  The
kernels are ``csrc/quant_matmul.cu``: ``out = cast((float(x) @
float(qweight)) * scale)``, the int8 weight read as it lies ([K, N], no
repacked or bf16 copy) and widened next to the product, the scale applied
once to the f32 sum.

What bounds it on an H100: at decode (M = batch), the ``K * N`` int8
weight bytes over 3.35 TB/s; at prefill (M = a 512-token chunk),
``2 * M * K * N`` flops over the bf16 tensor-core rate.

Routes (:func:`route`), from the shapes, dtype and alignment alone:

- ``"decode"``: bf16 x, ``M <= DECODE_MAX_M``, and a shape TMA can
  describe (``N % 16 == 0``, ``K % 8 == 0``, x and qweight 16-byte
  aligned).  A tensor-core GEMV, ``out^T = w^T . x^T`` on ``mma.sync``:
  TMA streams a 256-channel strip of the int8 weight, two [64, 128]
  tiles a stage, through a ring of about 64 KB a block, an
  ``ldmatrix.trans`` hands each thread the byte transpose an A
  fragment needs, and two LOP3s and an HSUB2 widen two bytes to bf16
  exactly (no quarter-rate conversion, no FMA per byte).  The K splits
  (:func:`decode_split`, about two blocks per SM) are summed in split
  order by a second kernel launched as a programmatic dependent.
- ``"prefill"``: bf16 x, ``M > DECODE_MAX_M``, the same shape rule.  A
  warp-specialised ``wgmma`` GEMM on 128 channels x 128 rows a block: the
  weight widened in registers as ``wgmma``'s A operand, x^T as B from
  TMA's 128-byte-swizzled tiles, an 8-stage ring.
- ``"simt"``: bf16 x on a shape TMA cannot describe: the bounds-checked
  SIMT kernels (split-K GEMV for M <= 8, ``mma.sync`` tiles above).
- ``"fp32"``: f32 x, any shape: the same two kernels on the fp32 cores
  (tensor cores would round f32 x to TF32, which the TPU kernel does not).

Routing: :func:`quant_matmul` takes the kernels for CUDA tensors and the
plain version for CPU tensors, decided by where the tensors lie, never
by catching a failure.  ``quant_matmul.launches`` counts calls that
launched a kernel (one per call, though a split GEMV is two CUDA
launches, the splits and their fixed-order sum), and
``quant_matmul.routes`` counts them by route.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMALL_M = 8          # kSmallM in the .cu: the SIMT split-K GEMV's rows
K_SLICE = 512        # kGemvRows in the .cu: rows of K per SIMT GEMV block
DECODE_MAX_M = 32    # the GEMV's rows here (the .cu's kDecMaxM is 64)
TILE_K = 64          # kTK: weight rows per ring stage
DECODE_N = 256       # kDecN: channels per block of the tensor-core GEMV
DECODE_BLOCKS_PER_SM = 2   # the GEMV's K split aims at this many blocks
ROUTES = ("decode", "prefill", "simt", "fp32")
# C route codes: SIMT GEMV, SIMT tiles, tensor-core GEMV, wgmma GEMM
_SIMT_GEMV, _SIMT_TILES, _DECODE, _PREFILL = 0, 1, 2, 3


def quant_matmul_reference(x, qweight, scale):
    """Plain PyTorch version (the counterpart of ``paddle_tpu``'s
    dequantize-then-dot fallback in ``ops/quant.qmatmul``): f32 product
    of x and the widened weight, times the per-column scale, cast to x's
    dtype.  x [M, K]; qweight int8 [K, N]; scale f32 [N]."""
    out = (x.to(torch.float32) @ qweight.to(torch.float32)) \
        * scale.reshape(1, -1)
    return out.to(x.dtype)


def route(M, K, N, x_dtype, aligned=True) -> str:
    """The route of an [M, K] x [K, N] call (one of :data:`ROUTES`);
    ``aligned``: x and qweight start on 16-byte boundaries."""
    if x_dtype == torch.float32:
        return "fp32"
    if N % 16 == 0 and K % 8 == 0 and aligned:
        return "decode" if M <= DECODE_MAX_M else "prefill"
    return "simt"


def decode_split(K, N, sms=132) -> int:
    """K splits of the tensor-core GEMV: about ``DECODE_BLOCKS_PER_SM``
    blocks per SM over the ``ceil(N / 256)`` channel strips, each split a
    run of whole 64-row k tiles (so at most ``ceil(K / 64)``)."""
    tiles = -(-N // DECODE_N)
    return max(1, min(-(-K // TILE_K),
                      round(DECODE_BLOCKS_PER_SM * sms / tiles)))


def _lib():
    lib = _build.load("quant_matmul")
    fn = lib.quant_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
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


def _gate(x, qweight, scale) -> str:
    """What the kernels refuse, from shapes, dtypes, strides and pointers
    alone (nothing is launched): a non-contiguous input, x not float32 or
    bfloat16, qweight not int8, scale not float32, or an empty dimension.
    Returns the call's :func:`route`."""
    M, K, N = _check(x, qweight, scale)
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
    return route(M, K, N, x.dtype,
                 x.data_ptr() % 16 == 0 and qweight.data_ptr() % 16 == 0)


_SMS: dict = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def launch(fn, x, qweight, scale, kind, ksplit=None):
    """Launch route ``kind`` through the C entry point ``fn`` (the built
    library's ``quant_matmul_launch``, or a variant's) on CUDA tensors
    that passed :func:`_gate`; ``ksplit`` overrides the tensor-core
    GEMV's split.  Returns out [M, N] in x's dtype."""
    M, K = x.shape
    N = qweight.shape[1]
    if kind == "decode":
        code = _DECODE
        if ksplit is None:
            ksplit = decode_split(K, N, _sm_count(x.device))
    elif kind == "prefill":
        code, ksplit = _PREFILL, 1
    elif M <= SMALL_M:                      # simt and fp32
        code, ksplit = _SIMT_GEMV, -(-K // K_SLICE)
    else:
        code, ksplit = _SIMT_TILES, 1
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    split = code in (_SIMT_GEMV, _DECODE) and ksplit > 1
    work = (torch.empty((ksplit, M, N), dtype=torch.float32,
                        device=x.device) if split else None)
    with torch.cuda.device(x.device):        # the C side launches on the
        stream = torch.cuda.current_stream()  # current device's stream
        rc = fn(x.data_ptr(), qweight.data_ptr(), scale.data_ptr(),
                out.data_ptr(), None if work is None else work.data_ptr(),
                M, K, N, _DTYPE_CODE[x.dtype], code, ksplit,
                stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed ({kind} "
                           f"route, M={M} K={K} N={N}): CUDA error {rc}")
    return out


def quant_matmul(x, qweight, scale):
    """``x [M, K] @ int8 qweight [K, N] * scale [N] -> [M, N]`` in x's
    dtype.

    CPU tensors take :func:`quant_matmul_reference`.  CUDA tensors launch
    the kernel of their :func:`route`, or raise on what :func:`_gate`
    refuses."""
    _check(x, qweight, scale)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, qweight, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    kind = _gate(x, qweight, scale)
    out = launch(_lib(), x, qweight, scale, kind)
    quant_matmul.launches += 1
    quant_matmul.routes[kind] += 1
    return out


quant_matmul.launches = 0
quant_matmul.routes = dict.fromkeys(ROUTES, 0)
