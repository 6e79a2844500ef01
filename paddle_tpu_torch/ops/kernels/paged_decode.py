"""Paged-decode attention: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas_kernels/
paged_decode.py`` (``paged_decode`` -> ``_call`` -> ``_kernel``), the
decode attention that ``PagedExecutor`` launches once per layer per
decode step.  The kernel is ``csrc/paged_decode.cu``: one block of
8 warps per (sequence, kv head), K/V read through the page table for
the pages under the length only, fp32 two-pass softmax with the scores
in shared memory, fp32 accumulation, output in q's dtype.

What bounds it on an H100: the bytes of K and V it must read,
``2 * sum(lengths) * KV * D * itemsize``, at 3.35 TB/s; at 4 flops per
bf16 K/V byte it is far below the compute ridge.  What the design does
about that: every K/V row is read once and serves all ``G = H / KV``
query rows of its head, pages past the length are never read, and
scores and probabilities stay in shared memory (the dense version
writes the gathered cache and the score matrix to device memory).
Split-K over pages, TMA and wider loads are left to later work.

The int8 twin, :func:`paged_decode_quant`, replaces the Pallas
kernel's int8 variant (``paged_decode_quant`` -> ``_call_quant`` ->
``_kernel_quant``, ``PT_QUANT=int8``): the same body
(``paged_decode_quant_kernel`` in the same ``.cu``) over int8 pools,
each K/V row multiplied by its page's f32 scale as it is widened.  It
reads half the bytes of a bf16 pool, ``2 * sum(lengths) * KV * D`` plus
a scale per page.  The TPU gate ``page_size % 32 == 0`` (int8 sublane
tiling) does not carry over: any page size works.

Routing: :func:`paged_decode` and :func:`paged_decode_quant` take the
kernel for CUDA tensors and the plain version for CPU tensors — decided
by where the tensors lie, never by catching a failure.
``paged_decode.launches`` and ``paged_decode_quant.launches`` count
kernel launches (only those; the plain versions do not count).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: (q dtype, pool dtype) pairs the kernel is instantiated for
_DTYPE_PAIRS = {(torch.float32, torch.float32),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16)}
#: (q dtype, pool dtype) pairs of the int8 twin
_QUANT_DTYPE_PAIRS = {(torch.float32, torch.int8),
                      (torch.bfloat16, torch.int8)}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
_WARPS = 8                      # kWarps in the .cu
_SMEM_LIMIT = 232448            # bytes of shared memory a block may use


def paged_decode_reference(q, k_pages, v_pages, lengths, page_indices,
                           scale=None):
    """Plain PyTorch version (the counterpart of ``paddle_tpu``'s
    ``_dense_paged_attention``): gather each sequence's page window
    dense, fp32 scores masked to the length, softmax, fp32 ``p @ V``,
    cast to q's dtype.  Positions at or past the length are masked in
    V as well, so garbage (even NaN) there cannot reach the output.

    q [B, H, D]; k/v_pages [KV, P, ps, D]; lengths [B]; page_indices
    [B, pps].  Returns [B, H, D]."""
    B, _, D = q.shape
    KV, _, ps, _ = k_pages.shape
    T = page_indices.shape[1] * ps
    idx = page_indices.long()
    kc = k_pages[:, idx].transpose(0, 1).reshape(B, KV, T, D).float()
    vc = v_pages[:, idx].transpose(0, 1).reshape(B, KV, T, D).float()
    return _attend_window(q, kc, vc, lengths, scale)


def paged_decode_quant_reference(q, k_pages, v_pages, lengths, page_indices,
                                 k_scales, v_scales, scale=None):
    """Plain PyTorch version of the int8 twin (the counterpart of
    ``paddle_tpu``'s ``_dense_paged_attention_q``): gather each
    sequence's int8 page window, dequantize it with the per-page scales
    (never the whole pool), then the same fp32 attention as
    :func:`paged_decode_reference`.

    k/v_pages int8 [KV, P, ps, D]; k/v_scales f32 [KV, P]; the rest as
    :func:`paged_decode_reference`."""
    B, _, D = q.shape
    KV, _, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    T = pps * ps
    idx = page_indices.long()

    def window(pages, scales):
        w = pages[:, idx].float() * scales[:, idx][..., None, None]
        return w.transpose(0, 1).reshape(B, KV, T, D)

    return _attend_window(q, window(k_pages, k_scales),
                          window(v_pages, v_scales), lengths, scale)


def _attend_window(q, kc, vc, lengths, scale):
    """fp32 decode attention of q [B, H, D] over dense fp32 windows
    kc/vc [B, KV, T, D], masked to each sequence's length."""
    B, H, D = q.shape
    KV, T = kc.shape[1], kc.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    valid = (torch.arange(T, device=q.device)[None]
             < lengths.to(q.device).long()[:, None])       # [B, T]
    qg = q.reshape(B, KV, H // KV, D).float()
    logits = torch.einsum("bkgd,bktd->bkgt", qg, kc) * scale
    logits = torch.where(valid[:, None, None], logits,
                         torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    vc = torch.where(valid[:, None, :, None], vc,
                     torch.zeros((), device=q.device))
    out = torch.einsum("bkgt,bktd->bkgd", p, vc)
    return out.reshape(B, H, D).to(q.dtype)


def _lib():
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _lib_quant():
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_quant_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(group, head_dim, window) -> int:
    """Dynamic shared memory one block takes (mirrors the .cu)."""
    return 4 * (group * head_dim * (1 + _WARPS) + group * window)


def _check(q, k_pages, v_pages, lengths, page_indices, what="paged_decode"):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "lengths": lengths, "page_indices": page_indices}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"q on {q.device}")
    if q.dim() != 3 or k_pages.dim() != 4 or page_indices.dim() != 2:
        raise ValueError(f"{what}: expected q [B, H, D], pools "
                         "[KV, P, ps, D], page_indices [B, pps]")
    B, H, D = q.shape
    KV, _, ps, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(
            f"{what}: pool shapes {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(
            f"q heads {H} not a multiple of kv heads {KV}")
    if lengths.shape != (B,) or page_indices.shape[0] != B:
        raise ValueError(f"{what}: lengths / page_indices batch "
                         f"does not match q's {B}")
    return B, H, D, KV, ps


def _check_cuda(what, tensors, q, k_pages, v_pages, lengths, page_indices,
                dtype_pairs):
    """What the kernel refuses on the card; returns (G, pps)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise TypeError(f"{what}: lengths and page_indices must be int32")
    if v_pages.dtype != k_pages.dtype or \
            (q.dtype, k_pages.dtype) not in dtype_pairs:
        raise TypeError(
            f"{what}: dtypes q={q.dtype}, pools={k_pages.dtype}/"
            f"{v_pages.dtype} not supported by the kernel")
    _, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {_HEAD_DIMS}")
    G = H // KV
    if G > _MAX_GROUP:
        raise ValueError(f"{what}: {G} query heads per kv head > "
                         f"{_MAX_GROUP}")
    pps = page_indices.shape[1]
    if smem_bytes(G, D, pps * ps) > _SMEM_LIMIT:
        raise ValueError(
            f"{what}: window of {pps * ps} tokens x {G} query rows "
            f"needs {smem_bytes(G, D, pps * ps)} bytes of shared memory "
            f"(> {_SMEM_LIMIT})")
    return G, pps


def paged_decode(q, k_pages, v_pages, lengths, page_indices, scale=None):
    """Decode attention over one layer of the page pool.

    q [B, H, D] (H % KV == 0); k/v_pages [KV, P, ps, D]; lengths [B]
    int32; page_indices [B, pps] int32.  Returns [B, H, D] in q's dtype.
    Every page-table entry below ``ceil(length / ps)`` must name a real
    page; entries past it are never read.

    CPU tensors take :func:`paged_decode_reference`.  CUDA tensors
    launch the kernel, or raise on what it does not take: a
    non-contiguous input, lengths or indices not int32, a dtype pair
    other than (f32, f32), (f32, bf16) or (bf16, bf16) for (q, pools),
    D not in (64, 128), more than 8 query heads per kv head, or a
    window whose scores overflow shared memory."""
    B, H, D, KV, ps = _check(q, k_pages, v_pages, lengths, page_indices)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, lengths,
                                      page_indices, scale)
    G, pps = _check_cuda(
        "paged_decode", {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                         "lengths": lengths, "page_indices": page_indices},
        q, k_pages, v_pages, lengths, page_indices, _DTYPE_PAIRS)
    out = torch.empty_like(q)
    launch = _lib()
    with torch.cuda.device(q.device):       # the C side launches on the
        stream = torch.cuda.current_stream()  # current device's stream
        rc = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    lengths.data_ptr(), page_indices.data_ptr(),
                    out.data_ptr(), B, KV, G, D, k_pages.shape[1], ps, pps,
                    float(scale), _DTYPE_CODE[q.dtype],
                    _DTYPE_CODE[k_pages.dtype], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA "
                           f"error {rc}")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def paged_decode_quant(q, k_pages, v_pages, lengths, page_indices,
                       k_scales, v_scales, scale=None):
    """Decode attention over one layer of an int8 page pool.

    As :func:`paged_decode`, with int8 k/v_pages [KV, P, ps, D] and f32
    per-page scales k/v_scales [KV, P].  CPU tensors take
    :func:`paged_decode_quant_reference`.  CUDA tensors launch the
    kernel, or raise on what it does not take: as :func:`paged_decode`,
    with (q, pools) dtype pairs (f32, int8) and (bf16, int8) and scales
    that are float32 [KV, P]."""
    what = "paged_decode_quant"
    B, H, D, KV, ps = _check(q, k_pages, v_pages, lengths, page_indices,
                             what)
    P = k_pages.shape[1]
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.shape != (KV, P):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not "
                             f"[KV, P] = {(KV, P)}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return paged_decode_quant_reference(q, k_pages, v_pages, lengths,
                                            page_indices, k_scales,
                                            v_scales, scale)
    G, pps = _check_cuda(
        what, {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "lengths": lengths, "page_indices": page_indices,
               "k_scales": k_scales, "v_scales": v_scales},
        q, k_pages, v_pages, lengths, page_indices, _QUANT_DTYPE_PAIRS)
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise TypeError(f"{what}: scales must be float32")
    out = torch.empty_like(q)
    launch = _lib_quant()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream()
        rc = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    lengths.data_ptr(), page_indices.data_ptr(),
                    k_scales.data_ptr(), v_scales.data_ptr(),
                    out.data_ptr(), B, KV, G, D, P, ps, pps, float(scale),
                    _DTYPE_CODE[q.dtype], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_quant kernel launch failed: CUDA "
                           f"error {rc}")
    paged_decode_quant.launches += 1
    return out


paged_decode_quant.launches = 0
