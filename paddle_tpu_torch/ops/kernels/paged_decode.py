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

Routing: :func:`paged_decode` takes the kernel for CUDA tensors and
the plain version for CPU tensors — decided by where the tensors lie,
never by catching a failure.  ``paged_decode.launches`` counts kernel
launches (only those; the plain version does not count).
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
    B, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    T = pps * ps
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    idx = page_indices.long()
    kc = k_pages[:, idx].transpose(0, 1).reshape(B, KV, T, D).float()
    vc = v_pages[:, idx].transpose(0, 1).reshape(B, KV, T, D).float()
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


def smem_bytes(group, head_dim, window) -> int:
    """Dynamic shared memory one block takes (mirrors the .cu)."""
    return 4 * (group * head_dim * (1 + _WARPS) + group * window)


def _check(q, k_pages, v_pages, lengths, page_indices):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "lengths": lengths, "page_indices": page_indices}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"paged_decode: {name} is on {t.device}, "
                             f"q on {q.device}")
    if q.dim() != 3 or k_pages.dim() != 4 or page_indices.dim() != 2:
        raise ValueError("paged_decode: expected q [B, H, D], pools "
                         "[KV, P, ps, D], page_indices [B, pps]")
    B, H, D = q.shape
    KV, _, ps, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(
            f"paged_decode: pool shapes {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(
            f"q heads {H} not a multiple of kv heads {KV}")
    if lengths.shape != (B,) or page_indices.shape[0] != B:
        raise ValueError("paged_decode: lengths / page_indices batch "
                         f"does not match q's {B}")
    return B, H, D, KV, ps


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
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("lengths", lengths),
                    ("page_indices", page_indices)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} is not contiguous")
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise TypeError("paged_decode: lengths and page_indices must be "
                        "int32")
    if v_pages.dtype != k_pages.dtype or \
            (q.dtype, k_pages.dtype) not in _DTYPE_PAIRS:
        raise TypeError(
            f"paged_decode: dtypes q={q.dtype}, pools={k_pages.dtype}/"
            f"{v_pages.dtype} not supported by the kernel")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {D} not in {_HEAD_DIMS}")
    G = H // KV
    if G > _MAX_GROUP:
        raise ValueError(f"paged_decode: {G} query heads per kv head > "
                         f"{_MAX_GROUP}")
    pps = page_indices.shape[1]
    if smem_bytes(G, D, pps * ps) > _SMEM_LIMIT:
        raise ValueError(
            f"paged_decode: window of {pps * ps} tokens x {G} query rows "
            f"needs {smem_bytes(G, D, pps * ps)} bytes of shared memory "
            f"(> {_SMEM_LIMIT})")
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
