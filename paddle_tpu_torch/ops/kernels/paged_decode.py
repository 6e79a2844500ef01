"""Paged-decode attention: the hand-written CUDA kernels and their plain
PyTorch versions.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas_kernels/
paged_decode.py`` (``paged_decode`` -> ``_call`` -> ``_kernel``), the
decode attention that ``PagedExecutor`` launches once per layer per
decode step.  The kernels are in ``csrc/paged_decode.cu``.

What bounds it on an H100: the bytes of K and V it must read,
``2 * sum(lengths) * KV * D * itemsize``, at 3.35 TB/s; at 2-4 flops per
K/V byte it is far below the compute ridge, so the math stays fp32 on
the CUDA cores and the design keeps bytes in flight on every SM.  The
TPU kernel DMAs a head's whole page window into VMEM; an SM's shared
memory holds a fraction of a window, so the work is split-K
flash-decoding over pages:

- the grid is (sequence x kv head, split, q-row tile); a split is a
  fixed run of whole pages (:func:`split_plan`, taken from the shapes
  alone: the wrapper never reads ``lengths`` on the host, so the launch
  can be captured by a CUDA graph); a block whose split starts at or
  past its sequence's length returns at once;
- one producer thread brings the split's K and V pages into a ring of
  shared-memory stages with ``cp.async.bulk`` (a page of one kv head is
  contiguous in the pool) through mbarriers that expect the bytes, only
  the rows under the length, so several pages are in flight per block;
- four consumer warps take one pass over the pages, a warp per page
  (so the warps work on different stages at once): lane groups of one
  token row each, fp32 online softmax (running max, sum and accumulator
  per query row, rescaled when the max grows), rows at or past the
  length skipped; then each block writes its split's partial (m, l,
  acc) to f32 scratch;
- a second kernel, launched as a programmatic dependent of the first,
  merges the partials under each length in fixed split order
  (deterministic) and casts once to q's dtype.

No cap on the window (shared memory holds only the ring), on the group
(q-row tiles of at most 8 rows on the grid) or on the page count; D is
64, 128 or 256.  :func:`paged_decode_split_model` in
``testing/paged_split.py`` is the plain model of the split rule the
tests hold against ``paddle_tpu``.

The int8 twin, :func:`paged_decode_quant`, replaces the Pallas
kernel's int8 variant (``paged_decode_quant`` -> ``_call_quant`` ->
``_kernel_quant``, ``PT_QUANT=int8``): the same kernels
(``paged_decode_quant_split_kernel`` and
``paged_decode_quant_combine_kernel``) over int8 pages, the page's k
scale multiplying the dot and its v scale the probability.  It reads
half the bytes of a bf16 pool, ``2 * sum(lengths) * KV * D`` plus a
scale per page.  The TPU gate ``page_size % 32 == 0`` (int8 sublane
tiling) does not carry over.

Routing: :func:`paged_decode` and :func:`paged_decode_quant` take the
kernels for CUDA tensors and the plain version for CPU tensors —
decided by where the tensors lie, never by catching a failure.
``paged_decode.launches`` and ``paged_decode_quant.launches`` count
wrapper calls that launched the kernels (one per call: the split kernel
and its combine; the plain versions do not count).
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
_HEAD_DIMS = (64, 128, 256)
#: tokens a split covers, rounded down to whole pages (the variants
#: script in ``testing/paged_variants.py`` times other values)
SPLIT_TOKENS = 256
MAX_SPLIT_PAGES = 64            # kMaxSplitPages in the .cu


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
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _lib_quant():
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_quant_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def split_plan(B, KV, G, D, ps, pps, split_tokens=None) -> dict:
    """How the kernels cut the work, from the shapes alone (the lengths
    are not an argument: the host never reads them).

    A split is ``split_pages`` whole pages of the window, ``split_tokens``
    (default :data:`SPLIT_TOKENS`) rounded down to whole pages, at least
    one page and at most the window and ``MAX_SPLIT_PAGES``; ``n_split``
    splits cover the window's ``pps`` pages (the last may run past it).
    The group's G query rows go in tiles of ``q_tile`` rows (the next
    power of two, at most 8, at most 4 at D = 256) on ``n_qtile`` tiles of
    the grid; ``scratch_floats`` are the f32 partials (acc, m, l) the
    split kernel writes."""
    split_tokens = SPLIT_TOKENS if split_tokens is None else split_tokens
    split_pages = max(1, min(split_tokens // ps, MAX_SPLIT_PAGES, pps))
    n_split = max(1, -(-pps // split_pages))
    q_tile = min(1 << max(G - 1, 0).bit_length(), 8 if D <= 128 else 4)
    n_qtile = -(-G // q_tile)
    return {"split_pages": split_pages, "split_tokens": split_pages * ps,
            "n_split": n_split, "q_tile": q_tile, "n_qtile": n_qtile,
            "scratch_floats": B * KV * n_split * G * (D + 2)}


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


def _gate(what, tensors, q, k_pages, v_pages, lengths, page_indices,
          dtype_pairs):
    """What the kernels refuse, from shapes, dtypes, strides and
    pointers alone (nothing is launched and no value is read): a
    non-contiguous tensor, lengths or indices not int32, a (q, pool)
    dtype pair outside ``dtype_pairs``, a page whose bytes are not a
    multiple of 16 or a pool not 16-byte aligned (the bulk copies' unit),
    D not in (64, 128, 256).  Returns :func:`split_plan`'s plan."""
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
    B, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    page = ps * D * k_pages.element_size()
    if page % 16:
        raise ValueError(f"{what}: a page is {page} bytes, not a multiple "
                         "of 16 (the bulk copy's unit)")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {_HEAD_DIMS}")
    return split_plan(B, KV, H // KV, D, ps, page_indices.shape[1])


def _check_cuda(what, tensors, q, k_pages, v_pages, lengths, page_indices,
                dtype_pairs):
    """:func:`_gate` for tensors on the card; returns the plan."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    return _gate(what, tensors, q, k_pages, v_pages, lengths, page_indices,
                 dtype_pairs)


def paged_decode(q, k_pages, v_pages, lengths, page_indices, scale=None):
    """Decode attention over one layer of the page pool.

    q [B, H, D] (H % KV == 0); k/v_pages [KV, P, ps, D]; lengths [B]
    int32; page_indices [B, pps] int32.  Returns [B, H, D] in q's dtype.
    Every page-table entry below ``ceil(length / ps)`` must name a real
    page; entries past it are never read.

    CPU tensors take :func:`paged_decode_reference`.  CUDA tensors
    launch the kernels, or raise on what they do not take: a
    non-contiguous input, lengths or indices not int32, a dtype pair
    other than (f32, f32), (f32, bf16) or (bf16, bf16) for (q, pools),
    pools not 16-byte aligned, or D not in (64, 128, 256).  Any group
    size and any window."""
    B, H, D, KV, ps = _check(q, k_pages, v_pages, lengths, page_indices)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, lengths,
                                      page_indices, scale)
    plan = _check_cuda(
        "paged_decode", {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                         "lengths": lengths, "page_indices": page_indices},
        q, k_pages, v_pages, lengths, page_indices, _DTYPE_PAIRS)
    out = torch.empty_like(q)
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                          device=q.device)
    launch = _lib()
    with torch.cuda.device(q.device):       # the C side launches on the
        stream = torch.cuda.current_stream()  # current device's stream
        rc = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    lengths.data_ptr(), page_indices.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), B, KV, H // KV, D,
                    k_pages.shape[1], ps, page_indices.shape[1],
                    plan["split_pages"], plan["n_split"], plan["q_tile"],
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
    kernels, or raise on what they do not take: as
    :func:`paged_decode`, with (q, pools) dtype pairs (f32, int8) and
    (bf16, int8) and scales that are float32 [KV, P]."""
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
    plan = _check_cuda(
        what, {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "lengths": lengths, "page_indices": page_indices,
               "k_scales": k_scales, "v_scales": v_scales},
        q, k_pages, v_pages, lengths, page_indices, _QUANT_DTYPE_PAIRS)
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise TypeError(f"{what}: scales must be float32")
    out = torch.empty_like(q)
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                          device=q.device)
    launch = _lib_quant()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream()
        rc = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    lengths.data_ptr(), page_indices.data_ptr(),
                    k_scales.data_ptr(), v_scales.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), B, KV, H // KV, D,
                    P, ps, page_indices.shape[1], plan["split_pages"],
                    plan["n_split"], plan["q_tile"], float(scale),
                    _DTYPE_CODE[q.dtype], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_quant kernel launch failed: CUDA "
                           f"error {rc}")
    paged_decode_quant.launches += 1
    return out


paged_decode_quant.launches = 0
