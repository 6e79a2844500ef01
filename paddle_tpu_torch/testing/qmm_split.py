"""A plain model of the tensor-core int8-weight matmul's arithmetic.

``csrc/quant_matmul.cu`` runs bf16 x through two routes whose sums
differ from the plain version's only in order:

- the tensor-core GEMV (``"decode"``) splits K into ``ksplit`` runs of
  whole 64-row tiles (:func:`split_bounds`); each split's block forms
  the f32 sum of its exact bf16 x int8 products, and the splits are
  added in split order before the scale and the one cast;
- the ``wgmma`` GEMM (``"prefill"``) is one split.

Inside a split the tensor cores add the products in an order of their
own; every partial is still an f32 sum of exact products, which is what
the tolerances allow for.  :func:`split_model` computes that on the
CPU, and :func:`widen_pair` is the byte trick that widens int8 to bf16
in the kernels (two LOP3s and an HSUB2 on a 32-bit word), so the tests
can hold both against the JAX package.
"""
from __future__ import annotations

import torch

from ..ops.kernels import quant_matmul as qm


def split_bounds(K, ksplit, tile_k=qm.TILE_K):
    """[(k0, k1)] of each split: ``nk = ceil(K / tile_k)`` tiles dealt as
    in the kernel, ``nk // ksplit`` to each split and one more to each of
    the first ``nk % ksplit``; the last tile is ragged."""
    nk = -(-K // tile_k)
    lo, rem = divmod(nk, ksplit)
    starts = [z * lo + min(z, rem) for z in range(ksplit + 1)]
    return [(starts[z] * tile_k, min(K, starts[z + 1] * tile_k))
            for z in range(ksplit)]


def split_model(x, qweight, scale, ksplit=1):
    """``cast((sum over splits, in order, of the f32 partial) * scale)``:
    each partial sums exact products (a bf16 or f32 x times an int8
    weight is exact in f32).  x [M, K]; qweight int8 [K, N]; scale f32
    [N]."""
    xf = x.to(torch.float32)
    wf = qweight.to(torch.float32)
    total = None
    for k0, k1 in split_bounds(x.shape[1], ksplit):
        part = xf[:, k0:k1] @ wf[k0:k1]
        total = part if total is None else total + part
    return (total * scale.reshape(1, -1).to(torch.float32)).to(x.dtype)


def model_for(x, qweight, scale, sms=132):
    """:func:`split_model` with the split the wrapper gives a CUDA call of
    these shapes on a card with ``sms`` SMs."""
    M, K = x.shape
    kind = qm.route(M, K, qweight.shape[1], x.dtype)
    ksplit = qm.decode_split(K, qweight.shape[1], sms) \
        if kind == "decode" else 1
    return split_model(x, qweight, scale, ksplit)


def widen_pair(words):
    """The kernels' ``widen_pair`` on int64 tensors of 32-bit words:
    bytes 0 and 2 of each word as two bf16 values (byte 0 first), built
    as ``(128 + (b & 127)) - (128, or 256 when b's sign bit is set)``
    from bf16 bit patterns.  Returns bf16 [..., 2]."""
    words = words.to(torch.int64)
    mag = (words & 0x007F007F) | 0x43004300
    off = (words & 0x00800080) | 0x43004300

    def halves(v):
        h = torch.stack([v & 0xFFFF, (v >> 16) & 0xFFFF], dim=-1)
        h = torch.where(h >= 0x8000, h - 0x10000, h)   # as int16 bits
        return h.to(torch.int16).view(torch.bfloat16)

    return halves(mag) - halves(off)
