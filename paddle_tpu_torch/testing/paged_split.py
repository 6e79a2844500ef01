"""A plain model of the paged-decode kernels' split rule.

``csrc/paged_decode.cu`` cuts each sequence's page window into the
splits of :func:`~paddle_tpu_torch.ops.kernels.paged_decode.split_plan`,
computes one partial per split — the running max ``m`` of the scores
under the length, ``l = sum exp(s - m)`` and ``acc = sum exp(s - m) v``
— and merges the partials in split order:

    M   = max_s m_s
    out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s

Splits that start at or past a length take no part (the kernel writes
nothing for them), a length of 0 gives zeros, lengths above the window
are clamped, and rows at or past a length are left out, never multiplied
by p = 0 (so NaN there cannot reach the output).  Over int8 pages the
page's k scale multiplies the dot and its v scale the probability, as
in the kernel.  The kernel takes exp2 with log2(e) folded into q's
scale, which changes rounding only.

This is a test model: the tests hold it against ``paddle_tpu``'s Pallas
kernels in interpret mode, and the card holds the kernel against the
plain versions of ``ops/kernels/paged_decode.py``.
"""
from __future__ import annotations

import math

import torch

from ..ops.kernels.paged_decode import split_plan


def split_partials(q, k_pages, v_pages, lengths, page_indices, k_scales=None,
                   v_scales=None, scale=None, split_tokens=None):
    """The kernel's per-split partials, fp32.

    q [B, H, D]; k/v_pages [KV, P, ps, D] (int8 with k/v_scales [KV, P]);
    lengths [B]; page_indices [B, pps].  Returns (m, l, acc, active):
    m and l [B, KV, n_split, G], acc [B, KV, n_split, G, D], and active
    [B, n_split], true where a split starts under the length (elsewhere
    m = -inf and l = acc = 0, the values no block writes)."""
    B, H, D = q.shape
    KV, _, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    G = H // KV
    plan = split_plan(B, KV, G, D, ps, pps, split_tokens)
    st, n_split = plan["split_tokens"], plan["n_split"]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    T = n_split * st                                  # padded window
    lens = lengths.long().clamp(0, pps * ps)
    idx = page_indices.long()
    pad = n_split * plan["split_pages"] - pps
    if pad:      # pages past the window: their rows are past every length
        idx = torch.cat([idx, idx[:, :1].expand(B, pad)], 1)

    def window(pages):
        w = pages[:, idx].float()                     # [KV, B, n, ps, D]
        return w.transpose(0, 1).reshape(B, KV, n_split, st, D)

    kw, vw = window(k_pages), window(v_pages)
    if k_scales is not None:
        ks = k_scales[:, idx].float().transpose(0, 1)   # [B, KV, n]
        vs = v_scales[:, idx].float().transpose(0, 1)
        ks = ks.repeat_interleave(ps, -1).reshape(B, KV, n_split, st)
        vs = vs.repeat_interleave(ps, -1).reshape(B, KV, n_split, st)
    tok = torch.arange(T).reshape(n_split, st)
    valid = tok[None] < lens[:, None, None]          # [B, n_split, st]
    qg = q.reshape(B, KV, G, D).float() * scale
    # rows past the length are zeroed before any product: skipped
    kw = torch.where(valid[:, None, ..., None], kw, 0.0)
    vw = torch.where(valid[:, None, ..., None], vw, 0.0)
    s = torch.einsum("bkgd,bkntd->bkngt", qg, kw)    # [B, KV, n, G, st]
    if k_scales is not None:
        s = s * ks[:, :, :, None]
    s = torch.where(valid[:, None, :, None], s, -math.inf)
    m = s.amax(-1)                                   # [B, KV, n, G]
    active = valid.any(-1)                           # [B, n_split]
    e = torch.where(valid[:, None, :, None],
                    torch.exp(s - torch.where(torch.isinf(m), 0.0, m)
                              [..., None]), 0.0)
    l = e.sum(-1)
    pv = e * vs[:, :, :, None] if k_scales is not None else e
    acc = torch.einsum("bkngt,bkntd->bkngd", pv, vw)
    return m, l, acc, active


def merge_splits(m, l, acc, active):
    """Merges the partials of :func:`split_partials` in split order, only
    the active ones: [B, KV, G, D] fp32, zeros where none is active."""
    B, KV, n_split, G = m.shape
    live = active[:, None, :, None]                  # [B, 1, n, 1]
    M = torch.where(live, m, -math.inf).amax(2, keepdim=True)
    w = torch.where(live, torch.exp(m - torch.where(torch.isinf(M), 0.0, M)),
                    0.0)
    num = torch.zeros(B, KV, G, acc.shape[-1])
    den = torch.zeros(B, KV, G)
    for s in range(n_split):                         # fixed split order
        num = num + w[:, :, s, :, None] * acc[:, :, s]
        den = den + w[:, :, s] * l[:, :, s]
    return num / den.clamp_min(1e-30)[..., None]    # 0 / tiny where none


def paged_decode_split_model(q, k_pages, v_pages, lengths, page_indices,
                             k_scales=None, v_scales=None, scale=None,
                             split_tokens=None):
    """Decode attention computed by the kernels' split rule: [B, H, D] in
    q's dtype (the partials and their merge in fp32, one cast at the
    end).  Arguments as :func:`split_partials`."""
    B, H, D = q.shape
    out = merge_splits(*split_partials(q, k_pages, v_pages, lengths,
                                       page_indices, k_scales, v_scales,
                                       scale, split_tokens))
    return out.reshape(B, H, D).to(q.dtype)
