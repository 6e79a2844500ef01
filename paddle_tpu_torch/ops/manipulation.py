"""Counterpart of ``paddle_tpu/ops/manipulation.py`` for what the MoE gates
use: :func:`topk`."""
from __future__ import annotations

import torch


def topk(x, k, axis=-1, largest=True, sorted=True):
    """``(values, indices int64)`` of the ``k`` largest (or smallest)
    entries along ``axis``, as ``_topk`` computes them: one stable sort on
    the key (negated for ``largest``), so the lowest index comes first
    among equal values.  ``torch.topk`` promises no order among ties on
    CUDA, and bf16 gate probabilities tie often."""
    xm = x.movedim(axis, -1)
    keys = -xm if largest else xm
    sk, si = torch.sort(keys, dim=-1, stable=True)
    vals = -sk[..., :k] if largest else sk[..., :k]
    return vals.movedim(-1, axis), si[..., :k].movedim(-1, axis)
