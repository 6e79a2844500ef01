"""Plain PyTorch versions of the elementwise ops on the serving path.

Counterparts of ``paddle_tpu/ops/nn_ops.py`` ``_rms_norm_plain`` and
``_rope_plain``, with the same dtype rules, so a bf16 stream rounds at
the same places in both packages.  The serving programs of
``paddle_tpu`` call these plain versions, not a kernel, so neither has
a kernel here.
"""
from __future__ import annotations

import torch


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis: computed in fp32, cast back to
    ``x.dtype``, then multiplied by ``weight`` cast to ``x.dtype`` (an
    fp32 weight must not promote a bf16 activation stream)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(dt)
    if weight is not None:
        out = out * weight.to(dt)
    return out


def rope(q, k, cos, sin, position_ids):
    """Half-split (neox) rotary embedding on ``[B, S, H, D]`` q and k.

    ``cos``/``sin`` are fp32 ``[S_max, D]`` tables and ``position_ids``
    ``[B, S]`` selects their rows.  As in jnp, a bf16 ``q`` times the
    fp32 table promotes: the outputs are fp32."""
    c = cos[position_ids][:, :, None, :]     # [B, S, 1, D]
    s = sin[position_ids][:, :, None, :]

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    return q * c + rot(q) * s, k * c + rot(k) * s
