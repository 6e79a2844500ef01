"""Gradient clipping.  Counterpart of ``paddle_tpu/nn/clip.py``:
``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm`` (an
optimizer's ``grad_clip``: called on its ``(param, grad)`` pairs before
the update, parameters with ``need_clip = False`` left alone) and
``clip_grad_norm_``.  Norms in fp32, each clipped gradient rounded back
to its own dtype, as the reference does."""
from __future__ import annotations

import torch


def _skip(p, g):
    return g is None or not getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g if _skip(p, g) else
                 torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            g32 = g.to(torch.float32)
            norm = torch.sqrt(torch.sum(torch.square(g32)))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, (g32 * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        sq = None
        for p, g in params_grads:
            if _skip(p, g):
                continue
            s = torch.sum(torch.square(g.to(torch.float32)))
            sq = s if sq is None else sq + s
        if sq is None:
            return params_grads
        global_norm = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [(p, g if _skip(p, g) else
                 (g.to(torch.float32) * scale).to(g.dtype))
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    params = [parameters] if not isinstance(parameters, (list, tuple)) \
        else list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros([], dtype=torch.float32)
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(g))
                                       for g in grads]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(torch.abs(g.to(torch.float32)) ** norm_type)
             for g in grads])) ** (1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        if p.grad is not None:
            p.grad = p.grad * coef.to(p.grad.dtype)
    return total
