"""Counterpart of ``paddle_tpu/incubate``: the MoE layer
(``incubate.distributed.models.moe``), the fused transformer layers and
fused functional ops (``incubate.nn``), the functional higher-order
autograd (``incubate.autograd``), ``ExponentialMovingAverage``,
``LookAhead``, ``ModelAverage``, ``softmax_mask_fuse``,
``softmax_mask_fuse_upper_triangle`` and ``identity_loss``.  The
reference's geometric re-exports (``segment_*``, ``graph_*``) come with
``paddle.geometric`` (ROADMAP.md Queue 1, item 9h)."""
from __future__ import annotations

import torch

from . import autograd  # noqa: F401
from . import nn  # noqa: F401
from .ema import ExponentialMovingAverage  # noqa: F401


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis (reference
    incubate/operators/softmax_mask_fuse.py), as the op
    ``softmax_mask_fuse``."""
    from ..ops import registry

    return registry.cached_apply(
        "softmax_mask_fuse",
        lambda x, mask: torch.softmax(x + mask, dim=-1), x, mask)


def _causal_softmax(x):
    S = x.shape[-1]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    return torch.softmax(
        torch.where(causal, x, torch.finfo(x.dtype).min), dim=-1)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal softmax over the last axis: the entries above the diagonal
    of the last two axes are masked (reference
    incubate/operators/softmax_mask_fuse_upper_triangle.py)."""
    from ..ops import registry

    return registry.cached_apply("softmax_mask_fuse_ut", _causal_softmax,
                                 x)


def identity_loss(x, reduction="none"):
    """``x`` reduced by ``reduction`` ("none"/2, "sum"/1, "mean"/0;
    reference incubate/nn/loss.py:36)."""
    from .. import ops

    if reduction in ("none", 2):
        return x
    if reduction in ("sum", 1):
        return ops.sum(x)
    if reduction in ("mean", 0):
        return ops.mean(x)
    raise ValueError(f"unknown reduction {reduction!r}")


class LookAhead:
    """Lookahead around an optimizer: every ``k`` fast steps,
    ``slow += alpha * (fast - slow)`` and ``fast = slow`` (reference
    incubate/optimizer/lookahead.py:27).  The slow copy keeps the
    parameter's dtype."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if inner_optimizer is None:
            raise ValueError("inner optimizer cannot be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha should be in [0, 1]")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_count = 0
        self._slow = {}

    def _params(self):
        return self.inner_optimizer._parameter_list()

    @torch.no_grad()
    def step(self):
        for p in self._params():
            if id(p) not in self._slow:
                self._slow[id(p)] = p.detach().clone()
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for p in self._params():
                slow = self._slow[id(p)]
                slow = slow + self.alpha * (p.detach().to(slow.dtype)
                                            - slow)
                self._slow[id(p)] = slow
                p.copy_(slow.to(p.dtype))

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        return {"inner": self.inner_optimizer.state_dict(),
                "step": self._step_count}


class ModelAverage:
    """Windowed parameter averaging with ``apply()`` / ``restore()``
    (reference incubate/optimizer/modelaverage.py: two rolling fp32
    sums, the current window's and the previous one's)."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self.rate = float(average_window_rate)
        self.min_w = int(min_average_window)
        self.max_w = int(max_average_window)
        self._params = list(parameters or [])
        self._sum1 = {}
        self._sum2 = {}
        self._num = 0
        self._old_num = 0
        self._updates = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        self._updates += 1
        for p in self._params:
            d = p.detach().float()
            self._sum1[id(p)] = self._sum1.get(id(p), 0.0) + d
        self._num += 1
        window = min(self.max_w, int(self._updates * self.rate) or 1)
        if self._num >= self.min_w and self._num >= window:
            for p in self._params:
                self._sum2[id(p)] = self._sum1[id(p)]
                self._sum1[id(p)] = 0.0
            self._old_num = self._num
            self._num = 0

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        """Swap the averaged values in (usable as a context manager)."""
        self._backup = {id(p): p.detach().clone() for p in self._params}
        denom = max(self._num + self._old_num, 1)
        for p in self._params:
            total = self._sum1.get(id(p), 0.0) + \
                self._sum2.get(id(p), 0.0)
            avg = total / denom if self._num + self._old_num else \
                p.detach().float()
            p.copy_(avg.to(p.dtype))
        self._need_restore = need_restore
        return self

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._params:
            p.copy_(self._backup[id(p)])
        self._backup = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if getattr(self, "_need_restore", True):
            self.restore()

    def minimize(self, loss, **kw):
        raise RuntimeError(
            "ModelAverage wraps evaluation, not training: call step() "
            "after the inner optimizer's step()")
