"""Dynamic loss scaling.  Counterpart of ``paddle_tpu/amp/grad_scaler.py``:
``scale`` multiplies the loss in its own dtype (``ops.scale``: bf16 under
O2, where the loss is bf16), ``unscale_`` multiplies every gradient by
the inverse scale in the gradient's dtype and finds whether any is not
finite, ``step`` skips the optimizer's update on a found inf, ``update``
moves the schedule (decay by ``decr_ratio`` after
``decr_every_n_nan_or_inf`` bad steps, floored at 1; growth by
``incr_ratio`` after ``incr_every_n_steps`` good ones).

The reference reads ``isfinite`` per parameter, one host read each; here
one reduction over all gradients gives the same ``found_inf`` with one
host read a step.  The scale and the counters are host numbers, as in
the reference.
"""
from __future__ import annotations

import torch

from .state import amp_op, no_amp


@amp_op("scale")
def _scale(var, scale):
    return var * scale


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable:
            return var
        return _scale(var, self._scale)

    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        grads = [p.grad for p in optimizer._parameter_list()
                 if p.grad is not None]
        found = False
        if grads:
            with no_amp(), torch.no_grad():
                torch._foreach_mul_(grads, inv)
                finite = torch.stack([torch.isfinite(g).all()
                                      for g in grads])
                found = not bool(finite.all())
        self._found_inf = found
        self._unscaled = True

    def mark_found_inf(self):
        """Force found_inf for the current step (the training guardian's
        skip-step): the next ``step`` skips the optimizer's update and
        ``update`` moves the schedule as for a non-finite gradient."""
        if not self._enable:
            return
        self._found_inf = True
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
