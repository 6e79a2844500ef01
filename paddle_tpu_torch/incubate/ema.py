"""Exponential moving average of model parameters.  Counterpart of
``paddle_tpu/incubate/ema.py``: shadow values on the parameters'
device, ``update()`` after each optimizer step (with the reference's
bias correction: the decay ramps as ``min(decay, (1 + t) / (10 + t))``),
``apply()`` / ``restore()`` to swap them in for evaluation."""
from __future__ import annotations

import torch


class ExponentialMovingAverage:
    def __init__(self, parameters, decay=0.999, use_bias_correction=True):
        self._params = list(parameters)
        self._decay = float(decay)
        self._bias_correction = use_bias_correction
        self._step = 0
        self._shadow = {id(p): p.detach().clone() for p in self._params}
        self._backup = None

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay
        if self._bias_correction:
            d = min(self._decay, (1.0 + self._step) / (10.0 + self._step))
        for p in self._params:
            s = self._shadow[id(p)]
            self._shadow[id(p)] = d * s + (1.0 - d) * p.detach().to(s.dtype)

    @torch.no_grad()
    def apply(self):
        """Swap the EMA values into the parameters (for evaluation)."""
        if self._backup is not None:
            raise RuntimeError("apply() called twice without restore()")
        self._backup = {id(p): p.detach().clone() for p in self._params}
        for p in self._params:
            p.copy_(self._shadow[id(p)].to(p.dtype))

    @torch.no_grad()
    def restore(self):
        if self._backup is None:
            raise RuntimeError("restore() without a prior apply()")
        for p in self._params:
            p.copy_(self._backup[id(p)])
        self._backup = None

    def state_dict(self):
        """Shadow values keyed by parameter order, and the step count."""
        out = {f"shadow_{i}": self._shadow[id(p)].detach().cpu().numpy()
               for i, p in enumerate(self._params)}
        out["step"] = self._step
        return out

    def set_state_dict(self, state):
        self._step = int(state.get("step", self._step))
        for i, p in enumerate(self._params):
            key = f"shadow_{i}"
            if key in state:
                self._shadow[id(p)] = torch.as_tensor(state[key]).to(
                    p.device)
