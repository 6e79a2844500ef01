"""``RMSNorm`` layer.  Counterpart of ``paddle_tpu/nn/norm.py``
``RMSNorm``: a weight of ones on ``device`` (default CUDA, see
``device.resolve_device``), applied through ``nn.functional.rms_norm``
(the fused kernel under ``FLAGS_use_fused_rms_norm``, else the plain
op)."""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, epsilon={self._epsilon}"
