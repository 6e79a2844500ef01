"""``RMSNorm`` and ``LayerNorm`` layers.  Counterparts of
``paddle_tpu/nn/norm.py`` ``RMSNorm`` and ``LayerNorm``: weights of ones
(and a bias of zeros) on ``device`` (default CUDA, see
``device.resolve_device``), applied through ``nn.functional``
(``rms_norm``: the fused kernel under ``FLAGS_use_fused_rms_norm``, else
the plain op; ``layer_norm``: the plain op)."""
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


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with a weight and a bias of
    ``[normalized_shape]``; ``epsilon`` defaults to 1e-5, as in
    ``paddle_tpu`` (BERT's embeddings pass 1e-12, its encoder layers keep
    the default)."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        if not isinstance(normalized_shape, int):
            (normalized_shape,) = normalized_shape
        device = resolve_device(device)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, epsilon={self._epsilon}"
