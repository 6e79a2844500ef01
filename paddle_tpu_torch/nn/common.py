"""``Linear`` and ``Embedding`` with ``paddle_tpu``'s parameter layout.

``torch.nn.Linear`` keeps its weight ``[out, in]``; paddle's is
``[in, out]`` and a projection is ``x @ w``.  Keeping paddle's layout
lets a ``paddle_tpu`` state dict load without a transpose.  Parameters
are created empty on the given device (default CUDA, see
``device.resolve_device``); the model fills them from an explicit
``torch.Generator`` (``models.llama.LlamaForCausalLM``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device


class Linear(nn.Module):
    """``y = x @ weight`` with ``weight [in_features, out_features]``, no
    bias (the Llama projections have none)."""

    def __init__(self, in_features, out_features, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=resolve_device(device),
            dtype=dtype))

    def forward(self, x):
        return torch.matmul(x, self.weight)


class Embedding(nn.Module):
    """Rows of ``weight [num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device),
            dtype=dtype))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)
