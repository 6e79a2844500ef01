"""``Linear``, ``Embedding`` and ``Dropout`` with ``paddle_tpu``'s
parameter layout and an explicit generator.

``torch.nn.Linear`` keeps its weight ``[out, in]``; paddle's is
``[in, out]`` and a projection is ``x @ w (+ b)``.  Keeping paddle's
layout lets a ``paddle_tpu`` state dict load without a transpose.
Parameters are created empty on the given device (default CUDA, see
``device.resolve_device``); the model fills them from an explicit
``torch.Generator`` (``models.llama.LlamaForCausalLM``,
``models.bert.init_bert_params``).  ``Dropout`` draws its masks from the
``torch.Generator`` it is given, never from the global RNG as
``torch.nn.Dropout`` does.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F


class Linear(nn.Module):
    """``y = x @ weight (+ bias)`` with ``weight [in_features,
    out_features]``.  ``bias=False`` (the default, as the Llama
    projections have none) registers no bias; ``bias=True`` adds one of
    ``[out_features]``, cast to the product's dtype before the add (as
    ``F.linear`` in ``paddle_tpu`` does, so an fp32 bias never promotes a
    bf16 stream)."""

    def __init__(self, in_features, out_features, device=None,
                 dtype=torch.float32, bias=False):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x):
        out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


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


class Dropout(nn.Module):
    """Dropout at rate ``p`` in ``mode`` (``upscale_in_train`` or
    ``downscale_in_infer``), active in training mode, its masks drawn
    from ``generator`` (a ``torch.Generator`` on the inputs' device;
    needed only when ``p`` > 0 and training)."""

    def __init__(self, p=0.5, mode="upscale_in_train", generator=None):
        super().__init__()
        self.p = float(p)
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.mode,
                         self.generator)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"
