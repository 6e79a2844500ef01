"""MoE gates.  Counterpart of ``paddle_tpu/incubate/distributed/models/moe/
gate.py``: ``NaiveGate``, ``GShardGate`` (top-2 with the load-balance
loss) and ``SwitchGate`` (top-1 with it).

``forward(x [T, H]) -> (probs [T, E], topk_idx [T, k] int64, loss)``, and
``self.loss`` holds the loss.  The gate weight ``wg [H, E]`` is filled by
Xavier-uniform from an explicit generator.  Under autograd the loss
reaches ``wg``, as ``jax.grad`` through ``paddle_tpu``'s
``CompiledTrainStep`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .....device import resolve_device
from .....nn.initializer import seeded_generator, xavier_uniform_
from .....ops.manipulation import topk
from .....ops.nn_ops import einsum


def softmax(x):
    """Softmax over the last axis as ``jax.nn.softmax`` computes it inside
    a jitted train step.  fp32: ``torch.softmax``.  bf16 (and fp16): the
    shifted logits rounded to x's dtype, their exponentials summed in fp32
    and the sum rounded, the exponentials rounded, then one rounded
    division; with E = 8 bf16 probabilities tie often, and another
    rounding would route other tokens."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    u = torch.exp((x - x.amax(-1, keepdim=True)).float())
    return u.to(x.dtype) / u.sum(-1, keepdim=True).to(x.dtype)


class BaseGate(nn.Module):
    def __init__(self, d_model, num_experts, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.num_experts = num_experts
        self.wg = nn.Parameter(torch.empty(d_model, num_experts,
                                           device=device, dtype=dtype))
        xavier_uniform_(self.wg, generator or seeded_generator(device))
        self.loss = None

    def logits(self, x):
        """``x @ wg``, mixed dtypes promoted as jnp promotes them."""
        return einsum("th,he->te", x, self.wg)


class NaiveGate(BaseGate):
    def __init__(self, d_model, num_experts, topk=2, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(d_model, num_experts, device, dtype, generator)
        self.topk = topk

    def forward(self, x):
        probs = softmax(self.logits(x))
        _, idx = topk(probs, self.topk)
        self.loss = torch.zeros((), dtype=torch.float32, device=x.device)
        return probs, idx, self.loss


def _balance_loss(probs, num_experts):
    """``E * sum_e(me * ce)`` in the probabilities' dtype: me the mean
    probability of expert e, ce the share of tokens whose argmax is e."""
    top1 = torch.argmax(probs, dim=-1)
    me = probs.mean(0)
    ce = F.one_hot(top1, num_experts).to(probs.dtype).mean(0)
    return (me * ce).sum() * num_experts


class GShardGate(BaseGate):
    """Top-2 with the GShard load-balance loss."""

    def __init__(self, d_model, num_experts, topk=2, capacity=(1.2, 2.4),
                 group=None, random_routing=True, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__(d_model, num_experts, device, dtype, generator)
        if topk != 2:
            raise ValueError(f"GShardGate requires topk=2, got {topk}")
        self.topk = 2

    def forward(self, x):
        probs = softmax(self.logits(x))
        self.loss = _balance_loss(probs, self.num_experts)
        _, idx = topk(probs, self.topk)
        return probs, idx, self.loss


class SwitchGate(BaseGate):
    """Top-1 (Switch Transformer) with its load-balance loss."""

    def __init__(self, d_model, num_experts, topk=1, capacity=(1.2, 2.4),
                 group=None, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(d_model, num_experts, device, dtype, generator)
        self.topk = 1

    def forward(self, x):
        probs = softmax(self.logits(x))
        self.loss = _balance_loss(probs, self.num_experts)
        _, idx = topk(probs, 1)
        return probs, idx, self.loss
