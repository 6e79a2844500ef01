"""The MoE layer on one device.  Counterpart of ``paddle_tpu/incubate/
distributed/models/moe/moe_layer.py`` in its ``dispatch_mode="gspmd"``
mode without a mesh: stacked experts ``[E, ...]``, a gate, and one of two
routes (``moe_impl`` / ``PT_MOE_IMPL``, see ``distributed.utils.
moe_utils.resolve_moe_impl``):

* fused (``_forward_fused_dense``): sort dispatch, tokens gathered into
  ``[E, C, H]`` buckets, the grouped expert FFN (``grouped_ffn``: the
  hand-written kernel for CUDA tensors), outputs gathered back and
  weighted by the gate;
* einsum: dense ``[T, E, C]`` masks and ``ExpertFFN``'s batched matmuls.

Parameter names are ``paddle_tpu``'s (``gate.wg``, ``experts.w1``,
``experts.b1``, ``experts.w2``, ``experts.b2``), so ``models.convert.
load_numpy_state`` loads its ``state_dict()`` as it is.  Not ported, and
refused with ``NotImplementedError``: ``dispatch_mode="alltoall"``, a
``mesh``, per-expert layer lists (ROADMAP.md Queue 1, item 9).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .....device import resolve_device
from .....distributed.utils import moe_utils as _mu
from .....nn.initializer import seeded_generator, xavier_uniform_, zeros_
from .....ops.kernels.grouped_gemm import einsum_ffn, grouped_ffn
from .....ops.nn_ops import einsum
from .gate import GShardGate, NaiveGate, SwitchGate

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1, item 9)"


class ExpertFFN(nn.Module):
    """Stacked expert FFN: w1 ``[E, H, F]``, b1 ``[E, 1, F]``, w2 ``[E, F,
    H]``, b2 ``[E, 1, H]``; weights Xavier-uniform from ``generator``,
    biases zero."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu",
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device,
                                            dtype=dtype))

        self.w1 = param(num_experts, d_model, d_hidden)
        self.b1 = param(num_experts, 1, d_hidden)
        self.w2 = param(num_experts, d_hidden, d_model)
        self.b2 = param(num_experts, 1, d_model)
        generator = generator or seeded_generator(device)
        xavier_uniform_(self.w1, generator)
        zeros_(self.b1)
        xavier_uniform_(self.w2, generator)
        zeros_(self.b2)
        self.activation = activation

    def forward(self, x):
        """x ``[E, C, H] -> [E, C, H]``: two batched matmuls."""
        return einsum_ffn(x, self.w1, self.b1, self.w2, self.b2,
                          self.activation)


class MoELayer(nn.Module):
    """``MoELayer(d_model, d_hidden, num_experts, gate=..., top_k,
    capacity_factor)``; ``forward([B, S, H]) -> [B, S, H]``, with
    ``gate.loss`` holding the load-balance loss.  ``gate`` is a name
    (``"gshard"`` by default, ``"switch"``, ``"naive"``) or a gate module.
    The parameters are made on ``device`` (default CUDA) in ``dtype`` and
    filled from a generator seeded with ``seed`` (None: 0), gate first;
    ``load_numpy_state`` overwrites them with ``paddle_tpu``'s."""

    def __init__(self, d_model, d_hidden=None, num_experts=8, experts=None,
                 gate=None, top_k=2, capacity_factor=1.25, moe_group=None,
                 mp_group=None, activation="gelu", recompute_interval=0,
                 mesh=None, ep_axis="ep", dispatch_mode="gspmd",
                 moe_impl=None, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        if dispatch_mode != "gspmd":
            raise NotImplementedError(
                f"MoELayer(dispatch_mode={dispatch_mode!r}) {_NOT_PORTED}")
        if mesh is not None:
            raise NotImplementedError(f"MoELayer(mesh=...) {_NOT_PORTED}")
        if isinstance(experts, (list, tuple)):
            raise NotImplementedError(
                f"MoELayer with a per-expert layer list {_NOT_PORTED}")
        device = resolve_device(device)
        self.d_model = d_model
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.moe_impl = moe_impl
        generator = seeded_generator(device, seed or 0)
        if gate is None:
            gate = "gshard"
        if isinstance(gate, str):
            gate = {"naive": NaiveGate, "gshard": GShardGate,
                    "switch": SwitchGate}[gate](
                d_model, num_experts, topk=top_k, device=device,
                dtype=dtype, generator=generator)
        self.gate = gate
        self.top_k = getattr(gate, "topk", top_k)
        self.experts = experts or ExpertFFN(
            num_experts, d_model, d_hidden or 4 * d_model, activation,
            device=device, dtype=dtype, generator=generator)

    def forward(self, x):
        B, S, H = x.shape
        T = B * S
        E = self.num_experts
        tokens = x.reshape(T, H)
        probs, topk_idx, _ = self.gate(tokens)
        # slots per expert, host arithmetic
        C = min(T, max(1, int(math.ceil(T * self.capacity_factor
                                        * self.top_k / E))))
        p = probs.detach()
        k = topk_idx.shape[-1]
        impl = _mu.resolve_moe_impl(H, self.moe_impl,
                                    x.device.type == "cuda")
        if impl == "fused":
            plan = _mu.sort_dispatch(topk_idx, E, C)
            keep = plan["keep"]
        else:
            dispatch, slot_mask, keep = _mu.dispatch_masks(p, topk_idx, E, C)
            dispatch, slot_mask = dispatch.to(p.dtype), slot_mask.to(p.dtype)

        # the differentiable path: gate weights from probs, the experts,
        # the combine
        gate_w = torch.gather(probs, -1, topk_idx)           # [T, k]
        if k > 1:
            denom = torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
            gate_w = gate_w / denom
        gate_w = gate_w * keep.to(p.dtype)

        if impl == "fused":
            return self._forward_fused_dense(tokens, gate_w, plan, B, S, H,
                                             C)
        expert_in = einsum("tec,th->ech", dispatch, tokens)
        expert_out = self.experts(expert_in)
        slot_out = einsum("ech,tkec->tkh", expert_out,
                          slot_mask.to(expert_out.dtype))
        out = einsum("tkh,tk->th", slot_out, gate_w.to(expert_out.dtype))
        return out.reshape(B, S, H)

    def _forward_fused_dense(self, tokens, gate_w, plan, B, S, H, C):
        """Tokens gathered into ``[E, C, H]`` buckets, the grouped expert
        FFN, outputs gathered back to token order.  No ``[T, E, C]`` mask
        is built."""
        E = self.num_experts
        T, k = plan["slot"].shape
        e = self.experts
        filled = plan["filled"][:, None].to(tokens.dtype)
        expert_in = (tokens.index_select(0, plan["src_tok"])
                     * filled).reshape(E, C, H)
        expert_out = grouped_ffn(expert_in, e.w1, e.b1, e.w2, e.b2,
                                 activation=e.activation)
        picked = expert_out.reshape(E * C, H).index_select(
            0, plan["slot"].reshape(T * k)).reshape(T, k, H)
        out = einsum("tkh,tk->th", picked, gate_w.to(tokens.dtype))
        return out.reshape(B, S, H)
