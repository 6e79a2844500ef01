"""MoE routing and the single-device MoE body.  Counterpart of
``paddle_tpu/distributed/utils/moe_utils.py``.

Two dispatch implementations, as in ``paddle_tpu`` (``impl`` /
``PT_MOE_IMPL`` in {auto, fused, einsum}):

* ``einsum``: the GShard mask formulation, one-hot contractions over
  dense ``dispatch [T, E, C]`` and ``slot_mask [T, k, E, C]`` masks
  (:func:`dispatch_masks`).
* ``fused``: sort-based dispatch (:func:`sort_dispatch`): a stable sort of
  the flat ``(t, k)`` expert ids, within-expert positions from
  ``searchsorted`` offsets, the capacity clip, and gathers of the tokens
  into ``[E, C, H]`` buckets (:func:`fused_dispatch`) and of the expert
  outputs back (:func:`fused_combine`).  The expert FFN then runs through
  ``ops.kernels.grouped_gemm.grouped_ffn``, the hand-written kernel for
  CUDA tensors.

``auto`` takes ``fused`` for CUDA tensors when H is a multiple of 128, and
``einsum`` on the CPU.  Both drop the same overflow slots: the stable
sort keeps the flat ``(t, k)`` order within an expert, the order the
einsum path's cumsum counts.

Expert parallelism (``global_scatter`` / ``global_gather`` and
:func:`ep_moe_local` with an axis name) is not ported: it raises
``NotImplementedError`` (ROADMAP.md Queue 1, item 9).
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ...ops.kernels.grouped_gemm import einsum_ffn, grouped_ffn
from ...ops.manipulation import topk
from ...ops.nn_ops import einsum

_EP = ("expert parallelism over torch.distributed is not ported yet "
       "(ROADMAP.md Queue 1, item 9)")


def global_scatter(expert_in, axis_name, n):
    raise NotImplementedError(f"global_scatter: {_EP}")


def global_gather(expert_out, axis_name, n):
    raise NotImplementedError(f"global_gather: {_EP}")


def dispatch_masks(probs, idx, num_experts, capacity):
    """Capacity-clipped routing masks from gate decisions.

    probs ``[T, E]``; idx ``[T, k]`` top-k expert ids.  Returns (dispatch
    ``[T, E, C]``, slot_mask ``[T, k, E, C]``, keep ``[T, k]``), fp32 masks
    without gradient."""
    T, E = probs.shape
    assert E == num_experts, (E, num_experts)
    k = idx.shape[-1]
    C = capacity
    f32 = torch.float32
    assign = F.one_hot(idx.long(), E).to(f32)               # [T, k, E]
    assign_te = assign.reshape(T * k, E)
    pos_in_e = torch.cumsum(assign_te, dim=0) - 1.0
    pos = (pos_in_e * assign_te).sum(-1).reshape(T, k)
    keep = pos < C
    pos = pos.clamp(0, C - 1).long()
    cap_onehot = F.one_hot(pos, C).to(f32)                  # [T, k, C]
    assign_kept = assign * keep[..., None].to(f32)
    dispatch = torch.einsum("tke,tkc->tec", assign_kept, cap_onehot)
    slot_mask = torch.einsum("tke,tkc->tkec", assign_kept, cap_onehot)
    return dispatch.detach(), slot_mask.detach(), keep


def resolve_moe_impl(hidden, impl=None, accelerated=False):
    """``"fused"`` or ``"einsum"``.  ``impl`` / ``PT_MOE_IMPL`` in {auto,
    fused, einsum}; auto = fused on an accelerator (``accelerated``: CUDA
    tensors) when H is a multiple of 128, einsum otherwise."""
    impl = (impl or os.environ.get("PT_MOE_IMPL", "auto")).lower()
    if impl not in ("auto", "fused", "einsum"):
        raise ValueError(
            f"PT_MOE_IMPL={impl!r}: expected auto|fused|einsum")
    if impl == "auto":
        return "fused" if (accelerated and hidden % 128 == 0) else "einsum"
    return impl


def sort_dispatch(idx, num_experts, capacity):
    """Sort-based routing plan from top-k expert ids ``[T, k]``.

    Returns a dict of index tensors (no gradient), element for element
    ``paddle_tpu``'s:

      src_tok [E*C] int32  token filling each expert slot (0 if empty)
      filled  [E*C] bool   the slot holds a token
      slot    [T, k] int32 expert slot of each (token, choice) (0 if
                           dropped: mask with ``keep``)
      keep    [T, k] bool  the choice survived the capacity clip

    One stable sort of the flat ids carrying their positions, positions
    within an expert from ``searchsorted`` offsets, the capacity clip,
    then index writes.  ``.at[...].set(mode="drop")`` becomes a write into
    an ``E*C + 1`` buffer whose last slot, where every dropped entry
    lands, is cut off."""
    T, k = idx.shape
    E, C = num_experts, capacity
    tk = T * k
    dev = idx.device
    e_flat = idx.reshape(tk).long()
    flat_pos = torch.arange(tk, device=dev)
    se, sflat = torch.sort(e_flat, stable=True)
    starts = torch.searchsorted(se, torch.arange(E, device=dev),
                                side="left")
    pos = flat_pos - starts[se]
    keep_s = pos < C
    slot_s = se * C + torch.clamp(pos, max=C - 1)
    slot_write = torch.where(keep_s, slot_s, E * C)
    src_tok = torch.zeros(E * C + 1, dtype=torch.int32, device=dev)
    src_tok[slot_write] = torch.div(sflat, k, rounding_mode="floor").int()
    filled = torch.zeros(E * C + 1, dtype=torch.bool, device=dev)
    filled[slot_write] = True
    slot_f = torch.zeros(tk, dtype=torch.int32, device=dev)
    slot_f[sflat] = torch.where(keep_s, slot_s, 0).int()
    keep_f = torch.zeros(tk, dtype=torch.bool, device=dev)
    keep_f[sflat] = keep_s
    return {"src_tok": src_tok[:E * C], "filled": filled[:E * C],
            "slot": slot_f.reshape(T, k), "keep": keep_f.reshape(T, k)}


def fused_dispatch(tokens, plan, capacity):
    """Gather tokens into ``[E, C, H]`` expert buckets, empty slots zeroed.
    Differentiable w.r.t. tokens (the gather's backward is a scatter-add,
    with atomics on CUDA)."""
    H = tokens.shape[-1]
    picked = tokens.index_select(0, plan["src_tok"])         # [E*C, H]
    picked = picked * plan["filled"][:, None].to(tokens.dtype)
    return picked.reshape(-1, capacity, H)


def fused_combine(y, plan, gate_w):
    """Gather expert outputs ``y [E, C, H]`` back to token order, weighted
    by the (keep-masked) gate weights ``[T, k]``."""
    T, k = plan["slot"].shape
    y_flat = y.reshape(-1, y.shape[-1])                      # [E*C, H]
    picked = y_flat.index_select(0, plan["slot"].reshape(T * k))
    return torch.einsum("tkh,tk->th", picked.reshape(T, k, -1),
                        gate_w.to(y.dtype))


def _aux_loss(probs, idx, num_experts, kind, axis_name=None):
    """GShard/Switch load-balance loss ``E * sum_e(me * ce)`` in fp32."""
    if axis_name is not None:
        raise NotImplementedError(f"_aux_loss over an axis: {_EP}")
    if kind == "naive":
        return torch.zeros((), dtype=torch.float32, device=probs.device)
    p32 = probs.to(torch.float32)
    me = p32.mean(0)
    ce = F.one_hot(idx[:, 0].long(), num_experts).to(torch.float32).mean(0)
    return (me * ce).sum() * num_experts


def ep_moe_local(tokens, wg, w1, b1, w2, b2, *, axis_name, n, num_experts,
                 top_k, capacity, activation, gate_kind, impl=None):
    """The MoE body on one device (``axis_name=None``): fp32 gate, top-k,
    load-balance loss, dispatch, the expert FFN, combine.

    tokens ``[T, H]``; wg ``[H, E]``; w1/b1/w2/b2 the stacked expert
    weights (``[E, H, F]`` etc.), or ``{"qweight", "scale"}`` dicts for
    w1 and w2 (int8 inference through kernel 11 with ``impl="fused"``).
    Returns (out ``[T, H]``, aux loss).  ``capacity`` is computed by the
    caller on the host."""
    if axis_name is not None:
        raise NotImplementedError(f"ep_moe_local(axis_name=...): {_EP}")
    E = num_experts
    logits = tokens.to(torch.float32) @ wg.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    _, idx = topk(probs, top_k)
    aux = _aux_loss(probs, idx, E, gate_kind)

    impl = resolve_moe_impl(tokens.shape[-1], impl,
                            tokens.device.type == "cuda")
    cdt = tokens.dtype
    if impl == "fused":
        plan = sort_dispatch(idx, E, capacity)
        keep = plan["keep"]
        expert_in = fused_dispatch(tokens, plan, capacity)   # [E, C, H]
    else:
        dispatch, slot_mask, keep = dispatch_masks(probs, idx, E, capacity)
        expert_in = einsum("tec,th->ech", dispatch.to(cdt), tokens)

    gate_w = torch.gather(probs, -1, idx)                    # [T, k]
    if top_k > 1:
        denom = torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
        gate_w = gate_w / denom
    gate_w = gate_w * keep.to(gate_w.dtype)

    if impl == "fused":
        y = grouped_ffn(expert_in, w1, b1, w2, b2, activation)
        return fused_combine(y, plan, gate_w), aux
    y = einsum_ffn(expert_in, w1, b1, w2, b2, activation)
    slot_out = einsum("ech,tkec->tkh", y, slot_mask.to(cdt))
    return einsum("tkh,tk->th", slot_out, gate_w.to(cdt)), aux
