"""``Linear``, ``Embedding`` and ``Dropout`` with ``paddle_tpu``'s
parameter layout and an explicit generator; the activation layers
``Silu``, ``GELU``, ``Softmax``, ``ReLU6``, ``Hardswish``,
``Hardsigmoid`` and ``Swish``, and ``Upsample``.

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

from ..amp.state import amp_op, cast
from ..device import resolve_device
from . import functional as F


@amp_op("matmul")
def _matmul(x, w):
    """``x @ w`` with jnp's promotion of two float dtypes (the
    reference's ``matmul`` op; under AMP both come cast by the policy)."""
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w)


class Linear(nn.Module):
    """``y = x @ weight (+ bias)`` with ``weight [in_features,
    out_features]``.  ``bias=False`` (the default, as the Llama
    projections have none) registers no bias; ``bias=True`` adds one of
    ``[out_features]``, cast to the product's dtype before the add (as
    ``F.linear`` in ``paddle_tpu`` does, so an fp32 bias never promotes a
    bf16 stream).  x and a weight of two float dtypes meet in jnp's
    promotion, as ``ops.nn_ops.einsum``'s operands do: an fp32 x times a
    bf16 weight computes in fp32 (a UNet step under bf16 compute feeds
    its bf16 ``time_mlp1`` an fp32 embedding), where ``torch.matmul``
    would refuse the pair."""

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
        out = _matmul(x, self.weight)
        if self.bias is not None:
            out = out + cast(self.bias, out.dtype)
        return out


def embedding_grad(ids, grad, num_embeddings, dtype):
    """The gradient of ``weight [num_embeddings, h]`` under ``weight[ids]``
    for the output gradient ``grad [..., h]``, the same bits on every
    run.  The library's CUDA backward sums the rows of a repeated id in
    no fixed order (atomics: a BERT step's token-type rows, one id
    18432 times, differ from run to run in fp32).  Here the ids are
    sorted (stably), the gradient rows taken in that order are summed
    as an fp64 running sum, and each id's sum is the difference of the
    running sum at its last and before its first row, rounded once to
    ``dtype`` and written at its row.  Every size is fixed by the
    inputs (no host synchronisation), so a CUDA graph can hold it."""
    flat = ids.reshape(-1).long()
    h = grad.shape[-1]
    sid, order = torch.sort(flat, stable=True)
    # [h, N]: the running sum along the last axis, which CUDA scans in
    # parallel per row (along the first it walks each column alone)
    rows = grad.reshape(-1, h).index_select(0, order).double()
    run = torch.cumsum(rows.t().contiguous(), 1)
    first = torch.searchsorted(sid, sid)
    before = run.index_select(1, (first - 1).clamp(min=0))
    before.masked_fill_((first == 0)[None, :], 0.0)
    last = torch.ones_like(sid, dtype=torch.bool)
    last[:-1] = sid[1:] != sid[:-1]
    # rows that end no run of ids go to a spare row past the table
    dst = torch.where(last, sid, num_embeddings)
    out = torch.zeros(num_embeddings + 1, h, dtype=dtype, device=grad.device)
    out.index_copy_(0, dst, (run - before).t().to(dtype))
    return out[:num_embeddings]


class _EmbeddingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.table = (weight.shape[0], weight.dtype)
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return None, embedding_grad(ids, grad, *ctx.table)


class Embedding(nn.Module):
    """Rows of ``weight [num_embeddings, embedding_dim]``; the backward is
    ``embedding_grad``'s, the same bits on every run."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device),
            dtype=dtype))

    def forward(self, ids):
        return _EmbeddingFn.apply(ids, self.weight)


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


class Silu(nn.Module):
    """``x * sigmoid(x)`` (``F.silu``)."""

    def forward(self, x):
        return F.silu(x)


class GELU(nn.Module):
    """GELU (``F.gelu``); ``approximate=True`` is not ported yet."""

    def __init__(self, approximate=False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class ReLU6(nn.Module):
    """``F.relu6``."""

    def forward(self, x):
        return F.relu6(x)


class Hardswish(nn.Module):
    """``F.hardswish``."""

    def forward(self, x):
        return F.hardswish(x)


class Hardsigmoid(nn.Module):
    """``F.hardsigmoid`` (slope 1/6, offset 0.5)."""

    def forward(self, x):
        return F.hardsigmoid(x)


class Swish(nn.Module):
    """``F.swish``."""

    def forward(self, x):
        return F.swish(x)


class Softmax(nn.Module):
    """Softmax along ``axis`` (``F.softmax``)."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class Upsample(nn.Module):
    """``F.interpolate`` to ``size`` or by ``scale_factor`` (``"nearest"``:
    the reference's index rule, torch's ``"nearest-exact"``)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW"):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners,
                             data_format=self.data_format)
