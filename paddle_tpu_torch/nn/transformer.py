"""Prebuilt transformer encoder layers.  Counterpart of
``paddle_tpu/nn/transformer.py`` ``MultiHeadAttention``,
``TransformerEncoderLayer`` and ``TransformerEncoder`` (Paddle's
``python/paddle/nn/layer/transformer.py``): q/k/v projections with
biases, attention through ``F.scaled_dot_product_attention`` on the
``[B, S, H, D]`` layout (so the short-attention kernel serves these
layers on the card), post-norm by default and pre-norm with
``normalize_before``.

Parameters are created on ``device`` (default CUDA) and filled by the
model (``models.bert.init_bert_params``).  Every dropout, attention
dropout included, draws from the ``generator`` a layer is given.  Not
ported yet: the decode caches (``Cache``, ``StaticCache``,
``gen_cache``), ``TransformerDecoderLayer``, ``TransformerDecoder`` and
``Transformer`` (ROADMAP.md Queue 1, item 6).
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops
from . import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

_ACTIVATIONS = {"relu": torch.relu, "gelu": nn_ops.gelu}


def _convert_attn_mask(mask):
    """bool mask (True = keep) -> additive fp32 (``finfo(float32).min``
    where dropped); an additive mask passes through."""
    if mask is None or mask.dtype != torch.bool:
        return mask
    return (~mask).to(torch.float32) * torch.finfo(torch.float32).min


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention: ``query [B, Sq, E]``, ``key``/``value``
    ``[B, Sk, kdim/vdim]`` (default: the query), an optional
    ``attn_mask`` (additive, or bool with True = keep; ``[B, Sq, Sk]`` or
    broadcastable to ``[B, H, Sq, Sk]``), attention dropout ``dropout``
    in training from ``generator``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, device=None, generator=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim {embed_dim} must divide "
                             f"num_heads {num_heads}")
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = float(dropout)
        self.generator = generator
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, device, bias=True)
        self.k_proj = Linear(kdim, embed_dim, device, bias=True)
        self.v_proj = Linear(vdim, embed_dim, device, bias=True)
        self.out_proj = Linear(embed_dim, embed_dim, device, bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        B, Sq = query.shape[:2]
        Sk = key.shape[1]
        H, D = self.num_heads, self.head_dim
        q = self.q_proj(query).reshape(B, Sq, H, D)
        k = self.k_proj(key).reshape(B, Sk, H, D)
        v = self.v_proj(value).reshape(B, Sk, H, D)
        mask = _convert_attn_mask(attn_mask)
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(B, Sq, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with a residual and
    a LayerNorm (epsilon 1e-5): after the residual by default (post-norm,
    BERT), before the block with ``normalize_before``.  ``dropout`` acts
    on both residual branches, ``attn_dropout`` (default ``dropout``) on
    the attention probabilities and ``act_dropout`` (default
    ``dropout``) after the activation; all draw from ``generator``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, device=None, generator=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; expected "
                             f"one of {sorted(_ACTIVATIONS)}")
        device = resolve_device(device)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=(attn_dropout if attn_dropout is not None
                                     else dropout),
            device=device, generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, device, bias=True)
        self.linear2 = Linear(dim_feedforward, d_model, device, bias=True)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout = Dropout(dropout, generator=generator)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(act_dropout if act_dropout is not None
                                else dropout, generator=generator)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, src, src_mask=None):
        residual = src
        x = self.norm1(src) if self.normalize_before else src
        x = residual + self.dropout1(self.self_attn(x, attn_mask=src_mask))
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = self.linear2(self.dropout2(self.activation(self.linear1(y))))
        y = residual + self.dropout(y)
        if not self.normalize_before:
            y = self.norm2(y)
        return y


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the layer itself is the
    first), then an optional final ``norm``.  As in ``paddle_tpu``, the
    copies are deep copies, so every layer starts from the first layer's
    weights.  The copies share the first layer's generators (one dropout
    stream for the whole stack), not copies of them."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        shared = {id(g): g for g in (getattr(m, "generator", None)
                                     for m in encoder_layer.modules())
                  if g is not None}
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer, dict(shared))
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
