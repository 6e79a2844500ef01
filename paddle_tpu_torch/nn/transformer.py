"""Prebuilt transformer layers.  Counterpart of
``paddle_tpu/nn/transformer.py`` (Paddle's
``python/paddle/nn/layer/transformer.py``): ``MultiHeadAttention`` with
its decode caches, ``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` and the
encoder-decoder ``Transformer``.  q/k/v projections with biases,
attention through ``F.scaled_dot_product_attention`` on the
``[B, S, H, D]`` layout (so a maskless self-attention with Sq == Sk <=
1024 takes the short-attention kernel on the card; masked and cross
attention take the einsum route, as in ``paddle_tpu``), post-norm by
default and pre-norm with ``normalize_before``.

The constructors are the reference's (``weight_attr`` / ``bias_attr``,
which only ``MultiHeadAttention`` passes on to its projections, as in
the reference); ``device`` and ``generator`` are keyword-only.
Parameters are drawn on ``device`` (default: the current place) as the
reference draws them (XavierUniform projections, zero biases, LayerNorm
ones and zeros) from the port's default generator, and a model fills
them again from its own (``models.bert.init_bert_params``).  Every
dropout, attention dropout included, draws from the ``generator`` a
layer is given (default: the port's generator of the input's
device).

Incremental decoding: ``MultiHeadAttention.gen_cache(x)`` starts an
empty fp32 ``Cache`` ``[B, 0, H, d]`` (as the reference's, so a bf16
step is promoted to fp32 when ``torch.cat`` appends it, as
``jnp.concatenate`` does), and ``gen_cache(memory, type=StaticCache)``
(or with a value) projects a fixed K/V once.  ``forward(..., cache=)``
returns ``(out, cache)``, the ``Cache`` grown by the step's K/V.
"""
from __future__ import annotations

import copy

import torch

from ..device import resolve_device
from ..ops import nn_ops
from . import functional as F
from .common import Dropout, LayerList, Linear
from .layers import Layer
from .norm import LayerNorm

_ACTIVATIONS = {"relu": torch.relu, "gelu": nn_ops.gelu}


def _convert_attn_mask(mask):
    """bool mask (True = keep) -> additive fp32 (``finfo(float32).min``
    where dropped); an additive mask passes through."""
    if mask is None or mask.dtype != torch.bool:
        return mask
    return (~mask).to(torch.float32) * torch.finfo(torch.float32).min


class MultiHeadAttention(Layer):
    """Self- or cross-attention: ``query [B, Sq, E]``, ``key``/``value``
    ``[B, Sk, kdim/vdim]`` (default: the query), an optional
    ``attn_mask`` (additive, or bool with True = keep; ``[B, Sq, Sk]`` or
    broadcastable to ``[B, H, Sq, Sk]``), attention dropout ``dropout``
    in training from ``generator``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim {embed_dim} must divide "
                             f"num_heads {num_heads}")
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = float(dropout)
        self.need_weights = need_weights
        self.generator = generator
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     device=device)
        self.q_proj = Linear(embed_dim, embed_dim, **attrs)
        self.k_proj = Linear(kdim, embed_dim, **attrs)
        self.v_proj = Linear(vdim, embed_dim, **attrs)
        self.out_proj = Linear(embed_dim, embed_dim, **attrs)

    class Cache:
        """The incremental self-attention cache: K and V
        ``[B, S_so_far, H, d]``."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        """A fixed K/V ``[B, S, H, d]`` projected once (cross-attention
        over an encoder's memory)."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    def gen_cache(self, key, value=None, type=None):
        """``StaticCache`` of ``key`` / ``value`` (value defaults to key)
        projected by k_proj / v_proj when ``type`` is ``StaticCache`` or
        a value is given; otherwise an empty ``Cache`` of fp32
        ``[B, 0, H, d]`` on key's device."""
        H, D = self.num_heads, self.head_dim
        if type is MultiHeadAttention.StaticCache or value is not None:
            value = key if value is None else value
            B, S = key.shape[:2]
            return MultiHeadAttention.StaticCache(
                self.k_proj(key).reshape(B, S, H, D),
                self.v_proj(value).reshape(B, value.shape[1], H, D))
        empty = torch.zeros((key.shape[0], 0, H, D), dtype=torch.float32,
                            device=key.device)
        return MultiHeadAttention.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        B, Sq = query.shape[:2]
        H, D = self.num_heads, self.head_dim
        q = self.q_proj(query).reshape(B, Sq, H, D)
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            Sk = key.shape[1]
            k = self.k_proj(key).reshape(B, Sk, H, D)
            v = self.v_proj(value).reshape(B, Sk, H, D)
            if isinstance(cache, MultiHeadAttention.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = MultiHeadAttention.Cache(k, v)
        mask = _convert_attn_mask(attn_mask)
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        out = self.out_proj(out.reshape(B, Sq, self.embed_dim))
        return out if cache is None else (out, cache)


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual and
    a LayerNorm (epsilon 1e-5): after the residual by default (post-norm,
    BERT), before the block with ``normalize_before``.  ``dropout`` acts
    on both residual branches, ``attn_dropout`` (default ``dropout``) on
    the attention probabilities and ``act_dropout`` (default
    ``dropout``) after the activation; all draw from ``generator``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
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
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout = Dropout(dropout, generator=generator)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(act_dropout if act_dropout is not None
                                else dropout, generator=generator)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, src, src_mask=None, cache=None):
        """``cache`` (a ``MultiHeadAttention.Cache`` from
        :meth:`gen_cache`) makes the self-attention incremental; the
        layer then returns ``(out, cache)``."""
        residual = src
        x = self.norm1(src) if self.normalize_before else src
        if cache is not None:
            x, cache = self.self_attn(x, attn_mask=src_mask, cache=cache)
        else:
            x = self.self_attn(x, attn_mask=src_mask)
        x = residual + self.dropout1(x)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = self.linear2(self.dropout2(self.activation(self.linear1(y))))
        y = residual + self.dropout(y)
        if not self.normalize_before:
            y = self.norm2(y)
        return y if cache is None else (y, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clones(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it, as in
    ``paddle_tpu`` (every layer starts from the first layer's weights).
    The copies share the first layer's generators (one dropout stream
    for the whole stack), not copies of them."""
    shared = {id(g): g for g in (getattr(m, "generator", None)
                                 for m in layer.modules())
              if g is not None}
    return LayerList([layer] + [copy.deepcopy(layer, dict(shared))
                                    for _ in range(num_layers - 1)])


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the layer itself is the
    first; see :func:`_clones`), then an optional final ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over the encoder's ``memory`` and
    a feed-forward block, each with a residual and a LayerNorm: after the
    residual by default (post-norm), before the block with
    ``normalize_before``.  ``dropout`` acts on the two attention
    branches, ``act_dropout`` (default ``dropout``) after the
    activation, ``attn_dropout`` (default ``dropout``) on both
    attentions' probabilities; all draw from ``generator``.  As in
    ``paddle_tpu``, the feed-forward branch has no dropout of its own
    after ``linear2``.

    ``cache`` is ``(Cache, StaticCache)`` from :meth:`gen_cache` and
    makes the self-attention incremental (the step's K/V appended) over
    the memory's projected once; the layer then returns ``(out,
    cache)``.  ``paddle_tpu``'s layer accepts ``cache`` and ignores it;
    this one honours it, as Paddle's and the encoder layer's do."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; expected "
                             f"one of {sorted(_ACTIVATIONS)}")
        device = resolve_device(device)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                            device=device,
                                            generator=generator)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                             device=device,
                                             generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.dropout3 = Dropout(act_dropout if act_dropout is not None
                                else dropout, generator=generator)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        x = self.norm1(tgt) if self.normalize_before else tgt
        if cache is not None:
            x, incremental = self.self_attn(x, attn_mask=tgt_mask,
                                            cache=cache[0])
        else:
            x = self.self_attn(x, attn_mask=tgt_mask)
        x = residual + self.dropout1(x)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        if cache is not None:
            y, static = self.cross_attn(y, memory, memory,
                                        attn_mask=memory_mask,
                                        cache=cache[1])
        else:
            y = self.cross_attn(y, memory, memory, attn_mask=memory_mask)
        y = residual + self.dropout2(y)
        if not self.normalize_before:
            y = self.norm2(y)
        residual = y
        z = self.norm3(y) if self.normalize_before else y
        z = self.linear2(self.dropout3(self.activation(self.linear1(z))))
        z = residual + z
        if not self.normalize_before:
            z = self.norm3(z)
        return z if cache is None else (z, (incremental, static))

    def gen_cache(self, memory):
        """``(Cache, StaticCache)``: an empty self-attention cache and the
        memory's K/V projected once for the cross-attention."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer`` (see :func:`_clones`),
    then an optional final ``norm``.  ``cache`` is a list of one layer
    cache each (:meth:`gen_cache`); the decoder then returns ``(out,
    new_caches)``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out, new = tgt, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
            else:
                out, c = layer(out, memory, tgt_mask=tgt_mask,
                               memory_mask=memory_mask, cache=cache[i])
                new.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new)

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    """The encoder-decoder transformer, with the reference's defaults
    (d_model 512, 8 heads, 6 + 6 layers, feed-forward 2048, dropout
    0.1, ReLU, post-norm).  With ``normalize_before`` the encoder and
    the decoder each end with a LayerNorm.  ``custom_encoder`` /
    ``custom_decoder`` replace the built ones."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, device=device,
                generator=generator)
            norm = (LayerNorm(d_model, device=device) if normalize_before
                    else None)
            self.encoder = TransformerEncoder(enc, num_encoder_layers, norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, device=device,
                generator=generator)
            norm = (LayerNorm(d_model, device=device) if normalize_before
                    else None)
            self.decoder = TransformerDecoder(dec, num_decoder_layers, norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The additive causal mask ``[length, length]`` fp32: 0 on and
        below the diagonal, ``finfo(float32).min`` above, on ``device``
        (default CUDA)."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.zeros((length, length), dtype=torch.float32,
                           device=keep.device).masked_fill(
            ~keep, torch.finfo(torch.float32).min)
