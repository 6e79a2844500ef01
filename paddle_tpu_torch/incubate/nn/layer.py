"""The fused transformer layers (counterpart of
``paddle_tpu/incubate/nn/layer.py``; reference
python/paddle/incubate/nn/layer/fused_transformer.py):
``FusedMultiHeadAttention`` (one [h, 3h] qkv projection, attention
through ``F.scaled_dot_product_attention``, whose route takes the
short-attention kernels on the card at S <= 1024), ``FusedFeedForward``
and ``FusedTransformerEncoderLayer``, pre- or post-LN, with the
reference's parameters made in the reference's order."""
from __future__ import annotations

from ... import nn, ops
from ...nn.layers import Layer


class FusedMultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout_rate=0.0,
                 attn_dropout_rate=0.0, normalize_before=False,
                 need_weights=False, qkv_weight_attr=None, **kw):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(
                f"num_heads ({num_heads}) must evenly divide embed_dim "
                f"({embed_dim})")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.qkv_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.norm = nn.LayerNorm(embed_dim)
        self.dropout = nn.Dropout(dropout_rate)
        self.attn_dropout_rate = attn_dropout_rate

    def forward(self, x, attn_mask=None):
        residual = x
        if self.normalize_before:
            x = self.norm(x)
        B, S, _ = x.shape
        qkv = ops.reshape(self.qkv_proj(x),
                          [B, S, 3, self.num_heads, self.head_dim])
        q, k, v = ops.unbind(qkv, axis=2)
        out = nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate, training=self.training)
        out = self.out_proj(ops.reshape(out, [B, S, self.embed_dim]))
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 activation="relu", act_dropout_rate=None,
                 normalize_before=False, **kw):
        super().__init__()
        self.normalize_before = normalize_before
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model)
        self.dropout = nn.Dropout(dropout_rate)
        self.act_dropout = nn.Dropout(
            dropout_rate if act_dropout_rate is None else act_dropout_rate)
        self.activation = getattr(nn.functional, activation)

    def forward(self, x):
        residual = x
        if self.normalize_before:
            x = self.norm(x)
        x = self.act_dropout(self.activation(self.linear1(x)))
        x = residual + self.dropout(self.linear2(x))
        if not self.normalize_before:
            x = self.norm(x)
        return x


class FusedTransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward,
                 dropout_rate=0.1, activation="relu",
                 attn_dropout_rate=None, act_dropout_rate=None,
                 normalize_before=False, **kw):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))
