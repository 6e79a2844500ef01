"""BERT: configuration, seeded parameters, the encoder model and its task
heads.  Counterpart of ``paddle_tpu/models/bert.py`` (the repo's
BASELINE config 2: BERT-base SQuAD fine-tuning).

Token, position and token-type embeddings, LayerNorm (epsilon
``layer_norm_eps``, 1e-12) and dropout, then a post-LN
``nn.TransformerEncoder`` (exact GELU, LayerNorm epsilon 1e-5 inside the
layers, as ``TransformerEncoderLayer`` builds them), then a tanh pooler
over the first token.  ``attention_mask`` ([B, S] of 1/0) becomes the
additive ``(1 - m)·-1e4``; without it every layer's attention takes the
hand-written ``short_attention`` kernel on the card (S <= 1024,
S % 128 == 0, D = 64 at BERT-base), with its hash dropout.

Parameter names equal ``paddle_tpu``'s ``state_dict()`` keys (e.g.
``bert.encoder.layers.3.self_attn.q_proj.bias``,
``bert.embeddings.layer_norm.weight``) and Linear weights keep the
``[in, out]`` layout, so ``models.convert.load_numpy_state`` carries a
``paddle_tpu`` model's weights across unchanged.  Every dropout draws
from one explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..analysis.cost import transformer_flops_per_token
from ..device import resolve_device
from ..nn import (
    Dropout, Embedding, LayerNorm, Linear, TransformerEncoder,
    TransformerEncoderLayer,
)
from ..ops import nn_ops


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def base(cls, **kw):
        """BERT-base (Devlin et al. 2018, ``uncased_L-12_H-768_A-12``)."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        base = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=128)
        base.update(kw)
        return cls(**base)


def init_bert_params(model: nn.Module, generator: torch.Generator) -> None:
    """Fill ``model``'s parameters in place from ``generator`` (on the
    parameters' device) with ``paddle_tpu``'s default initializers:
    embeddings N(0, 1), Linear weights Xavier-uniform over ``[in, out]``,
    biases 0, LayerNorm weights 1 and biases 0, drawn in module order.
    As ``paddle_tpu``'s ``TransformerEncoder`` deep-copies its first
    layer, every encoder layer after the first gets the first layer's
    values, not draws of its own."""
    encoders = [(n, m) for n, m in model.named_modules()
                if isinstance(m, TransformerEncoder)]
    copied = tuple(f"{n}.layers.{i}." if n else f"layers.{i}."
                   for n, enc in encoders for i in range(1, len(enc.layers)))
    with torch.no_grad():
        for name, mod in model.named_modules():
            if f"{name}.".startswith(copied):
                continue
            if isinstance(mod, Embedding):
                mod.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(mod, Linear):
                fan_in, fan_out = mod.weight.shape
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                mod.weight.uniform_(-limit, limit, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for _, enc in encoders:
            first = dict(enc.layers[0].named_parameters())
            for layer in enc.layers[1:]:
                for k, p in layer.named_parameters():
                    p.copy_(first[k])


def _dropout_generator(device, seed):
    """The default dropout stream of a model built with ``seed``: its own
    generator on ``device``, seeded apart from the weights' (seed + 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    return gen


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, h, device)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, h,
                                             device)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, h,
                                               device)
        self.layer_norm = LayerNorm(h, epsilon=cfg.layer_norm_eps,
                                    device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob, generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        B, S = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                S, device=input_ids.device).expand(B, S)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, device,
                            bias=True)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Embeddings, encoder and pooler on ``device`` (default CUDA, see
    ``device.resolve_device``).  ``seed`` fills the weights through
    :func:`init_bert_params` from ``torch.Generator(device)``; ``None``
    leaves them unset for a caller that fills them (the task heads, or
    ``load_numpy_state``).  Dropout draws from ``generator`` (default: a
    generator on ``device`` seeded with ``seed + 1``).

    ``forward(input_ids, token_type_ids=None, position_ids=None,
    attention_mask=None)`` returns ``(sequence_output [B, S, h],
    pooled [B, h])``."""

    def __init__(self, cfg: BertConfig, device=None, seed=0,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = _dropout_generator(device, seed or 0)
        self.config = cfg
        self.generator = generator
        self.embeddings = BertEmbeddings(cfg, device, generator)
        layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob, device=device,
            generator=generator)
        self.encoder = TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg, device)
        if seed is not None:
            _init_seeded(self, device, seed)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None:
            # [B, S] 1/0 -> additive [B, 1, 1, S]
            m = attention_mask[:, None, None, :].to(torch.float32)
            attention_mask = (1.0 - m) * -1e4
        seq_out = self.encoder(emb, src_mask=attention_mask)
        return seq_out, self.pooler(seq_out)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len):
        """``6·N + 12·L·h·S`` (``analysis.cost``), N without the word
        embedding (a lookup, not a GEMM per token), as ``paddle_tpu``
        counts it."""
        cfg = self.config
        n = self.num_params() - cfg.vocab_size * cfg.hidden_size
        return transformer_flops_per_token(n, cfg.num_hidden_layers,
                                           cfg.hidden_size, seq_len)


def _init_seeded(model, device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    init_bert_params(model, gen)


class _Head(nn.Module):
    """A task head over ``bert``: weights from ``seed`` for the whole
    model, dropout from ``generator``, as :class:`BertModel` takes them."""

    def __init__(self, cfg, device, seed, generator):
        super().__init__()
        self._device = resolve_device(device)
        if generator is None:
            generator = _dropout_generator(self._device, seed or 0)
        self.generator = generator
        self.bert = BertModel(cfg, self._device, seed=None,
                              generator=generator)

    def _ready(self, seed):
        if seed is not None:
            _init_seeded(self, self._device, seed)


class BertForSequenceClassification(_Head):
    """Pooled output, dropout, a ``num_classes`` classifier; with
    ``labels``, the mean cross entropy."""

    def __init__(self, cfg: BertConfig, num_classes=2, device=None, seed=0,
                 generator=None):
        super().__init__(cfg, device, seed, generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob,
                               generator=self.generator)
        self.classifier = Linear(cfg.hidden_size, num_classes, self._device,
                                 bias=True)
        self._ready(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return nn_ops.cross_entropy(logits, labels)
        return logits


class BertForQuestionAnswering(_Head):
    """SQuAD span head (BASELINE config 2's task): start and end logits
    ``[B, S]``; with ``start_positions`` and ``end_positions`` ``[B]``,
    the mean of the two cross entropies over the sequence axis."""

    def __init__(self, cfg: BertConfig, device=None, seed=0,
                 generator=None):
        super().__init__(cfg, device, seed, generator)
        self.qa_outputs = Linear(cfg.hidden_size, 2, self._device, bias=True)
        self._ready(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                start_positions=None, end_positions=None):
        seq_out, _ = self.bert(input_ids, token_type_ids,
                               attention_mask=attention_mask)
        logits = self.qa_outputs(seq_out)          # [B, S, 2]
        start_logits, end_logits = logits[:, :, 0], logits[:, :, 1]
        if start_positions is not None:
            return (nn_ops.cross_entropy(start_logits, start_positions)
                    + nn_ops.cross_entropy(end_logits, end_positions)) / 2.0
        return start_logits, end_logits


class BertForMaskedLM(_Head):
    """Transform (Linear, exact GELU, LayerNorm) and a vocabulary decoder;
    with ``labels`` ``[B, S]`` (-100 = ignored), the mean cross entropy
    over every position."""

    def __init__(self, cfg: BertConfig, device=None, seed=0,
                 generator=None):
        super().__init__(cfg, device, seed, generator)
        h = cfg.hidden_size
        self.transform = Linear(h, h, self._device, bias=True)
        self.layer_norm = LayerNorm(h, epsilon=cfg.layer_norm_eps,
                                    device=self._device)
        self.decoder = Linear(h, cfg.vocab_size, self._device, bias=True)
        self._ready(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        seq_out, _ = self.bert(input_ids, token_type_ids,
                               attention_mask=attention_mask)
        h = self.layer_norm(nn_ops.gelu(self.transform(seq_out)))
        logits = self.decoder(h)
        if labels is not None:
            return nn_ops.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                ignore_index=-100)
        return logits
