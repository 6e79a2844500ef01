"""Llama: configuration, RoPE tables, seeded parameters for serving, and
the ``nn.Module`` model for training.

Counterpart of ``paddle_tpu/models/llama.py``: ``LlamaConfig`` keeps
the fields the serving and training paths read, ``rope_tables``
computes the same fp32 cos/sin tables (the same numpy arithmetic, so
both packages hold identical tables), and ``init_llama_params`` fills
every weight from one ``torch.Generator`` on the target device, so a
full-size model never passes through host memory.

Training uses ``LlamaForCausalLM`` (below), whose parameters carry
``paddle_tpu``'s state-dict names and ``[in, out]`` Linear layout.

Serving parameters are a plain dict, already stacked per layer::

    {"layers": {name: [L, ...] tensor},   # names as in the state dict
     "embed":   [V, h],
     "norm":    [h],
     "lm_head": [h, V] or None}           # None when embeddings are tied

Linear weights are ``[in, out]`` (the ``paddle_tpu`` layout), so a
projection is ``x @ w``.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..analysis.cost import transformer_flops_per_token
from ..device import resolve_device
from ..nn import Embedding, Linear, RMSNorm
from ..ops import nn_ops

#: the per-layer weights, in ``paddle_tpu``'s state-dict naming.
LAYER_WEIGHTS = (
    "self_attn.q_proj.weight", "self_attn.k_proj.weight",
    "self_attn.v_proj.weight", "self_attn.o_proj.weight",
    "mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight",
    "input_layernorm.weight", "post_attention_layernorm.weight",
)


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    #: checkpoint each decoder layer (torch.utils.checkpoint) and take the
    #: loss through ``fused_linear_cross_entropy``
    recompute: bool = False
    #: what a checkpointed layer keeps besides its input: "full"
    #: (nothing), "save_mlp" (the gate and up products), "save_attn"
    #: (the attention output) or "dots" (every matmul output)
    recompute_policy: str = "full"
    #: an XLA compile-time device in ``paddle_tpu`` (one compiled layer
    #: body); eager PyTorch has nothing to compile, so it is accepted and
    #: has no effect, numeric or otherwise
    scan_layers: bool = False
    #: "auto" | "einsum" | "flash" | "short", as ``ops.nn_ops.sdpa`` takes
    attention_impl: str = "auto"

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**{**dict(
            hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
            num_attention_heads=32, num_key_value_heads=32), **kw})

    @staticmethod
    def tiny(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128), **kw})

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def rope_tables(config: LlamaConfig, device=None):
    """(cos, sin), each fp32 ``[max_position_embeddings, head_dim]``
    (the half-split layout ``rope`` rotates), on ``device`` (default
    CUDA, see ``device.resolve_device``)."""
    device = resolve_device(device)
    dim = config.head_dim
    inv_freq = 1.0 / (config.rope_theta ** (
        np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(config.max_position_embeddings, dtype=np.float32)
    freqs = np.outer(t, inv_freq)                   # [S, D/2]
    emb = np.concatenate([freqs, freqs], axis=-1)   # [S, D]
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


def layer_weight_shapes(config: LlamaConfig) -> dict:
    """{name: per-layer shape} for ``LAYER_WEIGHTS``."""
    h, i = config.hidden_size, config.intermediate_size
    kv = config.num_key_value_heads * config.head_dim
    return {
        "self_attn.q_proj.weight": (h, h),
        "self_attn.k_proj.weight": (h, kv),
        "self_attn.v_proj.weight": (h, kv),
        "self_attn.o_proj.weight": (h, h),
        "mlp.gate_proj.weight": (h, i),
        "mlp.up_proj.weight": (h, i),
        "mlp.down_proj.weight": (i, h),
        "input_layernorm.weight": (h,),
        "post_attention_layernorm.weight": (h,),
    }


def init_llama_params(config: LlamaConfig, seed=0, device=None,
                      dtype=torch.float32, std=0.02) -> dict:
    """Random Llama parameters from ``torch.Generator(device)`` seeded
    with ``seed``: projections and embeddings N(0, std), norm weights 1.
    The draw order is fixed (layer weights in ``LAYER_WEIGHTS`` order,
    then embed, then lm_head), so one seed on one device type always
    gives the same weights.  ``device`` defaults to CUDA (see
    ``device.resolve_device``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    L = config.num_hidden_layers

    def normal(shape):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std, generator=gen)

    layers = {}
    for name, shape in layer_weight_shapes(config).items():
        if len(shape) == 1:
            layers[name] = torch.ones((L,) + shape, dtype=dtype,
                                      device=device)
        else:
            layers[name] = normal((L,) + shape)
    h, V = config.hidden_size, config.vocab_size
    return {
        "layers": layers,
        "embed": normal((V, h)),
        "norm": torch.ones((h,), dtype=dtype, device=device),
        "lm_head": None if config.tie_word_embeddings else normal((h, V)),
    }


def params_to(params: dict, device=None, dtype=None) -> dict:
    """A copy of ``params`` moved to ``device`` and/or cast to
    ``dtype`` (e.g. weights made on the card, replayed on the CPU)."""
    def mv(t):
        return None if t is None else t.to(device=device, dtype=dtype)

    return {
        "layers": {k: mv(v) for k, v in params["layers"].items()},
        "embed": mv(params["embed"]),
        "norm": mv(params["norm"]),
        "lm_head": mv(params["lm_head"]),
    }


# -- the training model -------------------------------------------------------

_REMAT_POLICIES = ("full", "dots", "save_attn", "save_mlp")

#: the named sites each policy keeps (``jax.checkpoint_policies.
#: save_only_these_names`` in ``paddle_tpu``'s ``_remat_policy``)
_SAVED_SITES = {"save_mlp": ("mlp_gate", "mlp_up"),
                "save_attn": ("attn_out",)}
#: the matmul ops: "dots" keeps every one's output
#: (``checkpoint_policies.checkpoint_dots``), and the MLP sites' matmul
#: is the op "save_mlp" keeps
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}

_site_state = threading.local()


@contextlib.contextmanager
def _site(name):
    """Name the ops run inside as the checkpoint site ``name`` (the
    counterpart of ``checkpoint_name``), for the selective policies."""
    prev = getattr(_site_state, "name", None)
    _site_state.name = name
    try:
        yield
    finally:
        _site_state.name = prev


def _check_remat_policy(name):
    if name not in _REMAT_POLICIES:
        raise ValueError(f"unknown recompute_policy {name!r}; expected "
                         "'full', 'dots', 'save_attn' or 'save_mlp'")


def _remat_policy(name):
    """The ``torch.utils.checkpoint`` selective policy of
    ``recompute_policy`` ``name``: a function of (ctx, op, *args) that
    says which op outputs the checkpoint keeps, so that the recompute
    takes them from memory instead of running the op again.  None for
    "full" (keep nothing but the layer's input)."""
    _check_remat_policy(name)
    if name == "full":
        return None
    if name == "dots":
        def keep(ctx, op, *args, **kwargs):
            return op in _DOTS
    elif name == "save_mlp":
        def keep(ctx, op, *args, **kwargs):
            return (op in _DOTS and getattr(_site_state, "name", None)
                    in _SAVED_SITES["save_mlp"])
    else:                       # save_attn: every op of the site (the copy
        def keep(ctx, op, *args, **kwargs):   # of the attention output)
            return getattr(_site_state, "name", None) == "attn_out"

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if keep(ctx, op, *args, **kwargs)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        h, d = config.hidden_size, config.head_dim
        kv = config.num_key_value_heads * d
        self.q_proj = Linear(h, h, device)
        self.k_proj = Linear(h, kv, device)
        self.v_proj = Linear(h, kv, device)
        self.o_proj = Linear(h, h, device)

    def forward(self, x, cos, sin, attn_mask=None):
        cfg = self.config
        B, S = x.shape[:2]
        nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        q = self.q_proj(x).reshape(B, S, nh, d)
        k = self.k_proj(x).reshape(B, S, nkv, d)
        v = self.v_proj(x).reshape(B, S, nkv, d)
        q, k = nn_ops.fused_rope(q, k, cos, sin)
        out = nn_ops.sdpa(q, k, v, attn_mask, causal=True,
                          impl=cfg.attention_impl)
        # the checkpoint site "attn_out" (recompute_policy="save_attn")
        with _site("attn_out"):
            out = out.reshape(B, S, cfg.hidden_size)
        return self.o_proj(out)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, i, device)
        self.up_proj = Linear(h, i, device)
        self.down_proj = Linear(i, h, device)

    def forward(self, x):
        # the checkpoint sites "mlp_gate" and "mlp_up"
        # (recompute_policy="save_mlp")
        with _site("mlp_gate"):
            gate = self.gate_proj(x)
        with _site("mlp_up"):
            up = self.up_proj(x)
        return self.down_proj(nn_ops.swiglu(gate, up))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.self_attn = LlamaAttention(config, device)
        self.mlp = LlamaMLP(config, device)
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                device)

    def forward(self, x, cos, sin, attn_mask=None):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)
        cos, sin = rope_tables(config, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, attn_mask=None):
        S = input_ids.shape[1]
        x = self.embed_tokens(input_ids)
        cos, sin = self.rope_cos[:S], self.rope_sin[:S]
        remat = self.config.recompute and torch.is_grad_enabled()
        policy = _remat_policy(self.config.recompute_policy)
        kw = ({} if policy is None else dict(context_fn=functools.partial(
            create_selective_checkpoint_contexts, policy)))
        for layer in self.layers:
            if remat:
                # the layer's input (and what the policy keeps) is saved;
                # the rest of its forward runs again in the backward.
                # Llama draws no random numbers, so no RNG state is kept
                # (reading it would not be allowed under graph capture)
                x = checkpoint(layer, x, cos, sin, attn_mask,
                               use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = layer(x, cos, sin, attn_mask)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama for causal LM training, on ``device`` (default CUDA, see
    ``device.resolve_device``), parameters in fp32 filled from
    ``torch.Generator(device)`` seeded with ``seed``: every matrix
    N(0, ``std``), norm weights 1, in ``named_parameters`` order.

    ``forward(input_ids, labels=None)`` returns logits ``[B, S, V]``, or
    the mean loss when labels are given (labels are compared position by
    position, as in ``paddle_tpu``; ``-100`` marks ignored positions).
    With ``config.recompute`` each decoder layer is checkpointed and the
    loss goes through ``fused_linear_cross_entropy``, as
    ``_checkpointed_loss`` does."""

    def __init__(self, config: LlamaConfig, device=None, seed=0, std=0.02):
        super().__init__()
        if config.recompute:
            _check_remat_policy(config.recompute_policy)
        device = resolve_device(device)
        self.config = config
        self.llama = LlamaModel(config, device)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            for p in self.parameters():
                if p.dim() > 1:
                    p.normal_(0.0, std, generator=gen)

    def _head_weight(self):
        return (self.llama.embed_tokens.weight
                if self.config.tie_word_embeddings else self.lm_head.weight)

    def forward(self, input_ids, labels=None, attn_mask=None):
        hidden = self.llama(input_ids, attn_mask)
        cfg = self.config
        if labels is not None and cfg.recompute:
            return nn_ops.fused_linear_cross_entropy(
                hidden.reshape(-1, cfg.hidden_size), self._head_weight(),
                labels.reshape(-1), cfg.tie_word_embeddings, -100)
        w = self._head_weight()
        logits = hidden @ (w.t() if cfg.tie_word_embeddings else w)
        if labels is None:
            return logits
        return nn_ops.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                    labels.reshape(-1))

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len):
        """``6·N + 12·L·h·S`` (``analysis.cost``), for MFU."""
        cfg = self.config
        return transformer_flops_per_token(
            self.num_params(), cfg.num_hidden_layers, cfg.hidden_size,
            seq_len)
