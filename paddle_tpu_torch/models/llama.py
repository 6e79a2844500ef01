"""Llama configuration, RoPE tables and seeded parameters for serving.

Counterpart of ``paddle_tpu/models/llama.py``: ``LlamaConfig`` keeps
only the fields the serving path reads, ``rope_tables`` computes the
same fp32 cos/sin tables (the same numpy arithmetic, so both packages
hold identical tables), and ``init_llama_params`` fills every weight
from one ``torch.Generator`` on the target device, so a full-size
model never passes through host memory.

Parameters are a plain dict, already stacked per layer::

    {"layers": {name: [L, ...] tensor},   # names as in the state dict
     "embed":   [V, h],
     "norm":    [h],
     "lm_head": [h, V] or None}           # None when embeddings are tied

Linear weights are ``[in, out]`` (the ``paddle_tpu`` layout), so a
projection is ``x @ w``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

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
