"""Weights from ``paddle_tpu`` into the port — the only crossing point.

``paddle_tpu``'s ``LlamaForCausalLM.state_dict()``, converted to numpy
by the caller, is keyed ``llama.layers.{i}.self_attn.q_proj.weight``,
``llama.embed_tokens.weight``, ``llama.norm.weight`` and
``lm_head.weight`` (absent when embeddings are tied), with Linear
weights ``[in, out]`` — the layout the port keeps, so no transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .generation import stack_layer_params
from .llama import LlamaConfig


def from_numpy_state(state: dict, cfg: LlamaConfig, device=None,
                     dtype=torch.float32) -> dict:
    """The port's parameter dict (see ``models/llama.py``) from a numpy
    state dict, on ``device`` (default CUDA, see
    ``device.resolve_device``) in ``dtype``."""
    device = resolve_device(device)
    def t(a):
        return torch.from_numpy(np.array(a)).to(
            device=device, dtype=dtype)

    per_layer = {k: t(v) for k, v in state.items()
                 if k.startswith("llama.layers.")}
    return {
        "layers": stack_layer_params(per_layer, cfg.num_hidden_layers),
        "embed": t(state["llama.embed_tokens.weight"]),
        "norm": t(state["llama.norm.weight"]),
        "lm_head": (None if cfg.tie_word_embeddings
                    else t(state["lm_head.weight"])),
    }
