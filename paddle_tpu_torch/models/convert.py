"""Weights from ``paddle_tpu`` into the port and back — the only crossing
point — and from the training model into the serving engine.

``paddle_tpu``'s ``LlamaForCausalLM.state_dict()``, converted to numpy
by the caller, is keyed ``llama.layers.{i}.self_attn.q_proj.weight``,
``llama.embed_tokens.weight``, ``llama.norm.weight`` and
``lm_head.weight`` (absent when embeddings are tied), with Linear
weights ``[in, out]`` — the layout the port keeps, so no transpose.
The port's training module (``models.llama.LlamaForCausalLM``) has the
same parameter names.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .generation import stack_layer_params
from .llama import LAYER_WEIGHTS, LlamaConfig


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


def numpy_state(params: dict, cfg: LlamaConfig) -> dict:
    """The inverse of :func:`from_numpy_state`: a flat fp32 numpy state
    dict in ``paddle_tpu``'s names from the port's parameter dict (to
    load the port's seeded weights into the reference's model)."""
    def a(t):
        return t.detach().float().cpu().numpy()

    state = {f"llama.layers.{i}.{n}": a(w[i])
             for n, w in params["layers"].items()
             for i in range(cfg.num_hidden_layers)}
    state["llama.embed_tokens.weight"] = a(params["embed"])
    state["llama.norm.weight"] = a(params["norm"])
    if params["lm_head"] is not None:
        state["lm_head.weight"] = a(params["lm_head"])
    return state


def load_numpy_state(module: torch.nn.Module, state: dict) -> None:
    """Copy a numpy state dict into ``module``'s parameters and persistent
    buffers in place (a ``paddle_tpu`` batch norm's ``_mean`` and
    ``_variance``), each cast to its own dtype and kept on its device.
    The names must match exactly: a missing or an unknown name raises
    ``KeyError``, a shape that differs ``ValueError``."""
    params = dict(module.named_parameters())
    every_param = {k for k, _ in module.named_parameters(
        remove_duplicate=False)}
    buffers = {k: v for k, v in module.state_dict(keep_vars=True).items()
               if k not in every_param}
    targets = {**params, **buffers}
    missing = sorted(set(targets) - set(state))
    unknown = sorted(set(state) - set(targets))
    if missing or unknown:
        raise KeyError(f"state dict does not match the module: missing "
                       f"{missing}, unknown {unknown}")
    with torch.no_grad():
        for name, t in targets.items():
            a = np.asarray(state[name])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {a.shape} in the state, "
                                 f"{tuple(t.shape)} in the module")
            if t.is_floating_point():
                a = np.array(a, dtype=np.float32)
            t.copy_(torch.from_numpy(np.array(a)))


def serving_params(module: torch.nn.Module, device=None,
                   dtype=torch.float32) -> dict:
    """The serving parameter dict (``from_numpy_state``'s form, which
    ``ServingEngine`` takes) of a training ``LlamaForCausalLM``, on
    ``device`` (default CUDA) in ``dtype``.  Each stacked weight is
    filled layer by layer where the parameters live (one cast copy per
    layer, no host round trip: Llama-2-13B in fp32 would be 52 GB of
    host memory); the result owns its storage, sharing none with the
    module."""
    device = resolve_device(device)
    cfg = module.config
    named = dict(module.named_parameters())
    L = cfg.num_hidden_layers

    def stacked(name):
        first = named[f"llama.layers.0.{name}"]
        out = torch.empty((L,) + tuple(first.shape), dtype=dtype,
                          device=device)
        with torch.no_grad():
            for i in range(L):
                out[i].copy_(named[f"llama.layers.{i}.{name}"])
        return out

    def own(name):
        return named[name].detach().to(device=device, dtype=dtype,
                                       copy=True)

    return {
        "layers": {n: stacked(n) for n in LAYER_WEIGHTS},
        "embed": own("llama.embed_tokens.weight"),
        "norm": own("llama.norm.weight"),
        "lm_head": (None if cfg.tie_word_embeddings
                    else own("lm_head.weight")),
    }
