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


# -- optimizer and loss-scaler state ---------------------------------------------

def _host_to_torch(a):
    """A numpy array (bf16 as ``ml_dtypes.bfloat16``, as the reference's
    arrays come) as a CPU tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _torch_to_host(t):
    """A tensor as the reference stores it: a numpy array, bf16 as
    ``ml_dtypes.bfloat16`` (the reference's own numpy bf16 type)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _rename_slots(accum, src_names, dst_names):
    if len(src_names) != len(dst_names):
        raise ValueError(f"{len(src_names)} parameter names against "
                         f"{len(dst_names)}")
    # longest first, so "param_1" never claims "param_10.moment1"
    order = sorted(range(len(src_names)), key=lambda i: -len(src_names[i]))
    out = {}
    for key, val in accum.items():
        for i in order:
            if key.startswith(src_names[i] + "."):
                out[f"{dst_names[i]}.{key[len(src_names[i]) + 1:]}"] = val
                break
        else:
            raise KeyError(f"accumulator {key!r} belongs to no parameter")
    return out


def optimizer_state_to_port(state, ref_names, port_names):
    """A ``paddle_tpu`` ``Optimizer.state_dict()`` as the port's optimizer
    takes it (``set_state_dict``).  The two packages name parameters by
    different rules (``optimizer/optimizer.py``): ``ref_names[i]`` is the
    reference's name of the optimizer's i-th parameter (``p.name``, or
    ``param_{i}``) and ``port_names[i]`` the port's
    (``Optimizer._param_names()``); the accumulators ``{name}.{slot}``
    are renamed by position, arrays become CPU tensors of their dtype and
    the step counts ``_t`` host ints."""
    accum = _rename_slots(state.get("accumulators", {}), list(ref_names),
                          list(port_names))
    out = {k: v for k, v in state.items() if k != "accumulators"}
    out["accumulators"] = {
        k: int(np.asarray(v)) if k.endswith("._t") else _host_to_torch(v)
        for k, v in accum.items()}
    return out


def optimizer_state_to_reference(state, port_names, ref_names):
    """The inverse of :func:`optimizer_state_to_port`: the port's
    ``Optimizer.state_dict()`` in the reference's names and numpy
    arrays."""
    accum = _rename_slots(state.get("accumulators", {}), list(port_names),
                          list(ref_names))
    out = {k: v for k, v in state.items() if k != "accumulators"}
    out["accumulators"] = {
        k: np.asarray(v) if k.endswith("._t") else _torch_to_host(v)
        for k, v in accum.items()}
    return out


_SCALER_KEYS = ("scale", "incr_ratio", "decr_ratio", "incr_every_n_steps",
                "decr_every_n_nan_or_inf", "good_steps", "bad_steps")


def _scaler_state(state):
    unknown = sorted(set(state) - set(_SCALER_KEYS))
    if unknown:
        raise KeyError(f"not a GradScaler state: {unknown}")
    return {k: (float(v) if k in ("scale", "incr_ratio", "decr_ratio")
                else int(v)) for k, v in state.items()}


def grad_scaler_state_to_port(state):
    """A ``paddle_tpu`` ``GradScaler.state_dict()`` for the port's
    ``GradScaler.load_state_dict`` (the same keys; host numbers)."""
    return _scaler_state(state)


def grad_scaler_state_to_reference(state):
    """The port's ``GradScaler.state_dict()`` for the reference's."""
    return _scaler_state(state)
