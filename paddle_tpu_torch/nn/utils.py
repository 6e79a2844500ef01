"""``nn.utils``.  Counterpart of ``paddle_tpu/nn/utils.py``:
``weight_norm`` / ``remove_weight_norm``, ``spectral_norm``, the
in-place gradient clips ``clip_grad_norm_`` / ``clip_grad_value_``, and
``parameters_to_vector`` / ``vector_to_parameters``."""
from __future__ import annotations

import numpy as np
import torch


def _norm_except(v, dim):
    """The 2-norm of ``v`` over every axis but ``dim`` (over all of them
    when ``dim`` is None), kept as size-1 axes."""
    axes = [i for i in range(v.dim()) if dim is None or i != dim]
    return torch.sqrt((v * v).sum(axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as ``g * v / ||v||`` (``<name>_g``,
    ``<name>_v`` become the parameters); the weight is recomputed
    before every forward, so gradients reach g and v."""
    w = getattr(layer, name)
    if dim is not None:
        dim = dim % w.dim()
    del layer._parameters[name]
    v = layer.create_parameter(list(w.shape), device=w.device, dtype=w.dtype)
    g0 = _norm_except(w.detach(), dim)
    g = layer.create_parameter(list(g0.shape), device=w.device,
                               dtype=w.dtype)
    with torch.no_grad():
        v.copy_(w)
        g.copy_(g0)
    setattr(layer, f"{name}_v", v)
    setattr(layer, f"{name}_g", g)

    def pre_hook(lyr, inputs):
        vv, gg = getattr(lyr, f"{name}_v"), getattr(lyr, f"{name}_g")
        lyr.__dict__[name] = gg * vv / _norm_except(vv, dim)

    if not hasattr(layer, "_weight_norm_handles"):
        layer._weight_norm_handles = {}
        layer._weight_norm_cfgs = {}
    layer._weight_norm_handles[name] = layer.register_forward_pre_hook(
        pre_hook)
    layer._weight_norm_cfgs[name] = dim
    pre_hook(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    """Bake the current ``g * v / ||v||`` back into a plain parameter."""
    if name not in getattr(layer, "_weight_norm_handles", {}):
        raise ValueError(f"layer has no weight_norm applied to {name!r}")
    layer._weight_norm_handles.pop(name).remove()
    dim = layer._weight_norm_cfgs.pop(name)
    vv, gg = getattr(layer, f"{name}_v"), getattr(layer, f"{name}_g")
    with torch.no_grad():
        w_eff = gg * vv / _norm_except(vv, dim)
    layer.__dict__.pop(name, None)
    del layer._parameters[f"{name}_v"]
    del layer._parameters[f"{name}_g"]
    w = layer.create_parameter(list(vv.shape), device=vv.device,
                               dtype=vv.dtype)
    with torch.no_grad():
        w.copy_(w_eff)
    setattr(layer, name, w)
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=0):
    """``weight / sigma``, sigma the top singular value estimated by power
    iteration on the buffers ``<name>_u`` / ``<name>_v`` (drawn from
    ``np.random.RandomState(0)`` and iterated to convergence here, as
    the reference does; ``n_power_iterations`` more before each forward
    in training), differentiated through the weight with u, v held."""
    w = getattr(layer, name)
    dim = dim % w.dim()
    mat = torch.movedim(w.detach(), dim, 0).reshape(w.shape[dim], -1).float()
    rng = np.random.RandomState(0)
    u = torch.from_numpy(rng.randn(mat.shape[0]).astype(np.float32)).to(
        w.device)
    u = u / (torch.linalg.vector_norm(u) + eps)
    vv = torch.from_numpy(rng.randn(mat.shape[1]).astype(np.float32)).to(
        w.device)
    vv = vv / (torch.linalg.vector_norm(vv) + eps)
    sigma_prev = 0.0
    for _ in range(64):
        vv = mat.t() @ u
        vv = vv / (torch.linalg.vector_norm(vv) + eps)
        u = mat @ vv
        u = u / (torch.linalg.vector_norm(u) + eps)
        sigma_now = float(u @ mat @ vv)
        if abs(sigma_now - sigma_prev) <= 1e-6 * max(abs(sigma_now), 1.0):
            break
        sigma_prev = sigma_now
    del layer._parameters[name]
    orig = layer.create_parameter(list(w.shape), device=w.device,
                                  dtype=w.dtype)
    with torch.no_grad():
        orig.copy_(w)
    setattr(layer, f"{name}_orig", orig)
    layer.register_buffer(f"{name}_u", u)
    layer.register_buffer(f"{name}_v", vv)

    def pre_hook(lyr, inputs):
        ww = getattr(lyr, f"{name}_orig")
        w2d = torch.movedim(ww, dim, 0).reshape(ww.shape[dim], -1)
        uu, vvv = lyr._buffers[f"{name}_u"], lyr._buffers[f"{name}_v"]
        if lyr.training:
            with torch.no_grad():
                m = w2d.detach()
                for _ in range(n_power_iterations):
                    vvv = m.t() @ uu
                    vvv = vvv / (torch.linalg.vector_norm(vvv) + eps)
                    uu = m @ vvv
                    uu = uu / (torch.linalg.vector_norm(uu) + eps)
            lyr._buffers[f"{name}_u"] = uu
            lyr._buffers[f"{name}_v"] = vvv
        sigma = (uu[None, :] @ w2d @ vvv[:, None]).reshape(())
        lyr.__dict__[name] = ww / sigma

    layer._spectral_norm_handle = layer.register_forward_pre_hook(pre_hook)
    pre_hook(layer, ())
    return layer


def _param_list(parameters):
    if isinstance(parameters, torch.Tensor):
        return [parameters]
    return list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every gradient by ``min(max_norm / (total + 1e-6), 1)``,
    total the ``norm_type`` norm of all of them together; returns the
    total."""
    params = [p for p in _param_list(parameters) if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max() for p in params]).max()
    else:
        total = torch.stack([(p.grad.abs() ** norm_type).sum()
                             for p in params]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite gradient norm")
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p in params:
        p.grad.mul_(scale.to(p.grad.dtype))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    for p in _param_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    offset = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape).to(p.dtype))
        offset += n
