"""Functional higher-order autograd: ``vjp``, ``jvp``, ``jacobian`` and
``hessian``.  Counterpart of ``paddle_tpu/autograd/functional.py``
(reference python/paddle/incubate/autograd/functional.py), over
``torch.autograd.functional``: it differentiates through every autograd
Function of the port, the kernels' included, by repeated reverse-mode
passes (``torch.func`` would need a vmap rule of each kernel).  The
results carry no graph; ``jvp`` and ``hessian`` differentiate a
backward, so a kernel's Function refuses them as the reference's Pallas
kernels do."""
from __future__ import annotations

import torch
import torch.autograd.functional as AF


def _inputs(xs):
    xs = [xs] if isinstance(xs, torch.Tensor) else list(xs)
    return tuple(x.detach() for x in xs)


def _one(t):
    return t[0] if isinstance(t, tuple) and len(t) == 1 else t


def vjp(func, xs, v=None):
    """(outputs, vjp): ``v`` (default ones) times the Jacobian of
    ``func`` at ``xs``; one gradient for one input, else a list."""
    ins = tuple(x.requires_grad_(True) for x in _inputs(xs))
    with torch.enable_grad():
        out = func(*ins)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if v is None:
        vs = [torch.ones_like(o) for o in outs]
    else:
        vs = [v] if isinstance(v, torch.Tensor) else list(v)
    gs = torch.autograd.grad(outs, ins, vs, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(ins, gs)]
    det = type(out)(o.detach() for o in out) \
        if isinstance(out, (tuple, list)) else out.detach()
    return det, gs[0] if len(ins) == 1 else gs


def jvp(func, xs, v=None):
    """(outputs, jvp): the Jacobian of ``func`` at ``xs`` times ``v``
    (default ones)."""
    ins = _inputs(xs)
    if v is None:
        vs = tuple(torch.ones_like(x) for x in ins)
    else:
        vs = tuple([v] if isinstance(v, torch.Tensor) else v)
    return AF.jvp(func, ins, vs)


def jacobian(func, xs, create_graph=False):
    """The Jacobian ``[*out_shape, *in_shape]`` of ``func`` at ``xs``; a
    tuple per input when there are several."""
    ins = _inputs(xs)
    return _one(AF.jacobian(func, ins, create_graph=create_graph))


def hessian(func, xs, create_graph=False):
    """The Hessian of a scalar ``func`` at ``xs``: ``[*in, *in]`` for
    one input, a tuple of tuples for several."""
    ins = _inputs(xs)
    h = AF.hessian(func, ins, create_graph=create_graph)
    return h[0][0] if len(ins) == 1 else h
