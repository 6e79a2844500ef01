"""The autograd entry points of the port.  Counterpart of
``paddle_tpu/autograd/engine.py``.

The port's tape is torch's autograd, so the reference's engine maps onto
it: the grad-mode switch is torch's (``no_grad`` and ``enable_grad`` are
context managers and decorators, ``set_grad_enabled(mode)`` a context
manager), ``backward`` accumulates into ``.grad`` as
``torch.autograd.backward`` does, ``saved_tensors_hooks`` is torch's
pack / unpack hook pair over the tensors a backward keeps, and
``Tensor.register_hook`` keeps paddle's meaning (the hook sees the
gradient summed over every use, once, and may return a replacement).

``grad`` keeps the reference's contract (``paddle.grad``, the
reference's GeneralGrad): a list with one gradient per input, ``.grad``
never touched, ``retain_graph`` defaulting to ``create_graph``, outputs
that do not require grad skipped, and an input that no output reaches
an error unless ``allow_unused`` (then None).  With
``create_graph=True`` the gradients carry their own graph and can be
differentiated again; every autograd Function of the port then computes
the reference's second derivative or raises where the reference raises
(``ops/registry.py`` ``recompute_vjp`` / ``refuse_create_graph``).
"""
from __future__ import annotations

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def _as_list(x):
    if x is None:
        return None
    return [x] if isinstance(x, torch.Tensor) else list(x)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate d(tensors) into the leaves'
    ``.grad``."""
    tensors = _as_list(tensors)
    grads = _as_list(grad_tensors)
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """paddle.grad: the gradients of ``outputs`` with respect to
    ``inputs`` (see the module docstring)."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    grad_outputs = _as_list(grad_outputs) or [None] * len(outputs)
    if retain_graph is None:
        retain_graph = bool(create_graph)
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs)
             if isinstance(o, torch.Tensor) and o.requires_grad]
    results = [None] * len(inputs)
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    if pairs and live:
        for o, g in pairs:
            if g is None and o.numel() != 1:
                raise RuntimeError(
                    "grad can be implicitly created only for scalar "
                    f"outputs; got shape {list(o.shape)}")
        got = torch.autograd.grad(
            [o for o, _ in pairs], [inputs[i] for i in live],
            [g for _, g in pairs], retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, got):
            results[i] = g
    if not allow_unused and any(g is None for g in results):
        raise RuntimeError(
            "One of the differentiated tensors appears unused; "
            "pass allow_unused=True to return None for it")
    return results
