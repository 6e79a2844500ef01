"""Grad mode of the port: the part of ``paddle_tpu/autograd/engine.py``
that a user script needs to update parameters in place.

The port's tape is torch's autograd, so the reference's grad-mode switch
is torch's: ``no_grad`` and ``enable_grad`` are context managers and
decorators, ``set_grad_enabled(mode)`` a context manager, and
``is_grad_enabled`` reads the mode.  The rest of the module (``grad``,
``backward``, the saved-tensor hooks, ``PyLayer``) is ROADMAP Queue 1
item 9c.
"""
from __future__ import annotations

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()
