"""Linear algebra ops of the port: ``matmul``.

Counterpart of ``paddle_tpu/ops/linalg.py``'s ``matmul``, the one name of
that module the flat namespace needs so far (a user script's layers are
``matmul`` s); the rest of the module is ROADMAP Queue 1 item 9c.  The
operands promote as ``jax.numpy`` does (``torch.matmul`` refuses mixed
dtypes), and the op takes the AMP policy of the reference's ``matmul``.
"""
from __future__ import annotations

import torch

from ..amp.state import amp_op
from .math import prep


@amp_op("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, with the last two axes of an operand swapped first
    when its ``transpose_*`` is set (a 1-D operand is not swapped)."""
    x, y = prep(x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
