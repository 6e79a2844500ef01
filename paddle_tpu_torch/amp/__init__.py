"""Mixed precision.  Counterpart of ``paddle_tpu/amp``: ``auto_cast`` /
``amp_guard`` (O1, O2), ``decorate``, ``GradScaler`` / ``AmpScaler``,
the policy in ``state``, the cast cache and ``debugging`` (the tensor
checker and the operator statistics over the op registry's dispatch)."""
from . import state  # noqa: F401  (first: the op registry reads it)
from . import debugging  # noqa: F401
from .auto_cast import amp_guard, auto_cast, decorate  # noqa: F401
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True
