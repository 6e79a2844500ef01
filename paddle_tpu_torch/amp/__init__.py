"""Mixed precision.  Counterpart of ``paddle_tpu/amp``: ``auto_cast`` /
``amp_guard`` (O1, O2), ``decorate``, ``GradScaler`` / ``AmpScaler``,
the policy in ``state`` and the cast cache; ``debugging`` raises (the
op registry, ROADMAP.md Queue 1, item 9)."""
from . import debugging, state  # noqa: F401
from .auto_cast import amp_guard, auto_cast, decorate  # noqa: F401
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True
