"""paddle.autograd of the port: the grad mode (``engine``)."""
from . import engine  # noqa: F401
from .engine import (  # noqa: F401
    enable_grad, is_grad_enabled, no_grad, set_grad_enabled,
)
