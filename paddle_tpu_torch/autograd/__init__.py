"""paddle.autograd of the port: ``backward``, ``grad``, the grad mode
and the saved-tensor hooks (``engine``), ``PyLayer`` (``py_layer``) and
the functional higher-order transforms (``functional``)."""
from . import engine  # noqa: F401
from .engine import (  # noqa: F401
    backward, enable_grad, grad, is_grad_enabled, no_grad,
    saved_tensors_hooks, set_grad_enabled,
)
from .functional import hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401
