"""paddle.incubate.autograd: the functional higher-order autograd
(``autograd/functional.py``)."""
from ...autograd.functional import (  # noqa: F401
    hessian, jacobian, jvp, vjp,
)
