"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, written for one NVIDIA H100.  Its
layout mirrors ``paddle_tpu`` so each module's counterpart is found by
path; inside, it is plain PyTorch: tensors on an explicit ``device``,
an explicit ``torch.Generator`` for every random draw, and every kernel
that ``paddle_tpu`` wrote in Pallas written again by hand for Hopper
(``csrc/``), built with ``nvcc`` on first use.

``import paddle_tpu_torch as paddle`` gives a user the flat ``paddle.*``
op namespace over torch tensors (``paddle.Tensor`` is ``torch.Tensor``):
dtypes and places (``core/dtype.py``, ``core/place.py``), ``to_tensor``
and ``Parameter`` (``core/tensor.py``), the creation, math, activation,
reduction, manipulation, in-place and random op families (``ops/``),
``paddle.save`` / ``paddle.load`` (``framework_io.py``), the helpers of
``_misc_api.py`` and the subpackages ``nn``, ``optimizer``, ``amp``,
``io``, ``vision``, ``inference``, ``distributed`` and ``incubate``.
The current place is ``cuda:0`` until ``set_device`` chooses another; a
tensor made without a place on a machine with no card raises.  The
Tensor-method table (``core/tensor_method_table.py``) is bound onto
``torch.Tensor`` only where torch has no attribute of that name: a torch
method keeps torch's meaning, and the flat function carries Paddle's
(``TORCH_MEANING_DIFFERS`` lists where the two part).

The model paths, each held against ``paddle_tpu``: Llama serving through
the paged engine (``inference.server``), in bf16 and int8, and Llama
training (``models.CompiledTrainStep``), whose Pallas kernels (paged
decode attention, the int8-weight matmul, RMSNorm, causal and short
attention, the grouped expert FFN) are hand-written CUDA kernels in
``csrc/`` built with ``nvcc`` on first use; BERT, the MoE block, the
conv/BN vision path and its zoo, the SD v1.5 UNet, durable and elastic
serving, the decoding surface (``generate``), the eager training loop
(the optimizers, AMP, the ``DataLoader``) and the detection surface
(``vision.ops``).  No Pallas kernel lies on the vision, UNet or op
namespace paths: the convs are cuDNN's and the rest is plain PyTorch with
the reference's rounding points.

Importing the package is light: it pulls in neither ``triton`` nor the
kernel build, and never ``jax`` or ``paddle_tpu``.
"""
from __future__ import annotations

__version__ = "0.1.0"

import sys as _sys
import types as _types

import torch as _torch

from .device import resolve_device  # noqa: F401
from .core import dtype as _dtype_mod  # noqa: F401
from .core.dtype import (  # noqa: F401
    bfloat16, bool_ as bool8, complex64, complex128, float16, float32,
    float64, get_default_dtype, int8, int16, int32, int64, set_default_dtype,
    uint8,
)
from .core.place import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace, TPUPlace, XPUPlace,
    get_device, is_compiled_with_cuda, set_device,
)
from .core.tensor import EagerParamBase, Parameter, Tensor, to_tensor  # noqa: F401
from .core.flags import get_flags, set_flags  # noqa: F401

# Ops: the flat tensor-op namespace (paddle.add, paddle.matmul, ...).
from .ops import *  # noqa: F401,F403
from .ops import linalg  # noqa: F401  (paddle.linalg)
from .ops import (  # noqa: F401
    abs, all, any, max, min, pow, sum,  # shadow builtins intentionally
)
from .core.dtype import (  # noqa: F401
    dtype, float8_e4m3fn, float8_e5m2, bool_ as bool,  # noqa: A004
)
from ._misc_api import (  # noqa: F401
    tolist, create_parameter, batch, LazyGuard, disable_signal_handler,
    check_shape, get_cuda_rng_state, set_cuda_rng_state,
    broadcast_tensors, finfo, iinfo, is_complex, is_floating_point,
    is_tensor, rank,
)
from .framework_io import load, save  # noqa: F401
from .ops.random import get_rng_state, seed, set_rng_state  # noqa: F401

from . import amp  # noqa: F401
from . import autograd  # noqa: F401
from .autograd import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)
from . import nn  # noqa: F401
from .nn.param_attr import ParamAttr  # noqa: F401
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import io  # noqa: F401
from . import vision  # noqa: F401
from . import inference  # noqa: F401
from . import distributed  # noqa: F401
from . import incubate  # noqa: F401

disable_static = lambda *a, **k: None  # dygraph is the default  # noqa: E731
enable_static = lambda *a, **k: None  # noqa: E731


def in_dynamic_mode():
    return True


def device_count():
    from .core.place import device_count as _dc

    return _dc()


def set_printoptions(**kwargs):
    """Print options of tensors (``precision``, ``threshold``,
    ``edgeitems``, ``linewidth``)."""
    _torch.set_printoptions(**{k: v for k, v in kwargs.items()
                               if k in ("precision", "threshold",
                                        "edgeitems", "linewidth")})


# -- the Tensor-method table -----------------------------------------------------

def _stop_gradient(self):
    return not self.requires_grad


def _set_stop_gradient(self, value):
    if self.is_leaf:
        self.requires_grad_(not value)
    elif value:
        raise RuntimeError(
            "stop_gradient=True on a tensor computed under autograd: use "
            "detach()")


def _place(self):
    from .core.place import to_place

    return to_place(self.device)


def _set_value(self, value):
    """Write ``value`` into the tensor (same shape; cast to its dtype),
    outside autograd."""
    if not isinstance(value, _torch.Tensor):
        value = to_tensor(value, place=self.device)
    if tuple(value.shape) != tuple(self.shape):
        raise ValueError(
            f"set_value shape mismatch: {tuple(value.shape)} vs "
            f"{tuple(self.shape)}")
    with _torch.no_grad():
        self.copy_(value.to(device=self.device, dtype=self.dtype))


def _clear_grad(self):
    self.grad = None


# Methods of the reference's Tensor class and of its method installer
# that are not in the table.
_EXTRA_METHODS = {
    "astype": cast,
    "stop_gradient": property(_stop_gradient, _set_stop_gradient),
    "place": property(_place),
    "set_value": _set_value,
    "clear_grad": _clear_grad,
    "clear_gradient": _clear_grad,
    "one_hot": one_hot,
    "gelu": gelu,
}


def _bind_tensor_method_table():
    """Bind every table name (and the in-place variants and the
    reference's other Tensor methods) that ``torch.Tensor`` lacks and
    this package defines; returns the bound names.  No attribute torch
    has is replaced."""
    from .core.tensor_method_table import TENSOR_METHOD_FUNC
    from .ops import _INPLACE_VARIANTS

    mod = _sys.modules[__name__]
    bound = []
    names = dict.fromkeys(list(TENSOR_METHOD_FUNC) + _INPLACE_VARIANTS)
    for name in names:
        fn = getattr(mod, name, None)
        if hasattr(_torch.Tensor, name) or not callable(fn) or isinstance(
                fn, (type, _types.ModuleType)):
            continue
        setattr(_torch.Tensor, name, fn)
        bound.append(name)
    for name, attr in _EXTRA_METHODS.items():
        if not hasattr(_torch.Tensor, name):
            setattr(_torch.Tensor, name, attr)
            bound.append(name)
    return sorted(bound)


BOUND_TENSOR_METHODS = _bind_tensor_method_table()


class version:  # noqa: N801 - namespace (reference paddle.version)
    full_version = __version__
    major, minor, patch = "0", "1", "0"
    commit = "cuda-port"

    @staticmethod
    def show():
        print(f"paddle_tpu_torch {__version__} (cuda-port)")
