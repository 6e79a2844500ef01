"""Tensors of the port.

Counterpart of ``paddle_tpu/core/tensor.py``.  The port's tensors are
``torch.Tensor`` s, so ``paddle.Tensor`` is ``torch.Tensor``; paddle's
``stop_gradient`` is ``not requires_grad``.  :func:`to_tensor` keeps the
reference's dtype rules (Python floats and float64 numpy arrays take the
default dtype, Python ints give int64), which ``torch.as_tensor`` does
not, and places a tensor on the current place unless told otherwise.
:class:`EagerParamBase` (``Parameter``) is a ``torch.nn.Parameter`` with
the reference's parameter attributes.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtype_mod
from ..device import resolve_device

Tensor = torch.Tensor


class EagerParamBase(torch.nn.Parameter):
    """Trainable parameter (the reference's ``EagerParamBase``): a
    ``torch.nn.Parameter`` that carries ``name``, ``trainable``,
    ``persistable``, ``optimize_attr``, ``regularizer``,
    ``do_model_average``, ``need_clip`` and ``is_distributed``."""

    # torch's read-only ``Tensor.name`` is shadowed here, for parameters
    # only.
    name = property(lambda self: self.__dict__.get("_param_name", ""),
                    lambda self, v: self.__dict__.__setitem__(
                        "_param_name", v))

    def __new__(cls, data, name=None, trainable=True):
        if not isinstance(data, torch.Tensor):
            data = to_tensor(data)
        p = super().__new__(cls, data.detach(), requires_grad=trainable)
        p.name = name or ""
        p.persistable = True
        p.trainable = trainable
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.do_model_average = None
        p.need_clip = True
        p.is_distributed = False
        return p

    def __init__(self, data, name=None, trainable=True):
        pass

    def __deepcopy__(self, memo):
        import copy

        out = EagerParamBase(self.data.clone(), name=self.name,
                             trainable=self.requires_grad)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = out
        return out


Parameter = EagerParamBase


def numpy_to_torch(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``arr``'s values and dtype.  bfloat16 and the
    float8 types of ``ml_dtypes`` are read through their raw bit
    pattern, so ``ml_dtypes`` is never needed here."""
    name = arr.dtype.name
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        raw = np.ascontiguousarray(arr).view(
            np.int16 if name == "bfloat16" else np.int8)
        return torch.from_numpy(raw.copy()).view(
            dtype_mod.convert_dtype(name))
    return torch.from_numpy(np.array(arr, copy=True))


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor: a new tensor from ``data`` on ``place`` (the
    current place when ``None``; a tensor's own device when ``data`` is
    a tensor and no place is given)."""
    dt = dtype_mod.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        dev = data.device if place is None else resolve_device(place)
        out = data.detach().to(device=dev, dtype=dt or data.dtype,
                               copy=True)
        return _grad(out, stop_gradient)
    dev = resolve_device(place)
    if isinstance(data, np.ndarray):
        arr = data
        if dt is None and arr.dtype == np.float64:
            dt = dtype_mod.get_default_dtype()
    else:
        arr = np.asarray(data)
        if dt is None and arr.dtype == np.float64:
            dt = dtype_mod.get_default_dtype()
        elif dt is None and arr.dtype == np.int64:
            dt = dtype_mod.int64
    out = numpy_to_torch(arr)
    out = out.to(device=dev, dtype=dt or out.dtype)
    return _grad(out, stop_gradient)


def _grad(t, stop_gradient):
    # Integer and bool tensors cannot require grad in torch; for them
    # stop_gradient=False has nothing to record.
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t
