"""``Layer``, the base class of every layer of the port.  Counterpart of
``paddle_tpu/nn/layers.py`` (Paddle's ``python/paddle/nn/layer/layers.py``):
``create_parameter`` (a ``ParamAttr`` or an initializer, ``is_bias``,
``default_initializer``), ``create_variable``, ``add_parameter`` /
``add_sublayer``, ``register_buffer(persistable=)``, ``parameters()`` and
``sublayers()`` as lists, ``named_sublayers(include_self=)``,
``state_dict(structured_name_prefix=)`` without the non-persistable
buffers, ``set_state_dict`` / ``load_dict`` returning ``(missing,
unexpected)``, forward pre / post hooks, ``to(device=, dtype=)`` with
paddle's place and dtype names, ``astype``, ``full_name`` and
``clear_gradients``.

A ``Layer`` is a ``torch.nn.Module``: registration, ``__call__``, hooks,
``train`` / ``eval`` and the state dict are torch's, and every method
keeps torch's keywords beside paddle's (``recurse`` beside
``include_sublayers``, ``persistent`` beside ``persistable``,
``prefix`` / ``keep_vars`` beside ``structured_name_prefix``), so
torch's own callers (``eval()``, ``load_state_dict``,
``torch.func.functional_call``, CUDA-graph capture,
``torch.utils.checkpoint``) work on it unchanged.

Parameters are ``core.tensor.EagerParamBase``: they carry ``name``
(``linear_0.w_0`` unless the attr names it), ``optimize_attr
["learning_rate"]`` and ``regularizer``, which the port's optimizers
read, ``trainable`` / ``stop_gradient`` and ``need_clip``.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.utils.hooks import RemovableHandle

from ..core import dtype as dtype_mod
from ..core.place import Place
from ..core.tensor import EagerParamBase, numpy_to_torch
from ..device import resolve_device
from . import initializer as I

#: what ``register_forward_pre_hook`` / ``register_forward_post_hook``
#: return: its ``remove()`` takes the hook off
HookRemoveHelper = RemovableHandle

_unique_ids = {"n": 0}


def _as_tensor(value):
    """A torch tensor of ``value``: a tensor as it is, else its numpy
    array (a ``paddle_tpu`` tensor through its ``numpy()``)."""
    if isinstance(value, torch.Tensor):
        return value
    if hasattr(value, "numpy") and not isinstance(value, np.ndarray):
        value = value.numpy()
    return numpy_to_torch(np.asarray(value))


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._full_name = name_scope or type(self).__name__.lower()

    # -- parameters ------------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None):
        """A parameter of ``shape`` on ``device`` (default: the current
        place), or ``None`` when ``attr`` is ``False``.  Its values come
        from the attr's initializer, else ``default_initializer``, else
        zeros for a bias and XavierUniform for a weight, drawn from
        ``generator`` (default: the port's generator of that device)."""
        from .param_attr import ParamAttr

        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        attr = attr or ParamAttr()
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierUniform())
        dt = dtype_mod.convert_dtype(dtype or self._dtype or "float32")
        data = torch.empty([int(s) for s in shape], dtype=dt,
                           device=resolve_device(device))
        init(data, generator)
        name = attr.name
        if name is None:
            # the reference's automatic names ("linear_0.w_0"): one index
            # per layer instance, one w / b index per parameter
            prefix = self.__dict__.get("_auto_name_prefix")
            if prefix is None:
                prefix = f"{type(self).__name__.lower()}_{_unique_ids['n']}"
                _unique_ids["n"] += 1
                self.__dict__["_auto_name_prefix"] = prefix
                self.__dict__["_auto_name_counts"] = {"w": 0, "b": 0}
            counts = self.__dict__["_auto_name_counts"]
            kind = "b" if is_bias else "w"
            name = f"{prefix}.{kind}_{counts[kind]}"
            counts[kind] += 1
        p = EagerParamBase(data, name=name, trainable=attr.trainable)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        p.do_model_average = attr.do_model_average
        return p

    def create_variable(self, name=None, persistable=False, dtype=None):
        return torch.zeros([1], dtype=dtype_mod.convert_dtype(
            dtype or "float32"), device=resolve_device(None))

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        if not isinstance(sublayer, nn.Module):
            raise TypeError("add_sublayer expects a Layer")
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        super().register_buffer(
            name, tensor,
            persistent=persistable if persistent is None else persistent)
        return tensor

    @property
    def _sub_layers(self):
        return self._modules

    # -- traversal -------------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=True, remove_duplicate=True):
        return super().named_parameters(
            prefix=prefix, recurse=include_sublayers and recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=True,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix=prefix, recurse=include_sublayers and recurse,
            remove_duplicate=remove_duplicate)

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        for name, layer in self.named_modules(memo=layers_set,
                                              prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(
            include_self=include_self)]

    # -- state dict ------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix="",
                   keep_vars=False):
        """Parameters and persistable buffers by structured name
        (``structured_name_prefix`` first)."""
        prefix = structured_name_prefix + prefix
        if include_sublayers:
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        dest = OrderedDict() if destination is None else destination
        self._save_to_state_dict(dest, prefix, keep_vars)
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy the values of ``state_dict`` (torch tensors, numpy arrays
        or tensors with ``numpy()``, such as ``paddle_tpu``'s) into the
        parameters and persistable buffers of the same names, each cast
        to its target's dtype and device; returns ``(missing,
        unexpected)`` name lists."""
        own = self.state_dict(keep_vars=True)
        missing = [n for n in own if n not in state_dict]
        unexpected = [n for n in state_dict if n not in own]
        for name, target in own.items():
            if name not in state_dict:
                continue
            value = _as_tensor(state_dict[name])
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{name}: shape {tuple(value.shape)} does not match "
                    f"{tuple(target.shape)}")
            target.copy_(value.to(device=target.device, dtype=target.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    # -- places and dtypes -----------------------------------------------------
    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)``: ``device`` a
        paddle place (``"gpu:0"``, ``"cpu"``, a ``Place``) or a torch
        device, ``dtype`` a name or a torch dtype (floating parameters
        and buffers only); torch's positional forms work too."""
        kwargs.pop("blocking", None)
        device, dtype = kwargs.pop("device", None), kwargs.pop("dtype", None)
        rest = []
        for a in args:
            if isinstance(a, torch.dtype):
                dtype = a
            elif isinstance(a, (torch.device, Place, int)):
                device = a
            elif isinstance(a, str):
                try:
                    dtype = dtype_mod.convert_dtype(a)
                except TypeError:
                    device = a
            else:
                rest.append(a)
        if device is not None:
            kwargs["device"] = (torch.device("cuda", device)
                                if isinstance(device, int)
                                else resolve_device(device))
        if dtype is not None:
            kwargs["dtype"] = dtype_mod.convert_dtype(dtype)
        return super().to(*rest, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- hooks -----------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after every forward; a value
        it returns replaces the outputs."""
        return self.register_forward_hook(hook)

    # -- misc ------------------------------------------------------------------
    def full_name(self):
        return self._full_name

    def clear_gradients(self, set_to_zero=True):
        for p in self.parameters():
            p.grad = None
