"""Small top-level conveniences of the port.

Counterpart of ``paddle_tpu/_misc_api.py``: ``iinfo`` / ``finfo``,
``is_tensor`` / ``is_complex`` / ``is_floating_point``, ``rank``,
``broadcast_tensors``, ``tolist``, ``create_parameter``, ``batch``,
``LazyGuard``, ``check_shape`` and the CUDA RNG state, which is the state
of ``ops.random``'s generators on the CUDA cards.
"""
from __future__ import annotations

import math

import torch

from .core import dtype as _dt


class _DtypeInfo:
    """``min``, ``max``, ``bits``, ``dtype`` and, for floats, ``eps``,
    ``tiny``, ``smallest_normal`` and ``resolution``."""


def iinfo(dtype):
    d = _dt.convert_dtype(dtype)
    info = torch.iinfo(d)
    out = _DtypeInfo()
    out.min, out.max, out.bits = int(info.min), int(info.max), info.bits
    out.dtype = _dt.dtype_name(d)
    return out


def finfo(dtype):
    d = _dt.convert_dtype(dtype)
    info = torch.finfo(d)
    out = _DtypeInfo()
    out.min, out.max, out.bits = float(info.min), float(info.max), info.bits
    out.eps = float(info.eps)
    out.tiny = float(info.tiny)
    out.smallest_normal = float(info.tiny)
    # 10^-precision rounded to the dtype, as numpy and ml_dtypes give it.
    out.resolution = torch.tensor(info.resolution, dtype=d).item()
    out.dtype = _dt.dtype_name(d)
    return out


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def _dtype_of(x):
    if isinstance(x, torch.Tensor):
        return x.dtype
    from .ops.math import prep

    return prep(x)[0].dtype


def is_complex(x):
    return _dtype_of(x) in _dt._COMPLEX


def is_floating_point(x):
    return _dtype_of(x) in _dt._FLOATING


def rank(x):
    """The number of axes, a 0-d int64 tensor."""
    from .ops.math import prep

    (x,) = prep(x)
    return torch.tensor(x.dim(), dtype=torch.int64, device=x.device)


def broadcast_tensors(inputs, name=None):
    from .ops.math import prep

    xs = [prep(x)[0] for x in inputs]
    shape = torch.broadcast_shapes(*[x.shape for x in xs])
    return [torch.broadcast_to(x, shape).clone() for x in xs]


def tolist(x):
    if isinstance(x, torch.Tensor):
        return x.tolist()
    import numpy as np

    return np.asarray(x).tolist()


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A free-standing trainable parameter on the current place:
    ``default_initializer(p)`` fills it, else uniform in
    ``[-b, b]``, b = sqrt(6 / (fan_in + fan_out)) from ``ops.random``'s
    generator (zeros for ``is_bias``)."""
    from .core.tensor import EagerParamBase
    from .device import resolve_device
    from .ops.random import generator

    dev = resolve_device(None)
    d = _dt.convert_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if default_initializer is not None:
        val = torch.zeros(shape, dtype=d, device=dev)
        p = EagerParamBase(val, name=name)
        default_initializer(p)
        return p
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else 1
    bound = 0.0 if is_bias else math.sqrt(
        6.0 / max(fan_in + shape[-1], 1))
    if bound > 0:
        u = torch.rand(shape, generator=generator(dev), device=dev,
                       dtype=torch.float32)
        val = (u * (2 * bound) - bound).to(d)
    else:
        val = torch.zeros(shape, dtype=d, device=dev)
    return EagerParamBase(val, name=name)



def batch(reader, batch_size, drop_last=False):
    """Wrap a sample reader into a batch reader."""
    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


class LazyGuard:
    """A scope in which parameters may be made lazily; the port's
    parameters are made when asked for, so the guard does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def disable_signal_handler():
    """Nothing to disable: the port installs no signal handler."""


def check_shape(shape):
    if shape is None:
        raise ValueError("shape must not be None")
    for s in (shape if isinstance(shape, (list, tuple)) else [shape]):
        if not isinstance(s, int) and s is not None:
            raise TypeError(f"shape entries must be int, got {type(s)}")
    return True


def get_cuda_rng_state():
    """The states of ``ops.random``'s generators on every CUDA card."""
    from .ops.random import generator

    return [generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state):
    from .ops.random import generator

    for i, s in enumerate(state):
        generator(torch.device("cuda", i)).set_state(s)
