"""paddle.save / paddle.load of the port.

Counterpart of ``paddle_tpu/framework_io.py``, in the same file format:
a pickle (protocol 4) of the object with every tensor turned into a
numpy array, written to a temporary file in the target directory,
``fsync`` ed, then moved over the target with ``os.replace``.  A file
written by either package loads in the other.

bfloat16 and the float8 types have no numpy dtype without ``ml_dtypes``,
which the port does not need.  :func:`save` writes such a tensor as the
reference does, an ``ml_dtypes`` array (the pickle names
``ml_dtypes.bfloat16`` and holds the raw 16-bit pattern), emitting those
records itself; :func:`load` reads them back through the raw pattern.
Either way ``ml_dtypes`` is never imported.  :func:`load` returns
tensors, on the current place, where the reference returns numpy arrays.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

from .core import dtype as _dt
from .core.tensor import numpy_to_torch

_RAW = {torch.bfloat16: ("bfloat16", np.int16, 2),
        torch.float8_e4m3fn: ("float8_e4m3fn", np.int8, 1),
        torch.float8_e5m2: ("float8_e5m2", np.int8, 1)}


class _Global:
    """A reference to ``module.name`` written without importing it."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __reduce__(self):
        return self.name


class _RawDtype:
    """Pickles as ``numpy.dtype(ml_dtypes.<name>)``."""

    def __init__(self, name, size):
        self.name, self.size = name, size

    def __reduce__(self):
        return (np.dtype, (_Global("ml_dtypes", self.name), False, True),
                (3, "<", None, None, None, self.size, self.size, 64))


class _RawArray:
    """Pickles as a numpy array of an ``ml_dtypes`` type from its raw
    bytes."""

    def __init__(self, t):
        name, _, size = _RAW[t.dtype]
        self.shape = tuple(t.shape)
        self.dtype = _RawDtype(name, size)
        self.raw = t.detach().cpu().contiguous().view(
            torch.int16 if size == 2 else torch.int8).numpy().tobytes()

    def __reduce__(self):
        return (np.ndarray.__reduce__(np.zeros(0))[0],
                (np.ndarray, (0,), b"b"),
                (1, self.shape, self.dtype, False, self.raw))


class _Pickler(pickle._Pickler):
    def save_global(self, obj, name=None):
        if isinstance(obj, _Global):
            self.save(obj.module)
            self.save(obj.name)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _to_numpy_tree(obj):
    if isinstance(obj, torch.Tensor):
        if obj.dtype in _RAW:
            return _RawArray(obj)
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    buf = io.BytesIO()
    _Pickler(buf, protocol=max(int(protocol), 4)).dump(_to_numpy_tree(obj))
    try:
        with open(tmp, "wb") as f:
            f.write(buf.getbuffer())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _LoadedRawDtype:
    def __init__(self, name):
        self.name = name

    def __setstate__(self, state):
        pass


class _LoadedArray:
    """An array record: the raw bytes of an ``ml_dtypes`` type, or any
    other array rebuilt by numpy."""

    def __init__(self, cls, shape, typecode):
        self.array = None
        self.args = (cls, shape, typecode)

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if isinstance(dtype, _LoadedRawDtype):
            t = _dt.convert_dtype(dtype.name)
            width = np.int16 if t == torch.bfloat16 else np.int8
            bits = np.frombuffer(raw, dtype=width).reshape(shape)
            self.array = torch.from_numpy(bits.copy()).view(t)
        else:
            a = np.ndarray.__new__(*self.args)
            a.__setstate__(state)
            self.array = a


def _dtype_factory(spec, align=False, copy=True):
    if isinstance(spec, _LoadedRawDtype):
        return spec
    return np.dtype(spec, align, copy)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "ml_dtypes":
            return _LoadedRawDtype(name)
        if module == "numpy" and name == "dtype":
            return _dtype_factory
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name == "_reconstruct":
            return _LoadedArray
        return super().find_class(module, name)


def _from_tree(obj, dev):
    if isinstance(obj, _LoadedArray):
        obj = obj.array
    if isinstance(obj, np.ndarray):
        obj = numpy_to_torch(obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: _from_tree(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_tree(v, dev) for v in obj)
    return obj


def load(path, **configs):
    """The saved object with every array a tensor on the current
    place."""
    from .device import resolve_device

    dev = resolve_device(None)
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _from_tree(obj, dev)
