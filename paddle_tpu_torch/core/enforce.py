"""Error classes of the port (counterpart of ``paddle_tpu/core/enforce.py``:
the reference's ``PADDLE_ENFORCE_*`` taxonomy).  Each is also the Python
exception a caller would catch for it: ``InvalidArgumentError`` is a
``ValueError``, ``NotFoundError`` a ``KeyError``, ``OutOfRangeError`` an
``IndexError``, ``UnimplementedError`` a ``NotImplementedError``."""
from __future__ import annotations


class EnforceNotMet(RuntimeError):
    pass


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


def enforce(cond, msg="", err_cls=InvalidArgumentError):
    if not cond:
        raise err_cls(msg() if callable(msg) else msg)


def enforce_eq(a, b, msg="", err_cls=InvalidArgumentError):
    if a != b:
        raise err_cls(f"{msg} (expected {a!r} == {b!r})")


def enforce_shape_match(shape_a, shape_b, msg=""):
    if tuple(shape_a) != tuple(shape_b):
        raise InvalidArgumentError(
            f"{msg}: shape mismatch {tuple(shape_a)} vs {tuple(shape_b)}")
