"""Random ops of the port.

Counterpart of ``paddle_tpu/ops/random.py``.  The module owns one
explicit ``torch.Generator`` per device (:func:`generator`), made on
first use from the current seed; torch's global generators are never
drawn from.  :func:`seed` reseeds them all, and
``set_rng_state(get_rng_state())`` replays the same draws.  Draws happen
on the current place (``core.place``), or on the tensor's device for the
``*_`` fills.

JAX's threefry stream is not Philox, so the port's draws share with the
reference's only their shapes, dtypes, ranges and moments, never their
bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..device import resolve_device
from .registry import dispatch

_seed = 0
_generators: dict = {}


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device=None) -> torch.Generator:
    """The module's generator for ``device`` (the current place when
    ``None``), seeded with the current seed when first made."""
    dev = _key(resolve_device(device))
    g = _generators.get(dev)
    if g is None:
        g = torch.Generator(device=dev)
        g.manual_seed(_seed)
        _generators[dev] = g
    return g


def seed(value: int):
    """paddle.seed: reseed every device's generator (and the ones made
    later) with ``value``."""
    global _seed
    _seed = int(value)
    for g in _generators.values():
        g.manual_seed(_seed)


def get_rng_state(device=None):
    """[the state of ``device``'s generator] (the current place when
    ``None``)."""
    return [generator(device).get_state()]


def set_rng_state(state, device=None):
    generator(device).set_state(
        state[0] if isinstance(state, (list, tuple)) else state)


def _dt(dtype):
    if dtype is None:
        return dtype_mod.get_default_dtype()
    return dtype_mod.convert_dtype(dtype)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _draw(fn, shape, dtype, device=None):
    dev = resolve_device(device)
    return fn(_shape(shape), generator=generator(dev), device=dev,
              dtype=dtype)


def randn(shape, dtype=None, name=None):
    return _draw(torch.randn, shape, _dt(dtype))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """``mean + std * z``; with a tensor mean or std, z takes their
    broadcast shape in the default dtype."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        dev = (mean if isinstance(mean, torch.Tensor) else std).device
        sh = torch.broadcast_shapes(
            tuple(getattr(mean, "shape", ())), tuple(getattr(std, "shape",
                                                             ())))
        z = _draw(torch.randn, sh, dtype_mod.get_default_dtype(), dev)
        return mean + std * z
    z = randn(shape if shape is not None else [1])
    return mean + std * z


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    return mean + std * _draw(torch.randn, shape, _dt(dtype))


def rand(shape, dtype=None, name=None):
    return _draw(torch.rand, shape, _dt(dtype))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    u = _draw(torch.rand, shape, _dt(dtype))
    return u * (max - min) + min


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    """Integers in ``[low, high)`` (``[0, low)`` with one bound)."""
    if high is None:
        low, high = 0, low
    dev = resolve_device(None)
    d = dtype_mod.convert_dtype(dtype) if dtype else torch.int64
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator(dev), device=dev, dtype=d)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    d = dtype_mod.convert_dtype(dtype) if dtype else x.dtype
    return torch.randint(int(low), int(high), tuple(x.shape),
                         generator=generator(x.device), device=x.device,
                         dtype=d)


def randperm(n, dtype="int64", name=None):
    dev = resolve_device(None)
    return torch.randperm(int(n), generator=generator(dev),
                          device=dev).to(_dt(dtype))


def shuffle(x, axis=0):
    perm = torch.randperm(x.shape[axis], generator=generator(x.device),
                          device=x.device)
    return x.index_select(axis, perm)


def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=generator(x.device))


@dispatch("poisson", validate_only=True)
def poisson(x, name=None):
    return torch.poisson(x, generator=generator(x.device))


@dispatch("multinomial", validate_only=True)
def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x, int(num_samples), bool(replacement),
                             generator=generator(x.device))


@dispatch("exponential_", datas=("x",), validate_only=True)
def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=generator(x.device))


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=generator(x.device))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    with torch.no_grad():
        return x.uniform_(min, max, generator=generator(x.device))


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        return x.bernoulli_(p, generator=generator(x.device))


@dispatch("cauchy_", datas=("x",), validate_only=True)
def cauchy_(x, loc=0, scale=1, name=None):
    with torch.no_grad():
        return x.cauchy_(loc, scale, generator=generator(x.device))


@dispatch("geometric_", datas=("x",), validate_only=True)
def geometric_(x, probs, name=None):
    """Counts of trials to the first success (support 1, 2, ...)."""
    with torch.no_grad():
        return x.geometric_(probs, generator=generator(x.device))


@dispatch("log_normal_", datas=("x",), validate_only=True)
def log_normal_(x, mean=1.0, std=2.0, name=None):
    with torch.no_grad():
        return x.log_normal_(mean, std, generator=generator(x.device))


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    """``exp(mean + std * z)`` with z in float32."""
    if shape is None:
        shape = getattr(mean, "shape", ())
    dev = mean.device if isinstance(mean, torch.Tensor) else None
    z = _draw(torch.randn, shape, torch.float32, dev)
    return torch.exp(mean + std * z)


def standard_gamma(alpha, name=None):
    """Gamma(alpha, 1) draws in float64, the dtype ``jax.random.gamma``
    gives the reference under x64."""
    return torch._standard_gamma(alpha.to(torch.float64),
                                 generator=generator(alpha.device))


@dispatch("binomial", datas=("count", "prob"), validate_only=True)
def binomial(count, prob, name=None):
    """Elementwise draws, int64."""
    count, prob = torch.broadcast_tensors(count, prob)
    dt = torch.promote_types(torch.promote_types(count.dtype, prob.dtype),
                             torch.float32)
    return torch.binomial(count.to(dt), prob.to(dt),
                          generator=generator(count.device)
                          ).to(torch.int64)
