"""Shared helpers of the ``tests/test_torch_nn_*.py`` and
``tests/test_torch_rnn.py`` parity tests: a family of cases runs through
``paddle_tpu`` in one ``jax.jit`` (values, and ``jax.grad`` of a fixed
weighted sum of the outputs for the gradients) and through the port in
eager PyTorch on the CPU, from the same numpy inputs.

A case is ``dict(ref=f(*jnp arrays), port=f(*torch tensors), arrays=[numpy
arrays], diff=[indices of the arrays to differentiate])``; ``ref``
returns ``paddle_tpu`` tensors or jnp arrays (any pytree of them),
``port`` torch tensors.  The weights of the sum are ``cos(arange(n))``
over each output leaf, on both sides.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.tensor import Tensor

#: XLA options of the reference's jits here: LLVM's cheaper passes. The
#: programs are compiled once and run once, so compiling dominates; the
#: results part from the default's by rounding only (well inside the
#: tolerances).
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def concrete_key():
    """Make the reference's default generator hold a concrete key before
    a trace builds layers (its key is made lazily, and one first made
    inside a trace would leak)."""
    from paddle_tpu.ops.random import default_generator

    default_generator._ensure_key()


def jt(a):
    """A ``paddle_tpu`` tensor of a jnp array (inside a trace too)."""
    return Tensor(a)


def _leaves_ref(out):
    return [x._data if isinstance(x, Tensor) else x
            for x in jax.tree_util.tree_leaves(
                out, is_leaf=lambda v: isinstance(v, Tensor))]


def _leaves_port(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves_port(o)]
    return []


def _weighted(leaves, cos, arange):
    total = 0.0
    for leaf in leaves:
        if (leaf.is_floating_point() if isinstance(leaf, torch.Tensor)
                else jnp.issubdtype(leaf.dtype, jnp.floating)):
            n = int(np.prod(leaf.shape))
            total = total + (leaf * cos(arange(n)).reshape(
                leaf.shape)).sum()
    return total


def run_ref(cases):
    """{name: (output leaves, gradients)} of the reference, one jit."""
    names = list(cases)
    concrete_key()

    def one(case, arrays):
        diff = case.get("diff", [])

        def f(*d):
            full = list(arrays)
            for i, v in zip(diff, d):
                full[i] = v
            return _leaves_ref(case["ref"](*full))

        leaves = f(*[arrays[i] for i in diff])
        grads = []
        if diff:
            grads = jax.grad(lambda *d: _weighted(
                f(*d), jnp.cos, lambda n: jnp.arange(n, dtype=jnp.float32)),
                argnums=tuple(range(len(diff))))(
                *[arrays[i] for i in diff])
        return leaves, list(grads)

    run = jax.jit(lambda arrs: {n: one(cases[n], a)
                                for n, a in zip(names, arrs)},
                  compiler_options=FAST_COMPILE)
    out = run([[jnp.asarray(a) for a in cases[n]["arrays"]] for n in names])
    return jax.tree_util.tree_map(np.asarray, out)


def run_port(case):
    """(output leaves, gradients) of the port, eager on the CPU."""
    diff = case.get("diff", [])
    ts = [torch.from_numpy(np.array(a)).requires_grad_(i in diff)
          for i, a in enumerate(case["arrays"])]
    leaves = _leaves_port(case["port"](*ts))
    grads = []
    if diff:
        total = _weighted(leaves, torch.cos, lambda n: torch.arange(
            n, dtype=torch.float32))
        grads = list(torch.autograd.grad(total, [ts[i] for i in diff],
                                         allow_unused=True))
        grads = [torch.zeros_like(ts[i]) if g is None else g
                 for i, g in zip(diff, grads)]
    return ([x.detach().numpy() for x in leaves],
            [g.detach().numpy() for g in grads])


def close(got, want, atol):
    """``|got - want| <= atol * max(1, max|want|)``, shapes equal."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * max(
        1.0, float(np.abs(want).max()) if want.size else 1.0))


def check(name, cases, ref, atol=1e-5):
    """Hold the port's outputs and gradients of case ``name`` against the
    reference's (``ref`` from :func:`run_ref`)."""
    got, ggot = run_port(cases[name])
    want, gwant = ref[name]
    assert len(got) == len(want), (name, len(got), len(want))
    for g, w in zip(got, want):
        close(g, w, atol)
    for g, w in zip(ggot, gwant):
        close(g, w, atol)
