"""The op registry and the port's one dispatch point.

Counterpart of ``paddle_tpu/ops/registry.py``: ``OpDef``,
``register_op``, ``get_op``, ``all_ops``, ``cached_apply``, ``apply`` and
``grad_op``.  Every named op of the port passes through one wrapper,
:func:`run`, reached three ways:

* the port's own functions that stand for a reference op are decorated
  with :func:`dispatch` under the reference's op name (``matmul``,
  ``conv2d``, ``concat``, ``softmax_with_cross_entropy``, ...);
* ops registered by name (:func:`register_op`, :func:`cached_apply`) run
  through :func:`apply`;
* plain torch functions between them (``+``, ``torch.log``, ``reshape``)
  are seen by :class:`DispatchMode`, a ``TorchFunctionMode`` that is on
  the stack while AMP, the operator statistics or the NaN/Inf check is
  on (:func:`acquire_mode`), under the reference's name for each
  (``amp.state._TORCH_NAMES``).

The wrapper does four things, in the reference's order: the AMP cast of
the floating operands (``amp.state``), the InferMeta validation on the
operands' metadata (``ops/infermeta.py``; :func:`dispatch` and
:func:`apply` only: a torch function's arguments are not the reference
op's), the op itself with the policy suspended (so nothing inside is
cast, validated, checked or counted again), then the NaN/Inf check of
the floating outputs when ``FLAGS_check_nan_inf`` is on (per
``amp.debugging.TensorCheckerConfig``) and the (op, output dtype) tally
while operator statistics are collected.

The NaN/Inf check reads the device, so it is skipped while a CUDA graph
is being captured (the reference skips traced values the same way): a
capture never synchronises.  Validation reads shapes and dtype names
only and runs everywhere, outside an op's body.

A user's ``register_op(name, fn, fwd=, bwd=)`` becomes a
``torch.autograd.Function`` with ``setup_context`` (so ``torch.func``
can transform it): ``fwd(*tensors, **attrs) -> (out, saved)`` and
``bwd(saved, grad_out, **attrs) -> grads``.  With only ``fn``, torch's
autograd differentiates the op.  Under ``create_graph=True`` the
backward is the reference's ``grad_op``: the VJP of the plain ``fn``,
recomputed under autograd so that it can be differentiated again.
"""
from __future__ import annotations

import functools
import inspect

import torch
from torch.overrides import TorchFunctionMode

from ..amp import state as _amp
from ..core import flags
from . import infermeta as _infermeta

_OPS: dict = {}
_DYN_OPS: dict = {}

#: TensorCheckerConfig scoping the NaN/Inf check per op (set by
#: ``amp.debugging.enable_tensor_checker``)
_CHECKER_CFG = None

_st = _amp.amp_state()


# -- the wrapper ----------------------------------------------------------------

def _outs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def check_nan_inf(name, out):
    """Reference ``_check_nan_inf``: raise ``FloatingPointError`` (level
    0) or print (level 1) when a floating output of ``name`` holds a NaN
    or an Inf."""
    for o in _outs(out):
        if not isinstance(o, torch.Tensor) or not o.is_floating_point():
            continue
        if not bool(torch.isfinite(o).all()):
            msg = f"Operator {name} output contains NaN/Inf"
            if flags.flag("FLAGS_check_nan_inf_level") == 0:
                raise FloatingPointError(msg)
            print(f"[check_nan_inf] {msg}")


def _after(name, out):
    if flags.flag("FLAGS_check_nan_inf") and (
            _CHECKER_CFG is None or _CHECKER_CFG._applies_to(name)) \
            and not _capturing():
        check_nan_inf(name, out)
    if _st.tally is not None:
        _amp.record(name, out)


def _active():
    return _st.enabled or _st.tally is not None or \
        flags.flag("FLAGS_check_nan_inf")


def run(name, fn, args, kwargs, operands=None):
    """One dispatched op (see the module docstring): positional tensor
    arguments (and lists of them) cast by the policy for ``name``.
    ``operands`` is ``(datas, attrs)`` for the validator, or None (no
    validation)."""
    if _st.enabled and not name.startswith("grad["):
        args = _amp.amp_transform(name, args)
    if operands is not None:
        _infermeta.validate(name, *operands)
    with _amp.no_amp():
        out = fn(*args, **kwargs)
    _after(name, out)
    return out


def _split_operands(sig, datas=None):
    """The reference's ``apply(op, *datas, **attrs)`` split of a call to
    a function of signature ``sig``: the parameters named in ``datas``
    (default: every tensor argument, a list of tensors expanded) are
    operands in order, every other bound argument an attr under its
    parameter name (``name=`` dropped)."""
    params = sig.parameters

    def split(args, kwargs):
        bound = sig.bind_partial(*args, **kwargs).arguments
        if datas is not None:
            ops = [bound.get(k, params[k].default) for k in datas]
            return ops, {k: v for k, v in bound.items()
                         if k not in datas and k != "name"}
        ops, attrs = [], {}
        for k, v in bound.items():
            kind = params[k].kind
            if kind is inspect.Parameter.VAR_POSITIONAL:
                ops.extend(v)
            elif kind is inspect.Parameter.VAR_KEYWORD:
                attrs.update(v)
            elif k == "name":
                continue
            elif isinstance(v, torch.Tensor):
                ops.append(v)
            elif type(v) in (list, tuple) and v and all(
                    isinstance(t, torch.Tensor) for t in v):
                ops.extend(v)
            else:
                attrs[k] = v
        return ops, attrs

    return split


def arg(args, kwargs, i, name, default=None):
    """Argument ``i`` / ``name`` of a call (for ``operands`` maps)."""
    return args[i] if len(args) > i else kwargs.get(name, default)


def dispatch(name, operands=None, datas=None, validate_only=False):
    """Decorator: ``fn`` becomes the port's op ``name`` (registered in
    :func:`all_ops`).  Calls pass :func:`run`; inside another op's body
    (or under ``amp.state.no_amp``) they are plain calls.  The validator
    of ``name`` sees the call split as the reference splits it:
    ``datas`` names the parameters that are operands where the default
    split (:func:`_split_operands`) would take an operand for an attr,
    and ``operands`` maps ``(args, kwargs)`` to ``(datas, attrs)`` where
    the reference computes them.  ``validate_only``: the reference only
    validates under this name and runs its body's ops as ops of their
    own (they are cast, checked and counted, not the call)."""
    def deco(fn):
        split = None
        if name in _infermeta._VALIDATORS:
            split = operands or _split_operands(inspect.signature(fn),
                                                datas)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _st.depth:
                return fn(*args, **kwargs)
            ops = split(args, kwargs) if split is not None else None
            if validate_only or not _active():
                if ops is not None:
                    _infermeta.validate(name, *ops)
                return fn(*args, **kwargs)
            return run(name, fn, args, kwargs, ops)

        _OPS.setdefault(name, OpDef(name, fn))
        return wrapped
    return deco


def call(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as the op ``name`` (no validator): what a
    :func:`dispatch`-decorated function does, for a body that cannot be
    decorated where it is defined."""
    if _st.depth or not _active():
        return fn(*args, **kwargs)
    return run(name, fn, args, kwargs)


# -- the torch functions between named ops ------------------------------------

def _in_backward():
    return torch._C._current_graph_task_id() != -1


class DispatchMode(TorchFunctionMode):
    """Treats the torch functions in ``amp.state._TORCH_NAMES`` as the
    reference's ops of those names: their tensor arguments (keyword ones
    too) cast by the policy, their outputs NaN checked and counted, as
    :func:`run` does for a named op.  Does nothing inside a named op or
    in a backward (the reference's grad ops are never cast or
    counted)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _amp._TORCH_NAMES.get(getattr(func, "__name__", None))
        if name is None or _st.depth or _in_backward():
            return func(*args, **kwargs)
        if _st.enabled:
            target = _amp.target(name)
            if target is not None:
                args = tuple(_amp.cast_arg(a, target) for a in args)
                kwargs = {k: _amp.cast_arg(v, target)
                          for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        _after(name, out)
        return out


_mode = {"users": 0, "mode": None}


def acquire_mode():
    """Put :class:`DispatchMode` on the torch-function stack (one
    instance serves every user: ``auto_cast``, the operator statistics,
    the NaN/Inf check)."""
    if _mode["users"] == 0:
        m = DispatchMode()
        m.__enter__()
        _mode["mode"] = m
    _mode["users"] += 1


def release_mode():
    _mode["users"] -= 1
    if _mode["users"] == 0:
        m, _mode["mode"] = _mode["mode"], None
        m.__exit__(None, None, None)


_nan_mode = {"on": False}


def _on_check_nan_inf(value):
    if bool(value) != _nan_mode["on"]:
        _nan_mode["on"] = bool(value)
        acquire_mode() if value else release_mode()


flags.watch("FLAGS_check_nan_inf", _on_check_nan_inf)
if flags.flag("FLAGS_check_nan_inf"):
    _on_check_nan_inf(True)


# -- registered ops -------------------------------------------------------------

class OpDef:
    """A named op: ``fn(*tensors, **attrs)``, and optionally its
    ``fwd`` / ``bwd`` pair (see the module docstring)."""

    __slots__ = ("name", "fn", "fwd", "bwd", "n_outputs",
                 "static_argnames", "nondiff_argnums", "_function",
                 "_grad_ops")

    def __init__(self, name, fn, fwd=None, bwd=None, n_outputs=1,
                 static_argnames=(), nondiff_argnums=()):
        self.name = name
        self.fn = fn
        self.fwd = fwd
        self.bwd = bwd
        self.n_outputs = n_outputs
        self.static_argnames = tuple(static_argnames)
        self.nondiff_argnums = frozenset(nondiff_argnums)
        self._function = None
        self._grad_ops = {}

    def __repr__(self):
        return f"OpDef({self.name})"

    def __call__(self, *args, **attrs):
        """The op's forward, differentiable: through its Function when
        it has ``fwd`` / ``bwd``, else ``fn`` under torch's autograd."""
        if self.fwd is None or self.bwd is None:
            return self.fn(*args, **attrs)
        if self._function is None:
            self._function = _make_function(self)
        flat = self._function.apply(attrs, *args)
        return flat[0] if self.n_outputs == 1 else tuple(
            flat[:self.n_outputs])


def _make_function(op):
    n_in = {}

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(attrs, *args):
            out, saved = op.fwd(*args, **attrs)
            outs = (out,) if op.n_outputs == 1 else tuple(out)
            leaves, spec = torch.utils._pytree.tree_flatten(saved)
            leaves = [x.detach() if isinstance(x, torch.Tensor) else x
                      for x in leaves]
            n_in["spec"] = spec
            return (*outs, *leaves)

        @staticmethod
        def setup_context(ctx, inputs, output):
            attrs, args = inputs[0], inputs[1:]
            leaves = output[op.n_outputs:]
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            saved_t = [x for x in leaves if isinstance(x, torch.Tensor)]
            ctx.mark_non_differentiable(*saved_t)
            ctx.save_for_backward(*tensors, *saved_t)
            ctx.layout = ([isinstance(a, torch.Tensor) for a in args],
                          [isinstance(x, torch.Tensor) for x in leaves],
                          [None if isinstance(a, torch.Tensor) else a
                           for a in args],
                          [None if isinstance(x, torch.Tensor) else x
                           for x in leaves], n_in["spec"])
            ctx.attrs = attrs

        @staticmethod
        def backward(ctx, *grads):
            is_t, leaf_t, consts, leaf_consts, spec = ctx.layout
            saved = list(ctx.saved_tensors)
            args, it = [], iter(saved)
            for t, c in zip(is_t, consts):
                args.append(next(it) if t else c)
            leaves = [next(it) if t else c
                      for t, c in zip(leaf_t, leaf_consts)]
            gout = grads[:op.n_outputs]
            if torch.is_grad_enabled():       # create_graph: grad_op
                diff = [i for i, a in enumerate(args)
                        if ctx.needs_input_grad[i + 1]]
                gs = recompute_vjp(functools.partial(op.fn, **ctx.attrs),
                                   args, gout, diff)
                return (None, *gs)
            res = torch.utils._pytree.tree_unflatten(leaves, spec)
            g = gout[0] if op.n_outputs == 1 else tuple(gout)
            gs = op.bwd(res, g, **ctx.attrs)
            gs = tuple(gs) if isinstance(gs, (tuple, list)) else (gs,)
            gs = gs + (None,) * (len(args) - len(gs))
            return (None, *[None if i in op.nondiff_argnums else gs[i]
                            for i in range(len(args))])

    _Op.__name__ = f"Op_{op.name}"
    return _Op


def register_op(name, fn=None, *, fwd=None, bwd=None, n_outputs=1,
                static_argnames=(), nondiff_argnums=()):
    """Register an op.  Usable as a decorator over the plain forward."""

    def _register(f):
        op = OpDef(name, f, fwd=fwd, bwd=bwd, n_outputs=n_outputs,
                   static_argnames=static_argnames,
                   nondiff_argnums=nondiff_argnums)
        _OPS[name] = op
        return op

    return _register(fn) if fn is not None else _register


def get_op(name: str) -> OpDef:
    return _OPS[name]


def all_ops() -> dict:
    return dict(_OPS)


def apply(op: OpDef, *args, attrs=None, **kw_attrs):
    """Run the registered ``op`` on ``args`` with ``attrs`` through the
    dispatch wrapper (cast, validation, NaN/Inf check, statistics)."""
    attrs = dict(attrs or {})
    attrs.update(kw_attrs)
    if _st.depth:
        return op(*args, **attrs)
    return run(op.name, op, args, attrs, (args, attrs))


def cached_apply(name, fn, *args, n_outputs=1, **attrs):
    """Dispatch ``fn`` as the op ``name`` through a cached ad-hoc
    :class:`OpDef` kept outside the registry (keyed by the name and the
    function's code, so two modules reusing a name keep apart)."""
    key = (name, getattr(fn, "__code__", fn))
    op = _DYN_OPS.get(key)
    if op is None or op.n_outputs != n_outputs:
        op = OpDef(name, fn, n_outputs=n_outputs,
                   static_argnames=tuple(attrs))
        _DYN_OPS[key] = op
    return apply(op, *args, **attrs)


# -- create_graph backward ------------------------------------------------------

def recompute_vjp(fn, inputs, grads_out, diff_idx):
    """The VJP of ``fn(*inputs)`` at ``grads_out`` for the inputs at
    ``diff_idx``, recomputed under autograd with ``create_graph=True``:
    the result is differentiable again, in the inputs and the cotangents
    (the reference's create_graph backward, ``registry.grad_op``).
    Returns one entry per input (None off ``diff_idx``)."""
    grads = [None] * len(inputs)
    if not diff_idx:
        return grads
    with torch.enable_grad():
        outs = _outs(fn(*inputs))
        pairs = [(o, g) for o, g in zip(outs, grads_out)
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        if not pairs:
            return grads
        got = torch.autograd.grad(
            [o for o, _ in pairs], [inputs[i] for i in diff_idx],
            [g for _, g in pairs], create_graph=True, allow_unused=True)
    for i, g in zip(diff_idx, got):
        grads[i] = g if g is not None else torch.zeros_like(inputs[i])
    return grads


def grad_op(op: OpDef, attrs: dict, n_outs: int, diff_idx: tuple,
            n_inputs: int) -> OpDef:
    """OpDef computing d(inputs[diff_idx]) from ``(*cotangents,
    *inputs)`` by :func:`recompute_vjp` of ``op.fn`` (one per
    (attrs, arity), kept on ``op``); its result is recorded by autograd,
    so it can be differentiated again."""
    key = (tuple(sorted(attrs.items())), n_outs, diff_idx, n_inputs)
    cached = op._grad_ops.get(key)
    if cached is not None:
        return cached

    def bwd_plain(*args):
        cots, ins = args[:n_outs], list(args[n_outs:])
        gs = recompute_vjp(functools.partial(op.fn, **attrs), ins, cots,
                           list(diff_idx))
        gs = [gs[i] for i in diff_idx]
        return gs[0] if len(gs) == 1 else tuple(gs)

    gop = OpDef(f"grad[{op.name}]", bwd_plain,
                n_outputs=max(1, len(diff_idx)))
    op._grad_ops[key] = gop
    return gop


def refuse_create_graph(name):
    """Raise where the reference cannot differentiate a backward again:
    a kernel's backward (a Pallas call there, a hand-written CUDA kernel
    here) has no derivative.  Called by the kernels' Functions when
    their backward runs under ``create_graph=True`` (grad mode on), so
    no partial second derivative is ever returned."""
    raise RuntimeError(
        f"{name}: create_graph=True cannot differentiate through this "
        f"op's hand-written backward kernel (paddle_tpu raises here too: "
        f"its Pallas backward has no derivative); compute the first "
        f"derivative without create_graph, or use the plain route")
