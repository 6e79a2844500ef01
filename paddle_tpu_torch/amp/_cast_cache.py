"""Per-tensor AMP cast cache.  Counterpart of
``paddle_tpu/amp/_cast_cache.py``: a parameter cast to the low dtype
once in a step is reused by every op of that step that needs it.

An entry is reused only while all of these hold, or a stale cast would
train on old weights without any error:

* the source is alive (a weak reference; the entry goes when the source
  does);
* the source's ``_version`` is the one it had at the cast (an optimizer's
  in-place update, or any other write, invalidates it);
* backward has not yet run through the cast (a hook on the cast's
  grad node marks it released, as the reference drops a cast whose node
  backward released);
* a step that needs the source's gradient gets a cast that has a grad
  node (a cast made under ``no_grad`` would cut the gradient).
"""
from __future__ import annotations

import weakref

import torch

_cache: dict = {}


def _released(flag):
    def hook(grad_inputs, grad_outputs):
        flag[0] = True
    return hook


def cached_cast(t, target):
    key = (id(t), target)
    hit = _cache.get(key)
    if hit is not None:
        src_ref, version, out, released = hit
        need_node = torch.is_grad_enabled() and t.requires_grad
        if (src_ref() is t and t._version == version and not released[0]
                and not (need_node and out.grad_fn is None)):
            return out
    out = t.to(target)
    from .state import amp_state, record

    if amp_state().tally is not None:
        record("cast", out)
    released = [False]
    if out.grad_fn is not None:
        out.grad_fn.register_hook(_released(released))
    _cache[key] = (weakref.ref(t, lambda _, k=key: _cache.pop(k, None)),
                   t._version, out, released)
    return out


def clear():
    _cache.clear()
