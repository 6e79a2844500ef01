"""``PyLayer``: a user's forward and backward pair.  Counterpart of
``paddle_tpu/autograd/py_layer.py`` (reference
``python/paddle/autograd/py_layer.py:280``), built on
``torch.autograd.Function``: ``forward(ctx, *args)`` runs without
recording, ``backward(ctx, *grads)`` gets one gradient per output (zeros
for an output that received none) and may return fewer gradients than
there are inputs (the rest are None), as in the reference.  As in the
reference, a PyLayer cannot be differentiated twice: its backward under
``create_graph=True`` raises."""
from __future__ import annotations

import torch


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.not_inplace_tensors = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensor_list(self):
        return list(self._saved)


class _PyLayerFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer_cls, kwargs, shape, *args):
        pctx = PyLayerContext()
        ctx.pctx, ctx.layer_cls = pctx, layer_cls
        ctx.tensor_in = [isinstance(a, torch.Tensor) for a in args]
        outputs = layer_cls.forward(pctx, *args, **kwargs)
        shape["single"] = not isinstance(outputs, (tuple, list))
        outs = (outputs,) if shape["single"] else tuple(outputs)
        # an input handed back unchanged becomes an output of its own
        return tuple(o.view_as(o) if isinstance(o, torch.Tensor)
                     and any(o is a for a in args) else o for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                f"create_graph=True cannot differentiate through "
                f"'PyLayer<{ctx.layer_cls.__name__}>': the node has no "
                "re-traceable forward (PyLayer/compiled custom nodes); "
                "wrap that region in autograd.functional instead")
        with torch.no_grad():
            result = ctx.layer_cls.backward(ctx.pctx, *grads)
        if not isinstance(result, (tuple, list)):
            result = (result,)
        result = list(result) + [None] * (len(ctx.tensor_in) - len(result))
        gs = [r if t else None for r, t in zip(result, ctx.tensor_in)]
        return (None, None, None, *gs)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        shape = {}
        outs = _PyLayerFunction.apply(cls, kwargs, shape, *args)
        return outs[0] if shape["single"] else outs


def once_differentiable(fn):
    """As in the reference, the backward is returned as it is (a PyLayer
    is never differentiated twice)."""
    return fn
