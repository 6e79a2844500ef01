"""Common layers: ``Linear``, ``Embedding``, the dropouts, ``Flatten``,
``Upsample``, the activation layers, ``PReLU`` and the containers
(``Sequential``, ``LayerList``, ``ParameterList``, ``LayerDict``).
Counterpart of ``paddle_tpu/nn/common.py``, with the reference's
constructors: positional arguments as the reference orders them, and
``device``, ``dtype`` and ``generator`` keyword-only.

Parameters are drawn as the reference draws them (``Linear``:
XavierUniform and a zero bias; ``Embedding``: Normal(0, 1) with the
``padding_idx`` row zeroed; ``PReLU``: ``init``), on ``device`` (default:
the current place) from ``generator`` (default: the port's generator of
that device, see ``nn.initializer``).  The models fill their weights
again from their own generators (``models.llama``, ``models.bert``,
``models/unet.py``, ``vision/models/``).

``Linear`` keeps paddle's layout, ``weight [in, out]``, so a
``paddle_tpu`` state dict loads without a transpose.  The dropouts draw
their masks from the ``generator`` they are given, else from the port's
generator of the input's device, never from torch's global one.
``Sequential`` and ``LayerList`` are torch's ``Sequential`` and
``ModuleList`` as ``Layer`` s: they name their children ``0``, ``1``,
... as ``paddle_tpu``'s do, so state dict keys such as
``layer1.0.downsample.0.weight`` match.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import activation as A
from ..ops import manipulation as M
from . import functional as F
from . import initializer as I
from .layers import Layer


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(Layer):
    """``y = x @ weight (+ bias)``, ``weight [in_features, out_features]``
    (XavierUniform), ``bias [out_features]`` (zeros; none with
    ``bias_attr=False``), computed by ``F.linear``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform(), **kw)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


def embedding_grad(ids, grad, num_embeddings, dtype):
    """The gradient of ``weight [num_embeddings, h]`` under ``weight[ids]``
    for the output gradient ``grad [..., h]``, the same bits on every
    run.  The library's CUDA backward sums the rows of a repeated id in
    no fixed order (atomics: a BERT step's token-type rows, one id
    18432 times, differ from run to run in fp32).  Here the ids are
    sorted (stably), the gradient rows taken in that order are summed
    as an fp64 running sum, and each id's sum is the difference of the
    running sum at its last and before its first row, rounded once to
    ``dtype`` and written at its row.  Every size is fixed by the
    inputs (no host synchronisation), so a CUDA graph can hold it."""
    flat = ids.reshape(-1).long()
    h = grad.shape[-1]
    sid, order = torch.sort(flat, stable=True)
    # [h, N]: the running sum along the last axis, which CUDA scans in
    # parallel per row (along the first it walks each column alone)
    rows = grad.reshape(-1, h).index_select(0, order).double()
    run = torch.cumsum(rows.t().contiguous(), 1)
    first = torch.searchsorted(sid, sid)
    before = run.index_select(1, (first - 1).clamp(min=0))
    before.masked_fill_((first == 0)[None, :], 0.0)
    last = torch.ones_like(sid, dtype=torch.bool)
    last[:-1] = sid[1:] != sid[:-1]
    # rows that end no run of ids go to a spare row past the table
    dst = torch.where(last, sid, num_embeddings)
    out = torch.zeros(num_embeddings + 1, h, dtype=dtype, device=grad.device)
    out.index_copy_(0, dst, (run - before).t().to(dtype))
    return out[:num_embeddings]


class _EmbeddingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.table = (weight.shape[0], weight.dtype)
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return None, embedding_grad(ids, grad, *ctx.table)


class _EmbeddingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.table = (weight.shape[0], weight.dtype)
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return None, embedding_grad(ids, grad, *ctx.table)


class Embedding(Layer):
    """Rows of ``weight [num_embeddings, embedding_dim]`` (Normal(0, 1),
    the ``padding_idx`` row zeroed), by ``F.embedding``: the backward is
    ``embedding_grad``'s, the same bits on every run."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0), dtype=dtype,
            device=device, generator=generator)
        if padding_idx is not None and self.weight.device.type != "meta":
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self._padding_idx)


class Dropout(Layer):
    """Dropout at rate ``p`` in ``mode`` (``upscale_in_train`` or
    ``downscale_in_infer``), active in training mode, its masks drawn
    from ``generator`` (a ``torch.Generator`` on the inputs' device;
    default: the port's generator of that device)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class Dropout2D(Dropout):
    """The reference's ``Dropout2D`` is its ``Dropout`` (element-wise)."""


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return M.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    """``F.interpolate`` to ``size`` or by ``scale_factor`` (``"nearest"``:
    the reference's index rule, torch's ``"nearest-exact"``)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners,
                             data_format=self.data_format)


# -- activation layers -------------------------------------------------------------

def _act_layer(name, fn, **defaults):
    """A layer applying ``fn(x, **kwargs)``; its constructor takes the
    keyword arguments in ``defaults`` (positionally in that order) and
    ``name``."""
    keys = list(defaults)

    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        merged = dict(defaults)
        merged.update(zip(keys, args))
        merged.update({k: v for k, v in kwargs.items() if k != "name"})
        self._kwargs = merged

    def forward(self, x):
        return fn(x, **self._kwargs)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "extra_repr": extra_repr,
                                 "__module__": __name__,
                                 "__doc__": f"``{fn.__name__}`` as a layer."})


ReLU = _act_layer("ReLU", A.relu)
ReLU6 = _act_layer("ReLU6", A.relu6)
GELU = _act_layer("GELU", A.gelu, approximate=False)
Sigmoid = _act_layer("Sigmoid", A.sigmoid)
Tanh = _act_layer("Tanh", A.tanh)
Silu = _act_layer("Silu", A.silu)
LeakyReLU = _act_layer("LeakyReLU", A.leaky_relu, negative_slope=0.01)
ELU = _act_layer("ELU", A.elu, alpha=1.0)
SELU = _act_layer("SELU", A.selu)
CELU = _act_layer("CELU", A.celu, alpha=1.0)
Softplus = _act_layer("Softplus", A.softplus, beta=1.0, threshold=20.0)
Softsign = _act_layer("Softsign", A.softsign)
Hardtanh = _act_layer("Hardtanh", A.hardtanh, min=-1.0, max=1.0)
Hardsigmoid = _act_layer("Hardsigmoid", A.hardsigmoid)
Hardswish = _act_layer("Hardswish", A.hardswish)
Swish = _act_layer("Swish", A.swish)
Mish = _act_layer("Mish", A.mish)
Tanhshrink = _act_layer("Tanhshrink", A.tanhshrink)
Softshrink = _act_layer("Softshrink", A.softshrink, threshold=0.5)
Hardshrink = _act_layer("Hardshrink", A.hardshrink, threshold=0.5)
ThresholdedReLU = _act_layer("ThresholdedReLU", A.thresholded_relu,
                             threshold=1.0)
LogSigmoid = _act_layer("LogSigmoid", A.log_sigmoid)
Softmax = _act_layer("Softmax", A.softmax, axis=-1)
LogSoftmax = _act_layer("LogSoftmax", A.log_softmax, axis=-1)


class PReLU(Layer):
    """``x`` where ``x >= 0``, else ``weight * x``; ``weight
    [num_parameters]`` starts at ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, dtype=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init), dtype=dtype,
            device=device)

    def forward(self, x):
        return A.prelu(x, self.weight, data_format=self._data_format)


# -- containers -----------------------------------------------------------------------

class Sequential(Layer, nn.Sequential):
    """Children ``0``, ``1``, ... (or the names of ``(name, layer)``
    pairs), applied in order."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], dict):
            layers = tuple(layers[0].items())
        elif len(layers) == 1 and isinstance(layers[0], (list, tuple)) \
                and layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)


class LayerList(Layer, nn.ModuleList):
    """A list of layers, children ``0``, ``1``, ..."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)


class ParameterList(Layer, nn.ParameterList):
    """A list of parameters named ``0``, ``1``, ..."""

    def __init__(self, parameters=None):
        Layer.__init__(self)
        if parameters is not None:
            for p in parameters:
                self.append(p)


class LayerDict(Layer, nn.ModuleDict):
    """Layers by name."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers:
            self.update(sublayers)
