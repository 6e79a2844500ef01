"""``RMSNorm``, ``LayerNorm``, ``GroupNorm``, the instance norms,
``LocalResponseNorm`` and the batch norms.  Counterparts of
``paddle_tpu/nn/norm.py`` with its constructors (``weight_attr``,
``bias_attr``, ``name``; ``device`` and ``dtype`` keyword-only): weights
of ones and biases of zeros (none with ``weight_attr=False`` /
``bias_attr=False``) on ``device`` (default: the current place), applied
through ``nn.functional`` (``rms_norm``: the fused kernel under
``FLAGS_use_fused_rms_norm``, else the plain op; ``layer_norm`` and
``group_norm``: the plain ops; ``batch_norm``).  A batch norm's running
statistics are fp32 buffers named as in the reference's state dict,
``_mean`` (zeros) and ``_variance`` (ones).  ``SyncBatchNorm`` is
``BatchNorm2D``, as the reference defines it on one device."""
from __future__ import annotations

import contextlib

import torch

from . import functional as F
from .initializer import Constant
from .layers import Layer


def _affine(layer, shape, weight_attr, bias_attr, device, dtype):
    """The weight (ones) and bias (zeros) of a norm layer, each absent
    when its attr is ``False``."""
    kw = dict(device=device, dtype=dtype)
    layer.weight = layer.create_parameter(
        shape, attr=weight_attr, default_initializer=Constant(1.0), **kw)
    layer.bias = layer.create_parameter(shape, attr=bias_attr,
                                        is_bias=True, **kw)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=Constant(1.0), device=device, dtype=dtype)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, epsilon={self._epsilon}"


class LayerNorm(Layer):
    """LayerNorm over the trailing axes ``normalized_shape`` (an int: the
    last), with a weight and a bias of that shape; ``epsilon`` defaults
    to 1e-5, as in ``paddle_tpu`` (BERT's embeddings pass 1e-12, its
    encoder layers keep the default)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _affine(self, self._normalized_shape, weight_attr, bias_attr,
                device, dtype)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class GroupNorm(Layer):
    """GroupNorm of ``num_channels`` in ``num_groups`` groups.  Its output
    follows the reference's promotion (``F.group_norm``): the fp32
    parameters a train step keeps (their names hold ``"norm"``) make a
    bf16 input's output fp32."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        _affine(self, [num_channels], weight_attr, bias_attr, device, dtype)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon, self._data_format)

    def extra_repr(self):
        return f"{self._num_groups}, epsilon={self._epsilon}"


class InstanceNorm2D(GroupNorm):
    """GroupNorm with one group per channel."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__(num_features, num_features, epsilon=epsilon,
                         weight_attr=weight_attr, bias_attr=bias_attr,
                         data_format=data_format, device=device, dtype=dtype)


class InstanceNorm1D(InstanceNorm2D):
    """On ``[N, C, L]``."""


class InstanceNorm3D(InstanceNorm2D):
    """On ``[N, C, D, H, W]``."""


class LocalResponseNorm(Layer):
    """``x / (k + alpha * s) ** beta``, s the sum of squares over a
    window of ``size`` channels (``size // 2`` before; the layer's form
    in the reference has no ``/ size``, unlike ``F.local_response_norm``)."""

    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        half = self.size // 2
        pads = [0, 0] * (x.dim() - 2) + [half, self.size - half - 1]
        padded = torch.nn.functional.pad(x * x, pads)
        acc = sum(padded[:, i:i + x.shape[1]] for i in range(self.size))
        return x / (self.k + self.alpha * acc) ** self.beta


class _BatchNormBase(Layer):
    """Batch norm over the channel axis (axis 1 for ``NCHW``, ``NCL``,
    ``NC`` and ``NCDHW``, the last otherwise), momentum 0.9 and epsilon
    1e-5 by default.  In training mode it normalises with the batch
    statistics and updates ``_mean`` / ``_variance`` from them, unless
    ``stats_frozen`` is set (``running_stats_frozen``); in eval mode, or
    with ``use_global_stats``, it normalises with the running ones."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = ("NCHW" if data_format in
                             ("NCHW", "NCL", "NC", "NCDHW") else "NHWC")
        self._use_global_stats = use_global_stats
        self.stats_frozen = False
        _affine(self, [num_features], weight_attr, bias_attr, device, dtype)
        dev = self.weight.device if self.weight is not None else None
        from ..device import resolve_device

        dev = dev or resolve_device(device)
        self.register_buffer("_mean", torch.zeros(
            num_features, device=dev, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            num_features, device=dev, dtype=torch.float32))

    def forward(self, x):
        frozen = (self.stats_frozen and self.training
                  and not self._use_global_stats)
        return F.batch_norm(
            x, None if frozen else self._mean,
            None if frozen else self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"{self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}")


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """The old-style ``BatchNorm(num_channels, act=None, ...)``;
    ``act="relu"`` applies a ReLU after."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, *, device=None, dtype=None,
                 **kwargs):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon,
                         weight_attr=param_attr, bias_attr=bias_attr,
                         data_format=data_layout,
                         use_global_stats=use_global_stats, device=device,
                         dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return F.relu(out) if self._act == "relu" else out


SyncBatchNorm = BatchNorm2D


@contextlib.contextmanager
def running_stats_frozen(module):
    """Within: every batch norm of ``module`` in training mode normalises
    with the batch statistics and leaves its running statistics as they
    are.  ``paddle_tpu``'s compiled train step behaves so (its running
    update skips traced values), and ``models.CompiledTrainStep`` sets
    this around its forward and backward, eager or captured."""
    layers = [m for m in module.modules() if isinstance(m, _BatchNormBase)]
    before = [m.stats_frozen for m in layers]
    for m in layers:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m, b in zip(layers, before):
            m.stats_frozen = b
