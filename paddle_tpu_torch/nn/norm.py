"""``RMSNorm``, ``LayerNorm`` and the batch norms.  Counterparts of
``paddle_tpu/nn/norm.py`` ``RMSNorm``, ``LayerNorm``, ``_BatchNormBase``,
``BatchNorm1D/2D/3D`` and ``BatchNorm``: weights of ones (and a bias of
zeros) on ``device`` (default CUDA, see ``device.resolve_device``),
applied through ``nn.functional`` (``rms_norm``: the fused kernel under
``FLAGS_use_fused_rms_norm``, else the plain op; ``layer_norm``: the
plain op; ``batch_norm``).  A batch norm's running statistics are fp32
buffers named as in the reference's state dict, ``_mean`` (zeros) and
``_variance`` (ones)."""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, epsilon={self._epsilon}"


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with a weight and a bias of
    ``[normalized_shape]``; ``epsilon`` defaults to 1e-5, as in
    ``paddle_tpu`` (BERT's embeddings pass 1e-12, its encoder layers keep
    the default)."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        if not isinstance(normalized_shape, int):
            (normalized_shape,) = normalized_shape
        device = resolve_device(device)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, epsilon={self._epsilon}"


class _BatchNormBase(nn.Module):
    """Batch norm over the channel axis (axis 1 for ``NCHW``, ``NCL``,
    ``NC`` and ``NCDHW``, the last otherwise), momentum 0.9 and epsilon
    1e-5 by default.  In training mode it normalises with the batch
    statistics and updates ``_mean`` / ``_variance`` from them, unless
    ``stats_frozen`` is set (``running_stats_frozen``); in eval mode, or
    with ``use_global_stats``, it normalises with the running ones.
    ``weight_attr=False`` / ``bias_attr=False`` drop the parameter."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = ("NCHW" if data_format in
                             ("NCHW", "NCL", "NC", "NCDHW") else "NHWC")
        self._use_global_stats = use_global_stats
        self.stats_frozen = False
        self.weight = (nn.Parameter(torch.ones(num_features, device=device,
                                               dtype=dtype))
                       if weight_attr is not False else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, device=device,
                                              dtype=dtype))
                     if bias_attr is not False else None)
        self.register_buffer("_mean", torch.zeros(
            num_features, device=device, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            num_features, device=device, dtype=torch.float32))

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
                 use_global_stats=None, device=None, dtype=torch.float32):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon,
                         weight_attr=param_attr, bias_attr=bias_attr,
                         data_format=data_layout,
                         use_global_stats=use_global_stats, device=device,
                         dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return F.relu(out) if self._act == "relu" else out


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
