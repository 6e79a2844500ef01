"""Functional ops of the port's layers.  Counterpart of
``paddle_tpu/nn/functional/__init__.py`` ``rms_norm``; the other ops of
the training path are called from ``ops.nn_ops`` directly."""
from __future__ import annotations

from ..core.flags import flag
from ..ops import nn_ops


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis.  With ``FLAGS_use_fused_rms_norm`` on
    and a weight, the fused op (``ops/kernels/rms_norm.py``: the kernel
    for CUDA tensors, its plain version for CPU ones, both with the fused
    rounding rule); otherwise the plain op ``ops.nn_ops.rms_norm``."""
    if weight is not None and flag("FLAGS_use_fused_rms_norm"):
        from ..ops.kernels.rms_norm import fused_rms_norm

        return fused_rms_norm(x, weight, epsilon)
    return nn_ops.rms_norm(x, weight, epsilon)
