"""Functional ops of the port's layers.  Counterpart of
``paddle_tpu/nn/functional/__init__.py`` ``rms_norm``, ``layer_norm``,
``dropout`` and ``scaled_dot_product_attention``; the other ops of the
training paths are called from ``ops.nn_ops`` directly.  Random draws
take an explicit ``torch.Generator``."""
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


def layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last axis (``ops.nn_ops.layer_norm``: statistics
    in x's dtype, weight and bias cast to it)."""
    return nn_ops.layer_norm(x, weight, bias, epsilon)


def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator=None):
    """Dropout (``ops.nn_ops.dropout``) with masks from ``generator``."""
    return nn_ops.dropout(x, p, training, mode, generator)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, impl="auto",
                                 generator=None):
    """Attention on ``[batch, seq, heads, head_dim]`` (``ops.nn_ops.sdpa``,
    routed as ``_sdpa_plain`` routes); attention dropout at
    ``dropout_p`` only when ``training``, drawn from ``generator``."""
    p = float(dropout_p) if training else 0.0
    return nn_ops.sdpa(query, key, value, attn_mask, causal=bool(is_causal),
                       impl=impl, dropout_p=p, generator=generator)
