"""Functional ops of the port's layers.  Counterpart of
``paddle_tpu/nn/functional/__init__.py`` ``rms_norm``, ``layer_norm``,
``dropout`` and ``scaled_dot_product_attention``, and for the vision
path ``conv2d``, the pools, ``batch_norm`` (with ``_bn_running_update``),
``cross_entropy``, ``binary_cross_entropy_with_logits``, ``relu``, and
for the vision zoo ``relu6``, ``hardswish``, ``hardsigmoid`` and
``swish``,
and for the diffusion path ``group_norm``, ``interpolate`` /
``upsample``, ``silu``, ``gelu`` and ``softmax``; the other ops of the language-model training paths are called from
``ops.nn_ops`` directly.  Random draws take an explicit
``torch.Generator``."""
from __future__ import annotations

import torch

from ..amp.state import amp_op, no_amp
from ..core.flags import flag
from ..ops import nn_ops

_CEIL = ("ceil_mode / divisor_override are not ported yet (ROADMAP.md "
         "Queue 1, item 4)")


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis.  With ``FLAGS_use_fused_rms_norm`` on
    and a weight, the fused op (``ops/kernels/rms_norm.py``: the kernel
    for CUDA tensors, its plain version for CPU ones, both with the fused
    rounding rule); otherwise the plain op ``ops.nn_ops.rms_norm``."""
    if weight is not None and flag("FLAGS_use_fused_rms_norm"):
        return _fused_rms_norm(x, weight, epsilon)
    return nn_ops.rms_norm(x, weight, epsilon)


@amp_op("fused_rms_norm")
def _fused_rms_norm(x, weight, epsilon):
    from ..ops.kernels.rms_norm import fused_rms_norm

    return fused_rms_norm(x, weight, epsilon)


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


def relu(x):
    return torch.relu(x)


@amp_op("relu6")
def relu6(x):
    """``min(max(x, 0), 6)``; the gradient passes where 0 < x < 6, as the
    reference's hand-written one does (``hardtanh``'s backward)."""
    return torch.nn.functional.hardtanh(x, 0.0, 6.0)


@amp_op("hardswish")
def hardswish(x):
    """``x * clip(x + 3, 0, 6) / 6``, in that order, in x's dtype."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@amp_op("hardsigmoid")
def hardsigmoid(x, slope=1 / 6, offset=0.5):
    """``clip(slope * x + offset, 0, 1)``."""
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@amp_op("swish")
def swish(x):
    """``x * sigmoid(x)`` (the reference's ``swish`` is ``jax.nn.silu``)."""
    return x * torch.sigmoid(x)


def silu(x):
    return nn_ops.silu(x)


def gelu(x, approximate=False):
    """GELU; only the exact erf form (``approximate=False``) is ported."""
    if approximate:
        raise NotImplementedError(
            "gelu(approximate=True) is not ported yet (ROADMAP.md Queue 1)")
    return nn_ops.gelu(x)


def softmax(x, axis=-1):
    return nn_ops.softmax(x, axis)


# -- diffusion: group norm, resizing ------------------------------------------------

def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """``ops.nn_ops.group_norm``: statistics in x's dtype, then weight and
    bias with the reference's type promotion (fp32 parameters make a bf16
    x's output fp32)."""
    return nn_ops.group_norm(x, weight, bias, float(epsilon),
                             int(num_groups), data_format)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """``paddle_tpu``'s ``F.interpolate``: without ``size`` the output is
    ``int(h * scale_factor)`` by ``int(w * scale_factor)``; resized by
    ``ops.nn_ops.interpolate`` (``"nearest"`` is torch's
    ``"nearest-exact"``; ``align_corners`` is ignored, as the reference
    ignores it)."""
    if size is None:
        h, w = (x.shape[2], x.shape[3]) if data_format == "NCHW" \
            else (x.shape[1], x.shape[2])
        size = (int(h * scale_factor), int(w * scale_factor))
    return nn_ops.interpolate(x, tuple(int(s) for s in size), mode,
                              data_format)


upsample = interpolate


# -- conv / pool ----------------------------------------------------------------

def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """``ops.nn_ops.conv2d`` plus the bias, reshaped to ``(1, -1, 1, 1)``
    (``(1, 1, 1, -1)`` for NHWC) and added in the output's dtype
    promotion, as ``paddle_tpu`` adds it."""
    out = nn_ops.conv2d(x, weight, stride, padding, dilation, groups,
                        data_format)
    if bias is not None:
        shape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
        out = out + bias.reshape(shape)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    """``ops.nn_ops.max_pool2d`` (stride defaults to the kernel size)."""
    if ceil_mode:
        raise NotImplementedError(_CEIL)
    return nn_ops.max_pool2d(x, kernel_size, stride, padding, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """``ops.nn_ops.avg_pool2d`` (stride defaults to the kernel size)."""
    if ceil_mode or divisor_override is not None:
        raise NotImplementedError(_CEIL)
    return nn_ops.avg_pool2d(x, kernel_size, stride, padding, exclusive,
                             data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return nn_ops.adaptive_avg_pool2d(x, output_size, data_format)


# -- batch norm -------------------------------------------------------------------

def _bn_running_update(running_mean, running_var, mean, var, momentum):
    """``new = momentum * old + (1 - momentum) * batch`` in place, the
    batch variance the biased one (not torch's unbiased running
    variance).  ``None`` buffers (a layer whose statistics are frozen,
    see ``nn.norm.running_stats_frozen``) are left alone, as
    ``paddle_tpu`` leaves them under a trace."""
    if running_mean is None:
        return
    m = momentum
    with torch.no_grad(), no_amp():
        running_mean.copy_(m * running_mean + (1 - m) * mean.detach())
        running_var.copy_(m * running_var + (1 - m) * var.detach())


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch norm as ``paddle_tpu`` routes it.  Training (and not
    ``use_global_stats``): with a weight and a bias the fused op
    (``ops.nn_ops.batch_norm_train``), else the batch statistics
    (``batch_norm_stats``) through the inference form; either way the
    running statistics are updated from the batch's.  Otherwise the
    inference form over the running statistics.  A bias without a weight
    gets a weight of ones."""
    if weight is None and bias is not None:
        weight = torch.ones_like(bias)
    if training and not use_global_stats:
        if weight is not None and bias is not None:
            out, mean, var = nn_ops.batch_norm_train(x, weight, bias,
                                                     epsilon, data_format)
            _bn_running_update(running_mean, running_var, mean, var,
                               momentum)
            return out
        mean, var = nn_ops.batch_norm_stats(x, data_format)
        _bn_running_update(running_mean, running_var, mean, var, momentum)
    else:
        mean, var = running_mean, running_var
    return nn_ops.batch_norm_infer(x, mean, var, weight, bias, epsilon,
                                   data_format)


# -- losses -------------------------------------------------------------------------

def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return nn_ops.mean_fp32acc(loss)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0):
    """``paddle_tpu``'s ``F.cross_entropy`` over ``softmax_with_cross_
    entropy`` (fp32 loss).  ``label_smoothing`` turns hard labels into
    one-hot rows, scales them by ``1 - label_smoothing`` and adds
    ``label_smoothing / classes`` rounded to the input's dtype, as the
    reference does.  ``weight`` scales each row by its label's weight.
    ``reduction="mean"`` with hard labels and a non-negative
    ``ignore_index`` divides by the number of rows not ignored (at least
    1); otherwise the plain mean, in which ignored rows count as 0."""
    if label_smoothing > 0.0:
        classes = input.shape[axis]
        if not soft_label:
            idx = torch.arange(classes, device=label.device)
            label = (label.long()[..., None] == idx).float()
            soft_label = True
        label = label * (1.0 - label_smoothing) + torch.full(
            (1,), label_smoothing / classes, dtype=input.dtype,
            device=input.device)
    if not soft_label and label.dim() == input.dim():
        label = label.squeeze(axis)
    loss = nn_ops.softmax_with_cross_entropy(
        input, label, soft_label, ignore_index, axis).squeeze(-1)
    if weight is not None and not soft_label:
        w = weight[label.reshape(-1).long().clamp(0, weight.shape[0] - 1)]
        loss = loss * w.reshape(loss.shape).to(loss.dtype)
    if reduction == "mean" and not soft_label and ignore_index is not None \
            and ignore_index >= 0:
        valid = (label != ignore_index).to(loss.dtype)
        return loss.sum() / torch.clamp(valid.sum(), min=1.0)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """``relu(x) - x·y + log1p(exp(-|x|))`` in the reference's order and
    dtypes (a bf16 logit against an fp32 label promotes at ``x·y``; the
    ``log1p`` term stays in the logit's dtype), times
    ``(pos_weight - 1)·y + 1`` and ``weight`` where given."""
    loss = (torch.relu(logit) - logit * label) \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        loss = loss * ((pos_weight - torch.ones_like(pos_weight)) * label
                       + torch.ones_like(label))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)
