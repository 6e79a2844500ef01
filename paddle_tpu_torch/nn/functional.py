"""Functional ops of the port's layers.  Counterpart of
``paddle_tpu/nn/functional/__init__.py`` ``rms_norm``, ``layer_norm``,
``dropout`` and ``scaled_dot_product_attention``; for the vision path
``conv2d``, ``conv1d``, ``conv2d_transpose``, the N-d tail
(``conv1d_transpose``, ``conv3d``, ``conv3d_transpose``, the 1-d and 3-d
max / average pools, ``lp_pool1d`` / ``lp_pool2d``, the adaptive pools,
``max_unpool1d`` / ``2d`` / ``3d``, ``fractional_max_pool2d`` / ``3d``:
``ops/nn_ops_nd.py``), the 2-d pools (``ceil_mode``, ``exclusive``,
``divisor_override``, ``return_mask``), ``batch_norm`` (with
``_bn_running_update``), ``cross_entropy``,
``binary_cross_entropy_with_logits``; for the diffusion path
``group_norm`` and ``interpolate`` / ``upsample`` (nearest, bilinear,
bicubic).  The activations (``relu``, ``relu6``, ``hardswish``,
``hardsigmoid``, ``swish``, ``silu``, ``gelu``, ``softmax``) are
``ops.activation``'s, re-exported as the reference re-exports them.
The other ops of the language-model training paths are called from
``ops.nn_ops`` directly.  Random draws take an explicit
``torch.Generator``."""
from __future__ import annotations

import torch

from ..amp.state import amp_op, no_amp
from ..core.flags import flag
from ..ops import nn_ops
from ..ops import nn_ops_nd as nd
from ..ops.activation import (  # noqa: F401  - re-exported activations
    gelu, hardsigmoid, hardswish, relu, relu6, silu, softmax, swish,
)


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


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    """``ops.nn_ops.conv1d`` (int stride, dilation, and padding or the
    first of a sequence, as the reference takes them) plus the bias as
    ``(1, -1, 1)``."""
    if isinstance(padding, (list, tuple)):
        padding = padding[0]
    out = nn_ops.conv1d(x, weight, int(stride), int(padding), int(dilation),
                        int(groups))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1)
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW"):
    """``ops.nn_ops.conv2d_transpose`` plus the bias; ``output_size`` is
    ignored, as the reference ignores it."""
    out = nn_ops.conv2d_transpose(x, weight, stride, padding,
                                  output_padding, dilation, groups,
                                  data_format)
    if bias is not None:
        shape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
        out = out + bias.reshape(shape)
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL"):
    out = nd.conv1d_transpose(x, weight, int(stride), int(padding),
                              int(output_padding), int(dilation),
                              int(groups))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1)
    return out


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NCDHW"):
    out = nd.conv3d(x, weight, stride, padding, dilation, int(groups))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW"):
    out = nd.conv3d_transpose(x, weight, stride, padding, output_padding,
                              dilation, int(groups))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out


def _nchw(fn, x, *args):
    """``fn`` of an NHWC x, computed in NCHW and moved back (each output
    of a tuple)."""
    out = fn(x.permute(0, 3, 1, 2), *args)
    if isinstance(out, tuple):
        return tuple(o.permute(0, 2, 3, 1) for o in out)
    return out.permute(0, 2, 3, 1)


def _no_mask_with_ceil(name, ceil_mode):
    if ceil_mode:
        raise NotImplementedError(
            f"{name}(return_mask=True) does not support ceil_mode")


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """``ops.nn_ops.max_pool2d`` (stride defaults to the kernel size).
    ``ceil_mode`` is ignored, as the reference's ``max_pool2d_op``
    ignores it (the output size is the floor one).  ``return_mask``:
    (values, int64 flat indices) from ``max_pool_with_index``, and with
    ``ceil_mode`` it raises, as the reference does."""
    stride = kernel_size if stride is None else stride
    if return_mask:
        _no_mask_with_ceil("max_pool2d", ceil_mode)
        if data_format == "NHWC":
            return _nchw(max_pool2d, x, kernel_size, stride, padding,
                         False, True)
        return nd.max_pool_with_index(x, nn_ops._pair(kernel_size),
                                      nn_ops._pair(stride),
                                      nn_ops._pair(padding))
    return nn_ops.max_pool2d(x, kernel_size, stride, padding, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """``ops.nn_ops.avg_pool2d`` (stride defaults to the kernel size);
    with ``ceil_mode`` or ``divisor_override`` the generic pool
    (``nn_ops_nd.avg_pool2d_g``), as the reference routes them."""
    stride = kernel_size if stride is None else stride
    if ceil_mode or divisor_override is not None:
        if data_format == "NHWC":
            return _nchw(avg_pool2d, x, kernel_size, stride, padding,
                         ceil_mode, exclusive, divisor_override)
        return nd.avg_pool2d_g(
            x, nn_ops._pair(kernel_size), nn_ops._pair(stride),
            nn_ops._pair(padding), bool(ceil_mode), bool(exclusive),
            None if divisor_override is None else float(divisor_override))
    return nn_ops.avg_pool2d(x, kernel_size, stride, padding, exclusive,
                             data_format)


def _pool_args(kernel_size, stride, padding, n):
    stride = kernel_size if stride is None else stride
    return (nd._tup(kernel_size, n), nd._tup(stride, n),
            nd._tup(padding, n))


def _max_pool(n, x, kernel_size, stride, padding, return_mask, ceil_mode):
    k, s, p = _pool_args(kernel_size, stride, padding, n)
    if return_mask:
        _no_mask_with_ceil(f"max_pool{n}d", ceil_mode)
        return nd.max_pool_with_index(x, k, s, p)
    pool = nd.max_pool1d if n == 1 else nd.max_pool3d
    return pool(x, k, s, p, bool(ceil_mode))


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False):
    return _max_pool(1, x, kernel_size, stride, padding, return_mask,
                     ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW"):
    return _max_pool(3, x, kernel_size, stride, padding, return_mask,
                     ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    k, s, p = _pool_args(kernel_size, stride, padding, 1)
    return nd.avg_pool1d(x, k, s, p, bool(ceil_mode), bool(exclusive))


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    k, s, p = _pool_args(kernel_size, stride, padding, 3)
    return nd.avg_pool3d(
        x, k, s, p, bool(ceil_mode), bool(exclusive),
        None if divisor_override is None else float(divisor_override))


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False):
    """``ceil_mode`` is ignored, as the reference ignores it."""
    k, s, p = _pool_args(kernel_size, stride, padding, 1)
    return nd.lp_pool1d(x, k, s, p, float(norm_type))


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW"):
    """``ceil_mode`` is ignored, as the reference ignores it."""
    k, s, p = _pool_args(kernel_size, stride, padding, 2)
    return nd.lp_pool2d(x, k, s, p, float(norm_type))


def adaptive_avg_pool1d(x, output_size):
    return nd.adaptive_avg_pool1d(x, output_size)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return nd.adaptive_avg_pool3d(x, output_size)


def _adaptive_max(x, output_size, n, return_mask):
    if return_mask:
        raise NotImplementedError(
            "return_mask with adaptive max pooling is not supported; "
            "use max_poolNd(return_mask=True) with explicit kernels")
    return {1: nd.adaptive_max_pool1d, 2: nd.adaptive_max_pool2d,
            3: nd.adaptive_max_pool3d}[n](x, output_size)


def adaptive_max_pool1d(x, output_size, return_mask=False):
    return _adaptive_max(x, output_size, 1, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False):
    return _adaptive_max(x, output_size, 2, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False):
    return _adaptive_max(x, output_size, 3, return_mask)


def _max_unpool(x, indices, n, kernel_size, stride=None, padding=0,
                output_size=None):
    k, s, p = _pool_args(kernel_size, stride, padding, n)
    if output_size is None:
        out_spatial = tuple((x.shape[2 + i] - 1) * s[i] - 2 * p[i] + k[i]
                            for i in range(n))
    else:
        out_spatial = tuple(int(v) for v in output_size[-n:])
    return nd.max_unpool(x, indices, out_spatial)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size)


def _fractional(x, n, output_size, random_u, return_mask, generator):
    if return_mask:
        raise NotImplementedError(
            f"fractional_max_pool{n}d(return_mask=True) is not supported")
    if random_u is None:
        if generator is None:
            raise ValueError(
                f"fractional_max_pool{n}d draws random_u: pass random_u or "
                "an explicit generator (a torch.Generator)")
        random_u = float(torch.rand((), generator=generator,
                                    device=generator.device))
    return nd.fractional_max_pool(x, nd._tup(output_size, n),
                                  (float(random_u),) * n)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, generator=None):
    """Regions from ``random_u``, or from one U(0, 1) draw of
    ``generator`` when it is None (the reference draws from its global
    key)."""
    return _fractional(x, 2, output_size, random_u, return_mask, generator)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, generator=None):
    return _fractional(x, 3, output_size, random_u, return_mask, generator)


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
