"""``paddle.nn.functional`` of the port.  Counterpart of
``paddle_tpu/nn/functional/__init__.py`` (and of its ``extended``
module, ``.extended`` here): ``linear``, ``embedding``, ``one_hot``, the
norms (``rms_norm``: the fused kernel under ``FLAGS_use_fused_rms_norm``;
``layer_norm``, ``group_norm``, ``batch_norm``, ``instance_norm``,
``local_response_norm``, ``normalize``), the dropouts, the convs and
pools (the N-d tail in ``ops/nn_ops_nd.py``), ``interpolate``, the
losses, the activations of ``ops.activation`` (re-exported, with their
in-place forms) and the attention entry points:
``scaled_dot_product_attention``, ``flash_attention``,
``flash_attn_qkvpacked``, ``flash_attn_varlen_qkvpacked``,
``flash_attention_with_sparse_mask`` and ``sparse_attention`` all reach
``ops.nn_ops.sdpa``, which routes as the reference's ``_sdpa_plain``
does: on a CUDA tensor causal S in [1024, 2048] at D = 128 without
dropout to the hand-written ``long_attention`` kernels, S <= 1024 at D
64 or 128 to the hand-written ``short_attention`` kernels (with their
hash dropout), masks to the einsum route.

Random draws (the dropouts, attention dropout, ``rrelu``,
``gumbel_softmax``, ``class_center_sample``) take an explicit
``generator=`` (a ``torch.Generator`` on the tensor's device) and
otherwise draw from the port's default generator of that device
(``ops.random.generator``, reseeded by ``paddle.seed``), never from
torch's global one."""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import ops  # noqa: F401  - the reference's module exposes ops
from ...amp.state import no_amp
from ...ops.registry import dispatch
from ...core.flags import flag
from ...ops import nn_ops
from ...ops import nn_ops_nd as nd
from ...ops.activation import (  # noqa: F401  - re-exported activations
    celu, elu, gelu, glu, hardshrink, hardsigmoid, hardswish, hardtanh,
    leaky_relu, log_sigmoid, log_softmax, mish, prelu, relu, relu6, selu,
    sigmoid, silu, softmax, softplus, softshrink, softsign, swish, swiglu,
    tanh, tanhshrink, thresholded_relu,
)
from ...ops.manipulation import pad  # noqa: F401

Tensor = torch.Tensor


def _generator(generator, device):
    """``generator``, or the port's default generator of ``device``."""
    if generator is not None:
        return generator
    from ...ops.random import generator as default

    return default(device)


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)``, ``weight [in, out]``: the matmul with
    jnp's promotion of two float dtypes (the AMP-cast ``matmul`` op),
    the bias cast to the product's dtype before the add, so an fp32 bias
    never promotes a bf16 stream (the reference's ``linear``)."""
    out = _matmul(x, weight)
    if bias is not None:
        from ...amp.state import cast

        out = out + cast(bias, out.dtype)
    return out


@dispatch("matmul")
def _matmul(x, w):
    """``x @ w`` with jnp's promotion of two float dtypes (the
    reference's ``matmul`` op; under AMP both come cast by the policy)."""
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w)


@dispatch("embedding", datas=("weight", "x"))
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` (``nn.common.embedding_grad``'s backward, the
    same bits on every run); with ``padding_idx >= 0`` the rows of that
    id are zero in the output and get no gradient."""
    from ..common import _EmbeddingFn

    out = _EmbeddingFn.apply(x, weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


def one_hot(x, num_classes, name=None):
    return ops.one_hot(x, num_classes)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last axis.  With ``FLAGS_use_fused_rms_norm`` on
    and a weight, the fused op (``ops/kernels/rms_norm.py``: the kernel
    for CUDA tensors, its plain version for CPU ones, both with the fused
    rounding rule); otherwise the plain op ``ops.nn_ops.rms_norm``."""
    if weight is not None and flag("FLAGS_use_fused_rms_norm"):
        return _fused_rms_norm(x, weight, epsilon)
    return nn_ops.rms_norm(x, weight, epsilon)


@dispatch("fused_rms_norm")
def _fused_rms_norm(x, weight, epsilon):
    from ...ops.kernels.rms_norm import fused_rms_norm

    return fused_rms_norm(x, weight, epsilon)


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-5, name=None):
    """LayerNorm over the trailing axes ``normalized_shape`` names (the
    last one by default) as ``ops.nn_ops.layer_norm`` computes it:
    statistics in x's dtype, weight and bias cast to it.  A bias without
    a weight takes a weight of ones (the reference's affine pair)."""
    if weight is None and bias is not None:
        weight = torch.ones_like(bias)
    n = 1
    if normalized_shape is not None and not isinstance(normalized_shape,
                                                       int):
        n = max(len(tuple(normalized_shape)), 1)
    if n == 1:
        return nn_ops.layer_norm(x, weight, bias, epsilon)
    lead = x.shape[:x.dim() - n]
    flat = lambda t: None if t is None else t.reshape(-1)  # noqa: E731
    return nn_ops.layer_norm(x.reshape(*lead, -1), flat(weight),
                             flat(bias), epsilon).reshape(x.shape)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=epsilon)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Dropout (``ops.nn_ops.dropout``) with masks from ``generator``
    (default: the port's generator of x's device).  ``axis`` is
    ignored, as the reference ignores it."""
    if training and p > 0.0:
        generator = _generator(generator, x.device)
    return nn_ops.dropout(x, p, training, mode, generator)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, impl="auto",
                                 flash_blocks=None, *, generator=None):
    """Attention on ``[batch, seq, heads, head_dim]`` (``ops.nn_ops.sdpa``,
    routed as ``_sdpa_plain`` routes); attention dropout at
    ``dropout_p`` only when ``training``, drawn from ``generator``
    (default: the port's generator of the query's device).
    ``flash_blocks`` (the reference's Pallas block sizes) is ignored."""
    p = float(dropout_p) if training else 0.0
    if p > 0.0:
        generator = _generator(generator, query.device)
    return nn_ops.sdpa(query, key, value, attn_mask, causal=bool(is_causal),
                       impl=impl, dropout_p=p, generator=generator)


# -- diffusion: group norm, resizing ------------------------------------------------

def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW", name=None):
    """``ops.nn_ops.group_norm``: statistics in x's dtype, then weight and
    bias with the reference's type promotion (fp32 parameters make a bf16
    x's output fp32)."""
    return nn_ops.group_norm(x, weight, bias, float(epsilon),
                             int(num_groups), data_format)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
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
                  use_softmax=True, label_smoothing=0.0, name=None):
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
                                     reduction="mean", pos_weight=None,
                                     name=None):
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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-row loss ``[..., 1]`` (fp32); hard labels may carry a
    trailing axis of 1.  With ``return_softmax``, ``(loss, softmax)``."""
    if not soft_label and label.dim() == logits.dim():
        label = label.squeeze(-1)
    loss = nn_ops.softmax_with_cross_entropy(logits, label, soft_label,
                                             ignore_index, axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    d = input - label
    return _reduce_loss(d * d, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce_loss(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 / delta * d²`` where ``|d| < delta``, else ``|d| - delta / 2``
    (the reference's form)."""
    d = input - label
    ad = torch.abs(d)
    loss = torch.where(ad < delta, d * d * (0.5 / delta), ad - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[label]`` along the last axis, times ``weight[label]``;
    ``ignore_index`` is not applied, as in the reference."""
    picked = -torch.take_along_dim(input, label.long()[..., None],
                                   dim=-1).squeeze(-1)
    if weight is not None:
        picked = picked * weight[label.reshape(-1).long()].reshape(
            picked.shape)
    return _reduce_loss(picked, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """``-(y log p + (1 - y) log(1 - p))``, p clipped to [1e-12,
    1 - 1e-12]."""
    c = torch.clamp(input, 1e-12, 1 - 1e-12)
    loss = -(label * torch.log(c) + (1.0 - label) * torch.log(1.0 - c))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / float(input.shape[0])
    return _reduce_loss(loss, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    """``binary_cross_entropy`` without reduction (``epsilon`` unused, as
    in the reference)."""
    return binary_cross_entropy(input, label, reduction="none")


# -- attention entry points ---------------------------------------------------

def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    training=True, name=None, *, generator=None):
    """``(out, None)``: ``scaled_dot_product_attention`` on ``[B, S, H,
    D]``; the softmax matrix is never formed, so ``return_softmax``
    raises."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attention(return_softmax=True) is not supported: the "
            "fused path never materializes the softmax matrix")
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training,
                                       generator=generator)
    return out, None


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, training=True, name=None, *,
                         generator=None):
    """``qkv [B, S, 3, H, D]`` unpacked into q, k, v for
    ``scaled_dot_product_attention``; ``(out, None)`` with
    ``return_softmax``."""
    out = scaled_dot_product_attention(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dropout_p=dropout,
        is_causal=causal, training=training, generator=generator)
    return (out, None) if return_softmax else out


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale,
                                dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None, *, generator=None):
    """Packed sequences ``qkv [T, 3, H, D]`` cut at ``cu_seqlens_q``
    (read on the host), each attended alone and concatenated; a given
    ``scale`` multiplies q by ``scale * sqrt(D)`` first (the attention
    applies ``1 / sqrt(D)``), as the reference does."""
    cq = [int(v) for v in torch.as_tensor(cu_seqlens_q).tolist()]
    D = qkv.shape[-1]
    outs = []
    for lo, hi in zip(cq[:-1], cq[1:]):
        seg = qkv[lo:hi]
        q, k, v = seg[:, 0][None], seg[:, 1][None], seg[:, 2][None]
        if scale is not None:
            q = q * (float(scale) * math.sqrt(D))
        outs.append(scaled_dot_product_attention(
            q, k, v, dropout_p=dropout, is_causal=causal, training=training,
            generator=generator)[0])
    return torch.cat(outs, dim=0)


def flash_attention_with_sparse_mask(query, key, value,
                                     attn_mask_start_row_indices=None,
                                     attn_mask_start_row=0, dropout_p=0.0,
                                     is_causal=True, training=True,
                                     name=None, *, generator=None):
    """Attention under the dense additive mask the reference builds from
    ``attn_mask_start_row_indices [B, S]``: row r attends to column c
    where ``r >= start[c]`` (0), else -1e30, ``[B, 1, S, S]`` fp32 made
    on the device (the masked einsum route)."""
    mask = None
    if attn_mask_start_row_indices is not None:
        starts = torch.as_tensor(attn_mask_start_row_indices,
                                 device=query.device)
        S = query.shape[1]
        rows = torch.arange(S, device=query.device)[:, None]
        keep = rows >= (starts[:, None, None, :] if starts.dim() == 2
                        else starts[..., None, :])
        mask = torch.where(keep, 0.0, -1e30).to(torch.float32)
    return scaled_dot_product_attention(
        query, key, value, attn_mask=mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training, generator=generator)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention on ``[B, H, S, D]`` where row r of head (b, h) sees only
    the columns ``sparse_csr_columns[b, h, off[r]:off[r + 1]]``
    (``off = sparse_csr_offset[b, h]``): the CSR pattern is expanded on
    the device to an additive mask (0 kept, -1e30 dropped) and the
    attention takes the masked einsum route.  ``key_padding_mask`` and
    ``attn_mask`` are not applied, as in the reference."""
    B, H, S, _ = query.shape
    dev = query.device
    offs = torch.as_tensor(sparse_csr_offset, device=dev).long()
    cols = torch.as_tensor(sparse_csr_columns, device=dev).long()
    j = torch.arange(cols.shape[-1], device=dev).expand(B, H, -1)
    row = torch.searchsorted(offs.contiguous(), j.contiguous(),
                             right=True) - 1
    valid = j < offs[..., -1:]
    flat = torch.full((B, H, S * S), -1e30, dtype=torch.float32, device=dev)
    idx = torch.where(valid, row.clamp(0, S - 1) * S + cols.clamp(0, S - 1),
                      S * S)
    flat = torch.cat([flat, flat.new_zeros(B, H, 1)], -1)
    flat.scatter_(-1, idx, 0.0)
    mask = flat[..., :S * S].reshape(B, H, S, S)
    out = scaled_dot_product_attention(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
        attn_mask=mask)
    return out.transpose(1, 2)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """``(q', k', v)``: rotary embedding of q and k on ``[B, S, H, D]``
    (``ops.nn_ops.fused_rope``, the tables cast to q's dtype)."""
    cos, sin = torch.as_tensor(cos), torch.as_tensor(sin)
    qo, ko = nn_ops.fused_rope(q, q if k is None else k,
                               cos.to(q.device), sin.to(q.device),
                               position_ids, bool(use_neox_rotary_style))
    return qo, (None if k is None else ko), v


# -- misc -----------------------------------------------------------------------

def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Im2col ``[N, C * kh * kw, L]`` (channel-major patches)."""
    p = nn_ops._pair
    return torch.nn.functional.unfold(x, p(kernel_sizes), p(dilations),
                                      p(paddings), p(strides))


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    n = label.shape[-1]
    return label * (1 - epsilon) + epsilon / n


def _channel_dropout(x, p, training, shape, generator):
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.empty(shape, device=x.device).bernoulli_(
        keep, generator=_generator(generator, x.device)).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator=None):
    """Drops whole channels of a 4-D x, the kept ones divided by
    ``1 - p``."""
    shape = ((x.shape[0], x.shape[1], 1, 1) if data_format == "NCHW"
             else (x.shape[0], 1, 1, x.shape[-1]))
    return _channel_dropout(x, p, training, shape, generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator=None):
    """Drops whole channels of a 5-D x."""
    shape = ((x.shape[0], x.shape[1], 1, 1, 1) if data_format == "NCDHW"
             else (x.shape[0], 1, 1, 1, x.shape[-1]))
    return _channel_dropout(x, p, training, shape, generator)


_ALPHA_P = -1.6732632423543772 * 1.0507009873554805


def _alpha_dropout(x, p, training, shape, generator):
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    a = (keep + _ALPHA_P ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * _ALPHA_P * (1 - keep)
    mask = torch.empty(shape, device=x.device).bernoulli_(
        keep, generator=_generator(generator, x.device)).bool()
    return a * torch.where(mask, x, torch.full((), _ALPHA_P, dtype=x.dtype,
                                               device=x.device)) + b


def alpha_dropout(x, p=0.5, training=True, name=None, *, generator=None):
    """SELU-preserving dropout: dropped entries become ``alpha'`` and the
    result is ``a * x' + b``, keeping the mean and variance."""
    return _alpha_dropout(x, p, training, x.shape, generator)


def feature_alpha_dropout(x, p=0.5, training=True, name=None, *,
                          generator=None):
    """``alpha_dropout`` dropping whole channels."""
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    return _alpha_dropout(x, p, training, shape, generator)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    p = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    return pad(x, [int(v) for v in p])


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] · weight[o] · x2[b] (+ bias)``, weight ``[out,
    in1, in2]``."""
    out = nn_ops.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def maxout(x, groups, axis=1, name=None):
    """Axis ``axis`` split into ``[groups, C / groups]`` and the max taken
    over the second (the reference's grouping)."""
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [groups, shape[axis] // groups]
    return x.reshape(shape).amax(dim=axis + 1)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: 1 where the index is below the length
    (``maxlen`` defaults to the largest length, read on the host)."""
    from ...core.dtype import convert_dtype

    x = torch.as_tensor(x)
    if maxlen is None:
        maxlen = int(x.max())
    ar = torch.arange(int(maxlen), device=x.device)
    return (ar < x[..., None].long()).to(convert_dtype(dtype))


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None, *,
          generator=None):
    """Leaky ReLU whose negative slope is drawn per element from
    U(lower, upper) in training (fp32), and is their mean otherwise."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)
    slope = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    slope.uniform_(lower, upper, generator=_generator(generator, x.device))
    return torch.where(x >= 0, x, slope.to(x.dtype) * x)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s / size) ** beta``, s the sum of squares over a
    window of ``size`` channels (``size // 2`` before)."""
    half = size // 2
    sq = torch.square(x)
    pads = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    padded = torch.nn.functional.pad(sq, pads)
    s = sum(padded[:, i:i + x.shape[1]] for i in range(size))
    return x / torch.pow(k + alpha * s / size, beta)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per-(N, C) statistics over the spatial axes (population
    variance); the running statistics are not used, as in the
    reference."""
    axes = tuple(range(2, x.dim()))
    mu = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    out = (x - mu) * (1.0 / torch.sqrt(var + eps))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM: of ``[N * T, C, H, W]`` the first ``C * shift_ratio`` channels
    move one step back in time, the next as many one step forward."""
    NT, C, H, W = x.shape
    v = x.reshape(NT // seg_num, seg_num, C, H, W)
    c1, c2 = int(C * shift_ratio), int(C * 2 * shift_ratio)
    left = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    right = torch.cat([torch.zeros_like(v[:, :1, c1:c2]),
                       v[:, :-1, c1:c2]], 1)
    return torch.cat([left, right, v[:, :, c2:]], 2).reshape(NT, C, H, W)


def gather_tree(ids, parents, name=None):
    """Beam-search backtrace over ``[T, B, W]``: from the last step, each
    beam's token, then its parent's, and so on."""
    T, _, W = ids.shape
    beams = torch.arange(W, dtype=ids.dtype, device=ids.device).expand(
        ids.shape[1:]).long()
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, beams)
        beams = torch.gather(parents[t], 1, beams).long()
    return torch.stack(toks, 0)


# -- loss tail --------------------------------------------------------------------

def dice_loss(input, label, epsilon=1e-5, name=None):
    """``mean(1 - (2 |X ∩ Y| + eps) / (|X| + |Y| + eps))`` over the batch;
    labels ``[..., 1]`` are class ids."""
    y = (torch.nn.functional.one_hot(label.squeeze(-1).long(),
                                     input.shape[-1]).to(input.dtype)
         if label.shape[-1] == 1 else label.to(input.dtype))
    red = tuple(range(1, input.dim()))
    inter = (input * y).sum(red)
    union = input.sum(red) + y.sum(red)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = (torch.clamp(logit, min=0) - logit * label
          + torch.log1p(torch.exp(-torch.abs(logit))))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * (1 - p_t) ** gamma * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    C = input.shape[1]
    y = label.long()
    correct = torch.take_along_dim(input, y[:, None], 1)
    diff = torch.clamp(margin - correct + input, min=0.0) ** p
    if weight is not None:
        diff = diff * weight[y][:, None]
    keep = torch.arange(C, device=input.device)[None, :] != y[:, None]
    return _reduce_loss((diff * keep).sum(-1) / C, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """``max(d(a, p) - d(a, n) + margin, 0)``, d ``distance_function``
    (default: ``pairwise_distance`` with p = 2)."""
    from .extended import pairwise_distance

    dist = distance_function or (
        lambda a, b: pairwise_distance(a, b, p=2.0))
    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce_loss(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree: the
    leaf of class y is heap node ``y + num_classes``, and each internal
    node on its way to the root adds a binary cross entropy of its
    logit ``x · weight[node - 1] (+ bias)`` against the branch bit; the
    batch mean.  Custom path tables raise, as in the reference."""
    if path_table is not None:
        raise NotImplementedError(
            "custom path_table/path_code hsigmoid is not implemented; "
            "the default complete-tree mode matches the reference")
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    cur = label.long().reshape(-1) + num_classes
    loss = torch.zeros((), dtype=input.dtype, device=input.device)
    for _ in range(depth + 1):
        bit = (cur % 2).to(input.dtype)
        parent = cur // 2
        node = torch.clamp(parent - 1, 0, weight.shape[0] - 1)
        logit = (input * weight[node]).sum(-1)
        if bias is not None:
            logit = logit + bias.reshape(-1)[node]
        ce = (torch.clamp(logit, min=0) - logit * bit
              + torch.log1p(torch.exp(-torch.abs(logit))))
        loss = loss + torch.where(parent >= 1, ce, torch.zeros_like(ce))
        cur = parent
    return loss.mean()


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """The combined-margin (ArcFace family) loss: the target logit
    becomes ``cos(m1 θ + m2) - m3``, all logits times ``scale``, then
    softmax cross entropy."""
    cos = torch.clamp(logits, -1.0, 1.0)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    y = label.long()
    onehot = torch.nn.functional.one_hot(y, logits.shape[-1]).bool()
    lsm = torch.log_softmax(torch.where(onehot, target, cos) * scale, -1)
    loss = _reduce_loss(-torch.take_along_dim(lsm, y[:, None], -1)[:, 0],
                   reduction)
    return (loss, torch.exp(lsm)) if return_softmax else loss


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """``(log-prob of each label, mean NLL)`` of the adaptive softmax: the
    head covers the shortlist and one logit per tail cluster, each
    tail ``x @ proj.T @ emb.T``."""
    y = label.long()
    head = input @ head_weight.t()
    if head_bias is not None:
        head = head + head_bias
    head_lsm = torch.log_softmax(head, -1)
    cutoffs = [int(c) for c in cutoffs]
    short = cutoffs[0]
    out = torch.where(y < short, torch.take_along_dim(
        head_lsm, torch.where(y < short, y, 0)[:, None], -1)[:, 0],
        torch.zeros((), dtype=input.dtype, device=input.device))
    for t, (proj, emb) in enumerate(tail_weights):
        lo, hi = cutoffs[t], cutoffs[t + 1]
        tail_lsm = torch.log_softmax((input @ proj.t()) @ emb.t(), -1)
        rel = torch.clamp(y - lo, 0, hi - lo - 1)
        out_t = head_lsm[:, short + t] + torch.take_along_dim(
            tail_lsm, rel[:, None], -1)[:, 0]
        out = torch.where((y >= lo) & (y < hi), out_t, out)
    return out, -out.mean()


def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None, *, generator=None):
    """``(remapped label, sampled class centers)``: every class present
    in ``label`` plus negatives drawn uniformly (a permutation from
    ``generator``, default the port's CPU generator) up to
    ``num_samples``, sorted; labels remapped to their index there (read
    on the host, as the reference reads them)."""
    y = np.asarray(torch.as_tensor(label).cpu())
    pos = np.unique(y)
    sampled = pos
    if len(pos) < num_samples:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        perm = torch.randperm(len(rest), generator=_generator(
            generator, torch.device("cpu"))).numpy()
        sampled = np.concatenate([pos, rest[perm[:num_samples - len(pos)]]])
    sampled = np.sort(sampled)
    remap = np.full(num_classes, -1, np.int64)
    remap[sampled] = np.arange(len(sampled))
    dev = torch.as_tensor(label).device
    return (torch.from_numpy(remap[y]).to(dev),
            torch.from_numpy(sampled.astype(np.int64)).to(dev))


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """The RNN-Transducer loss (Graves 2012) on joint logits ``[B, T,
    U + 1, V]``: the log-domain alpha recursion, and with
    ``fastemit_lambda > 0`` FastEmit (Yu et al. 2021) as the reference
    writes it, ``L - lambda * sum(sg(gamma) * emit_lp)`` with the
    emission posteriors gamma from an alpha-beta pass."""
    B, T, U1, _ = input.shape
    lsm = torch.log_softmax(input, -1)
    blank_lp = lsm[..., blank]
    y = label.long()
    y_idx = torch.cat([y, y.new_zeros(B, 1)], 1)[:, :U1]
    emit_lp = torch.take_along_dim(
        lsm, y_idx[:, None, :, None].expand(B, T, U1, 1), -1)[..., 0]
    NEG = -1e30
    t_len, u_len = input_lengths.long(), label_lengths.long()

    def scan_u(first, add):
        vals = [first[:, 0]]
        for u in range(1, U1):
            vals.append(torch.logaddexp(first[:, u],
                                        vals[u - 1] + add[:, u - 1]))
        return torch.stack(vals, 1)

    alphas = [scan_u(torch.cat([input.new_zeros(B, 1),
                                input.new_full((B, U1 - 1), NEG)], 1)
                     if U1 > 1 else input.new_zeros(B, 1), emit_lp[:, 0])]
    for t in range(1, T):
        alphas.append(scan_u(alphas[-1] + blank_lp[:, t - 1], emit_lp[:, t]))
    alpha = torch.stack(alphas, 1)
    t_idx = torch.clamp(t_len - 1, 0, T - 1)
    u_idx = torch.clamp(u_len, 0, U1 - 1)
    pick = lambda a: torch.take_along_dim(  # noqa: E731
        torch.take_along_dim(a, t_idx[:, None, None], 1)[:, 0],
        u_idx[:, None], 1)[:, 0]
    final = pick(alpha) + pick(blank_lp)
    loss = -final
    if fastemit_lambda > 0.0:
        dev = input.device
        t_rng = torch.arange(T, device=dev)[None, :]
        u_rng = torch.arange(U1, device=dev)[None, :]
        t_valid = t_rng < t_len[:, None]
        u_valid = u_rng <= u_len[:, None]
        is_final_u = u_rng == u_len[:, None]
        betas = [None] * T
        nxt = input.new_full((B, U1), NEG)
        for t in range(T - 1, -1, -1):
            final_t = (t_len - 1)[:, None] == t
            cont = torch.where(final_t, torch.where(
                is_final_u, 0.0, NEG), nxt) + blank_lp[:, t]
            vals = [None] * U1
            vals[U1 - 1] = cont[:, U1 - 1]
            for u in range(U1 - 2, -1, -1):
                vals[u] = torch.logaddexp(cont[:, u],
                                          vals[u + 1] + emit_lp[:, t, u])
            cur = torch.where(t_valid[:, t:t + 1] & u_valid,
                              torch.stack(vals, 1), NEG)
            betas[t] = nxt = cur
        beta = torch.stack(betas, 1)
        beta_up = torch.cat([beta[:, :, 1:], beta.new_full((B, T, 1), NEG)],
                            2)
        gamma = torch.exp(alpha + emit_lp + beta_up - final[:, None, None])
        gamma = torch.where(torch.isfinite(gamma), gamma, 0.0).detach()
        loss = loss - fastemit_lambda * (gamma * emit_lp).sum((1, 2))
    return _reduce_loss(loss, reduction)


# -- in-place activations --------------------------------------------------------

def _inplace(fn, name):
    from ...ops.inplace import _make_inplace

    return _make_inplace(fn, name)


relu_ = _inplace(relu, "relu")
tanh_ = _inplace(tanh, "tanh")
elu_ = _inplace(elu, "elu")
hardtanh_ = _inplace(hardtanh, "hardtanh")
leaky_relu_ = _inplace(leaky_relu, "leaky_relu")
softmax_ = _inplace(softmax, "softmax")
thresholded_relu_ = _inplace(thresholded_relu, "thresholded_relu")

from .extended import (  # noqa: F401,E402
    affine_grid, channel_shuffle, cosine_embedding_loss, cosine_similarity,
    ctc_loss, fold, gaussian_nll_loss, grid_sample, gumbel_softmax,
    hinge_embedding_loss, margin_ranking_loss, multi_label_soft_margin_loss,
    npair_loss, pairwise_distance, pixel_shuffle, pixel_unshuffle,
    poisson_nll_loss, soft_margin_loss, square_error_cost,
    triplet_margin_loss,
)
