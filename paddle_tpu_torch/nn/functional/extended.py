"""The extended functional surface: CTC, the margin and metric losses,
the pixel and channel shuffles, ``affine_grid`` / ``grid_sample``,
``fold`` and ``gumbel_softmax``.  Counterpart of
``paddle_tpu/nn/functional/extended.py``, with its formulas (the CTC
loss as the extended-sequence alpha recursion over time, log-softmax
applied inside; ``pairwise_distance`` adding ``epsilon`` to the signed
difference), in plain PyTorch."""
from __future__ import annotations

import math

import torch

# the package defines both before it imports this module
from . import _generator, _reduce_loss as _reduce


# -- CTC ------------------------------------------------------------------------

def _ctc_nll(lp, labels, il, ll, blank):
    """Negative log likelihood per item of log-probs ``[T, B, C]``, labels
    ``[B, L]``: the alpha recursion over the extended sequence (blank,
    l1, blank, ..., blank), frozen past each item's input length."""
    T, B, _ = lp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    NEG = -1e30
    dev = lp.device
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    skip_ok = torch.cat([torch.zeros(B, 2, dtype=torch.bool, device=dev),
                         ext[:, 2:] != ext[:, :-2]], 1)
    emit = lambda t: torch.gather(lp[t], 1, ext)  # noqa: E731
    alpha = torch.full((B, S), NEG, dtype=lp.dtype, device=dev)
    alpha[:, 0] = lp[0, :, blank]
    if L > 0:
        alpha[:, 1] = emit(0)[:, 1]
    for t in range(1, T):
        prev1 = torch.cat([alpha.new_full((B, 1), NEG), alpha[:, :-1]], 1)
        prev2 = torch.cat([alpha.new_full((B, 2), NEG), alpha[:, :-2]], 1)
        prev2 = torch.where(skip_ok, prev2, NEG)
        new = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2) + emit(t)
        alpha = torch.where((t < il)[:, None], new, alpha)
    last = 2 * ll
    a_blank = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_label = torch.gather(alpha, 1, torch.clamp(last - 1, min=0)[:, None])
    a_label = torch.where(ll > 0, a_label[:, 0], NEG)
    return -torch.logaddexp(a_blank, a_label)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC over logits ``[T, B, C]`` (log-softmax applied here, in fp32);
    ``norm_by_times`` divides each item by its input length; ``"mean"``
    averages the losses each divided by its label length (warpctc's
    convention)."""
    lp = torch.log_softmax(log_probs.float(), -1)
    il, ll = input_lengths.long(), label_lengths.long()
    nll = _ctc_nll(lp, labels, il, ll, int(blank))
    if norm_by_times:
        nll = nll / torch.clamp(il.float(), min=1.0)
    if reduction == "mean":
        return (nll / torch.clamp(ll.float(), min=1.0)).mean()
    return _reduce(nll, reduction)


# -- metric / margin losses -------------------------------------------------------

def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    num = (x1 * x2).sum(axis)
    den = torch.linalg.vector_norm(x1, dim=axis) * torch.linalg.vector_norm(
        x2, dim=axis)
    return num / torch.clamp(den, min=eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``(sum |x - y + epsilon|^p)^(1/p)`` over the last axis."""
    d = torch.abs(x - y + epsilon)
    return (d ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(u, v):
        return (torch.abs(u - v + epsilon) ** p).sum(-1) ** (1.0 / p)

    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1.0 - cos,
                       torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    ls = torch.nn.functional.logsigmoid
    loss = -(label * ls(input) + (1 - label) * ls(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(-1), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        y1 = torch.clamp(label, min=1.0)
        stirling = (label * torch.log(y1) - label
                    + 0.5 * torch.log(2 * math.pi * y1))
        loss = loss + torch.where(label > 1, stirling, 0.0)
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + (label - input) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def square_error_cost(input, label):
    return (input - label) ** 2


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    logits = anchor @ positive.t()
    same = (labels[:, None] == labels[None, :]).to(logits.dtype)
    targets = same / same.sum(1, keepdim=True)
    xent = (-targets * torch.log_softmax(logits, 1)).sum(1).mean()
    reg = l2_reg * 0.25 * ((anchor * anchor).sum(1).mean()
                           + (positive * positive).sum(1).mean())
    return xent + reg


# -- pixel / grid ops ----------------------------------------------------------------

def _nchw_op(x, fmt, fn):
    if fmt == "NHWC":
        return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return fn(x)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    def fn(x):
        B, C, H, W = x.shape
        r = int(upscale_factor)
        out = x.reshape(B, C // (r * r), r, r, H, W).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(B, C // (r * r), H * r, W * r)

    return _nchw_op(x, data_format, fn)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    def fn(x):
        B, C, H, W = x.shape
        r = int(downscale_factor)
        out = x.reshape(B, C, H // r, r, W // r, r).permute(0, 1, 3, 5, 2, 4)
        return out.reshape(B, C * r * r, H // r, W // r)

    return _nchw_op(x, data_format, fn)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def fn(x):
        B, C, H, W = x.shape
        return x.reshape(B, groups, C // groups, H, W).transpose(
            1, 2).reshape(B, C, H, W)

    return _nchw_op(x, data_format, fn)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``theta [B, 2, 3]`` -> the sampling grid ``[B, H, W, 2]`` (fp32)."""
    _, _, H, W = (int(s) for s in out_shape)
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, H, device=dev)
        xs = torch.linspace(-1.0, 1.0, W, device=dev)
    else:
        ys = (torch.arange(H, device=dev) * 2 + 1) / H - 1
        xs = (torch.arange(W, device=dev) * 2 + 1) / W - 1
    gy, gx = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return torch.einsum("bij,hwj->bhwi", theta.float(), base)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """2-D grid sampling: ``x [B, C, H, W]``, ``grid [B, Hg, Wg, 2]`` in
    [-1, 1] (x, y) -> ``[B, C, Hg, Wg]``; zeros, border or reflection
    padding, bilinear or nearest (rounding half to even)."""
    B, C, H, W = x.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    if align_corners:
        fx, fy = (gx + 1) * (W - 1) / 2, (gy + 1) * (H - 1) / 2
    else:
        fx, fy = ((gx + 1) * W - 1) / 2, ((gy + 1) * H - 1) / 2
    if padding_mode == "reflection":
        def reflect(f, n):
            if n == 1:
                return torch.zeros_like(f)
            if align_corners:
                period = 2 * (n - 1)
                f = torch.remainder(torch.abs(f), period)
                return torch.where(f > n - 1, period - f, f)
            period = 2 * n
            f = torch.remainder(torch.abs(f + 0.5), period)
            f = torch.where(f > n, period - f, f) - 0.5
            return torch.clamp(f, 0, n - 1)

        fx, fy = reflect(fx, W), reflect(fy, H)
    flat = x.reshape(B, C, H * W)

    def gather(ix, iy):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(B, C, -1)).reshape(
            B, C, *ix.shape[1:])
        if padding_mode == "zeros":
            vals = vals * inb[:, None].to(vals.dtype)
        return vals

    if mode == "nearest":
        return gather(torch.round(fx).long(), torch.round(fy).long())
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
    top = gather(x0, y0) * (1 - wx) + gather(x0 + 1, y0) * wx
    bot = gather(x0, y0 + 1) * (1 - wx) + gather(x0 + 1, y0 + 1) * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """Col2im: ``[B, C * kh * kw, L]`` -> ``[B, C, H, W]``, overlapping
    patches summed."""
    pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)  # noqa
    return torch.nn.functional.fold(x, pair(output_sizes),
                                    pair(kernel_sizes), pair(dilations),
                                    pair(paddings), pair(strides))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None, *,
                   generator=None):
    """``softmax((x + g) / temperature)``, g Gumbel noise from U(1e-10, 1)
    (fp32, drawn from ``generator``, default the port's generator of
    x's device); ``hard`` returns the one-hot argmax with the soft
    gradient (straight through)."""
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    u.uniform_(1e-10, 1.0, generator=_generator(generator, x.device))
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (onehot - y).detach() + y
    return y
