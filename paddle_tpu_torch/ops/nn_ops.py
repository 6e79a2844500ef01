"""Plain PyTorch versions of the ops on the serving and training paths.

Counterparts of ``paddle_tpu/ops/nn_ops.py`` (``_rms_norm_plain``,
``_layer_norm_plain``, ``_rope_plain``, ``_sdpa_plain``, ``dropout_raw``,
``fused_linear_cross_entropy``, ``_softmax_ce_plain``) and
``paddle_tpu/ops/activation.py`` (``_swiglu_plain``, ``gelu``,
``silu``), with the
same dtype rules, so a bf16 stream rounds at the same places in both
packages.  Of these, only attention reaches a kernel here (``sdpa``
routes long sequences, and the region JAX gives its stock flash kernel,
to ``ops.kernels.long_attention`` and short ones to
``ops.kernels.short_attention``); the rest is plain
PyTorch in both packages (XLA ops in ``paddle_tpu``).  Every random draw
(dropout) takes an explicit ``torch.Generator`` on the tensor's device.

The vision path's ops (``conv2d``, the pools, the batch-norm trio and
``softmax_with_cross_entropy``) are XLA ops in ``paddle_tpu`` too, not
Pallas kernels: ``_conv2d_plain`` is ``lax.conv_general_dilated``, the
pools are ``reduce_window`` and the fused batch norm is an XLA fusion.
So the conv here is the library's (cuDNN on the card), and the others
are plain PyTorch with the reference's rounding points; batch norm and
the cross entropy are ``torch.autograd.Function`` s whose backward is the
reference's hand-written VJP.

The diffusion path's ops (``group_norm``, ``interpolate``, ``softmax``)
are XLA ops in ``paddle_tpu`` as well (``_group_norm_plain``,
``jax.image.resize``, ``jax.nn.softmax``), so they are plain PyTorch
here, with the reference's rounding points and dtype promotion.
"""
from __future__ import annotations

import contextlib
import functools
import math
import types

import torch
import torch.nn.functional as F

from .registry import arg, dispatch, recompute_vjp


@dispatch("rms_norm")
def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis: computed in fp32, cast back to
    ``x.dtype``, then multiplied by ``weight`` cast to ``x.dtype`` (an
    fp32 weight must not promote a bf16 activation stream)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(dt)
    if weight is not None:
        out = out * weight.to(dt)
    return out


@dispatch("einsum")
def einsum(eq, *operands):
    """``torch.einsum`` with jnp's promotion of mixed float dtypes (a bf16
    operand meeting an fp32 one computes in fp32); ``torch.einsum``
    refuses mixed dtypes."""
    dt = operands[0].dtype
    for o in operands[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in operands))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope(q, k, cos, sin, position_ids):
    """Half-split (neox) rotary embedding on ``[B, S, H, D]`` q and k, as
    the serving programs apply it.

    ``cos``/``sin`` are fp32 ``[S_max, D]`` tables and ``position_ids``
    ``[B, S]`` selects their rows.  As in jnp, a bf16 ``q`` times the
    fp32 table promotes: the outputs are fp32."""
    c = cos[position_ids][:, :, None, :]     # [B, S, 1, D]
    s = sin[position_ids][:, :, None, :]
    return q * c + _rotate_half(q) * s, k * c + _rotate_half(k) * s


def fused_rope(q, k, cos, sin, position_ids=None, neox=True):
    """Rotary embedding as the training path applies it
    (``F.fused_rotary_position_embedding``): the ``[S_max, D]`` tables are
    cast to q's dtype first, so a bf16 q/k stays bf16.  ``position_ids``
    ``[B, S]`` selects table rows (default: rows ``0..S-1``); ``neox``
    rotates half-split pairs, otherwise interleaved even/odd pairs."""
    cos, sin = cos.to(q.dtype), sin.to(q.dtype)
    if position_ids is not None:
        c = cos[position_ids][:, :, None, :]
        s = sin[position_ids][:, :, None, :]
    else:
        S = q.shape[1]
        c = cos[None, :S, None, :]
        s = sin[None, :S, None, :]
    if neox:
        rot = _rotate_half
    else:
        def rot(x):
            return torch.stack([-x[..., 1::2], x[..., 0::2]],
                               dim=-1).reshape(x.shape)
    return q * c + rot(q) * s, k * c + rot(k) * s


@dispatch("layer_norm")
def layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last axis as ``_layer_norm_plain`` computes it:
    mean and variance in **x's dtype** (a bf16 stream normalises in bf16,
    its sums accumulated in fp32 by the mean as in jnp), then weight and
    bias cast to x's dtype, so fp32 norm parameters never promote the
    stream.  The reciprocal square root is taken in fp32 and rounded
    once, as XLA rounds its bf16 ``rsqrt``: torch's bf16 ``rsqrt`` on the
    CPU is off by one bf16 ulp on about a third of its inputs."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((var + epsilon).float()).to(x.dtype)
    out = (x - mean) * rstd
    if weight is not None:
        out = out * weight.to(out.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


@dispatch("swiglu")
def swiglu(x, y=None):
    """``silu(x) * y``; with one argument, its last axis is split in two."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return x * torch.sigmoid(x) * y


@dispatch("gelu")
def gelu(x, approximate=False):
    """GELU in x's dtype: the exact erf form (``ops.gelu``'s default,
    ``approximate=False``, which BERT uses), or with ``approximate`` the
    tanh form ``0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))``
    (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")


@dispatch("silu")
def silu(x):
    """``x * sigmoid(x)`` in x's dtype (``ops.silu``); its gradient is the
    reference's ``g * s * (1 + x * (1 - s))``."""
    return torch.nn.functional.silu(x)


@dispatch("softmax")
def softmax(x, axis=-1):
    """Softmax along ``axis`` in x's dtype.  The reference's custom
    backward, ``out * (g - sum(out * g))``, is the library's own."""
    return torch.softmax(x, dim=axis)


# -- diffusion: group norm and resizing -------------------------------------------

@dispatch("group_norm")
def group_norm(x, weight=None, bias=None, epsilon=1e-5, groups=32,
               data_format="NCHW"):
    """``_group_norm_plain``: x viewed as ``[N, groups, C / groups,
    *spatial]``, its mean, then ``mean(square(xg - mean))`` (two passes,
    not E[x²] - E[x]²), both in **x's dtype** (sums accumulated in fp32
    and rounded once, as ``jnp.mean``), times ``rsqrt(var + epsilon)``
    (taken in fp32 and rounded once, as ``layer_norm`` takes it).  Then
    ``* weight`` and ``+ bias`` with jnp's type promotion: a bf16 x and
    fp32 norm parameters give an **fp32** output.  That is the opposite
    of ``layer_norm``, which casts its parameters into x's dtype, and it
    is why a UNet step under ``compute_dtype="bfloat16"`` computes in
    fp32 from its first GroupNorm on (ROADMAP.md Queue 3).  ``NHWC``
    moves the channel axis to 1 and back."""
    if data_format != "NCHW":
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[:2]
    spatial = x.shape[2:]
    xg = x.reshape(n, groups, c // groups, *spatial)
    axes = tuple(range(2, xg.dim()))
    count = math.prod(xg.shape[2:])
    mean = (_acc(xg).sum(dim=axes, keepdim=True) / count).to(x.dtype)
    d = xg - mean
    var = (_acc(d.square()).sum(dim=axes, keepdim=True) / count).to(x.dtype)
    rstd = torch.rsqrt((var + epsilon).float()).to(x.dtype)
    out = (d * rstd).reshape(x.shape)
    shape = (1, c) + (1,) * len(spatial)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if data_format != "NCHW":
        out = torch.movedim(out, 1, -1)
    return out


@functools.lru_cache(maxsize=64)
def _cubic_weights(n_in, n_out, antialias, device="cpu"):
    """``jax.image.resize``'s weight matrix ``[n_in, n_out]`` for one axis
    (``compute_weight_mat`` with scale ``n_out / n_in``, no translation),
    in fp32 as it is computed there: the sample point of output pixel i
    is ``(i + 0.5) / scale - 0.5``; the Keys cubic (a = -0.5) of the
    distance to each input pixel, widened by ``1 / scale`` when it
    shrinks and ``antialias``; taps outside the image are absent and
    each column is renormalised to sum to 1 (so an edge pixel's missing
    taps are dropped, where torch's bicubic clamps the index and its
    a = -0.75).  Built on the CPU, so that every device gets the same
    bits, and kept per (sizes, device): the result is read only."""
    scale = torch.tensor(n_out / n_in, dtype=torch.float32)
    inv = 1.0 / scale
    kscale = torch.clamp(inv, min=1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kscale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros(()), w)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(
        torch.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def cubic_resize(x, size, antialias=True):
    """``jax.image.resize(method="cubic")`` of an NCHW ``x`` to spatial
    ``size``: one weight matrix per axis whose size changes
    (:func:`_cubic_weights`),
    applied as two matmuls.  A bf16 (or fp16) x is resized in fp32 and
    rounded once."""
    dt = x.dtype
    out = x.float()
    for axis, n_out in ((2, int(size[0])), (3, int(size[1]))):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        w = _cubic_weights(n_in, n_out, bool(antialias), str(out.device))
        out = torch.movedim(torch.matmul(torch.movedim(out, axis, -1), w),
                            -1, axis)
    return out.to(dt)


@dispatch("interpolate")
def interpolate(x, size, mode="nearest", data_format="NCHW"):
    """``_interp_plain`` (``jax.image.resize``) to spatial ``size`` (h, w).
    ``jax.image.resize``'s ``"nearest"`` takes the source pixel under each
    output pixel's centre, which is torch's ``"nearest-exact"``: torch's
    ``"nearest"`` floors ``i * in / out`` instead and differs off integer
    upsampling (5 -> 3, 8 -> 4 give other pixels).  ``"bilinear"`` is
    ``jax.image.resize``'s ``"linear"``: half-pixel centres whatever
    ``align_corners`` says (the reference ignores it, and so does this),
    and a triangle filter widened by the scale when it shrinks, which is
    torch's ``bilinear`` with ``antialias=True``; a bf16 input is resized
    in fp32 and rounded once.  ``"bicubic"`` is ``jax.image.resize``'s
    ``"cubic"`` (:func:`cubic_resize`: Keys' a = -0.5, antialiased when
    it shrinks, taps renormalised at the edges), not torch's bicubic."""
    if mode not in ("nearest", "bilinear", "bicubic"):
        raise ValueError(f"unknown interpolate mode {mode!r}")
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    size = tuple(int(s) for s in size)
    if mode == "nearest":
        out = F.interpolate(x, size=size, mode="nearest-exact")
    elif mode == "bicubic":
        out = cubic_resize(x, size)
    else:
        out = F.interpolate(x.float(), size=size, mode="bilinear",
                            align_corners=False, antialias=True).to(x.dtype)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def _need_generator(generator, device, what):
    if generator is None:
        raise ValueError(f"{what} draws random numbers: pass an explicit "
                         "torch.Generator on the tensor's device")
    if generator.device.type != device.type:
        raise ValueError(f"{what}: the generator is on "
                         f"{generator.device}, the tensor on {device}")


@dispatch("dropout")
def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator=None):
    """Dropout as ``dropout_raw`` applies it.  Training: a Bernoulli keep
    mask (probability ``1 - p``) drawn from ``generator`` (on x's
    device), kept entries divided by ``1 - p`` in ``upscale_in_train``
    and passed as they are in ``downscale_in_infer``; the gradient takes
    the same mask.  Not training: ``downscale_in_infer`` scales by
    ``1 - p``, ``upscale_in_train`` is the identity."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training:
        if mode == "downscale_in_infer" and p > 0.0:
            return x * (1.0 - p)
        return x
    if p == 0.0:
        return x
    _need_generator(generator, x.device, "dropout")
    keep = 1.0 - p
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator).bool()
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


# -- attention ----------------------------------------------------------------

def attention_route(Sq, Sk, H, Hkv, D, causal, has_mask=False,
                    impl="auto", accelerated=True, has_dropout=False):
    """Which attention ``_sdpa_plain`` would run for these shapes:
    ``"long"`` (the ``long_attention`` kernel), ``"short"`` (the
    ``short_attention`` kernel), ``"flash"`` or ``"einsum"``.
    ``accelerated`` stands for JAX's ``on_tpu``: the port passes True on
    CUDA, False on the CPU; ``has_dropout`` for its dropout key (attention
    dropout in training), which only the short kernel and the einsum path
    take.  Raises ``ValueError`` where JAX does (``impl="short"`` or
    ``"flash"`` on shapes those kernels do not take)."""
    long_ok = (not has_mask and not has_dropout and Sq == Sk
               and D % 128 == 0 and Sq % 256 == 0 and Sq <= 2048
               and Hkv == H and accelerated)
    if impl == "auto" and long_ok and causal and Sq >= 1024:
        return "long"
    short_ok = (not has_mask and Sq == Sk and Sq <= 1024
                and Sq % 128 == 0 and D % 64 == 0 and D <= 128
                and Hkv == H and accelerated)
    if impl == "short" and not short_ok:
        raise ValueError(
            "impl='short' requires: an accelerator, no attn_mask, Sq == Sk "
            f"<= 1024, seq % 128 == 0, head_dim % 64 == 0, no GQA; got "
            f"Sq={Sq} Sk={Sk} D={D} H={H} Hkv={Hkv} mask={has_mask}")
    if short_ok and impl in ("auto", "short"):
        return "short"
    flash_ok = (not has_mask and not has_dropout and Sq == Sk
                and D % 128 == 0 and Sq % 512 == 0 and accelerated)
    if impl == "flash" and not flash_ok:
        raise ValueError(
            "impl='flash' requires: an accelerator, no attn_mask, no "
            "dropout, Sq == Sk, head_dim % 128 == 0, seq % 512 == 0; got "
            f"Sq={Sq} Sk={Sk} D={D} mask={has_mask} dropout={has_dropout}")
    if impl == "flash" or (impl == "auto" and flash_ok and causal
                           and Sq >= 1024):
        return "flash"
    return "einsum"


def _accelerated(device):
    """The port's ``on_tpu``: the kernels run for CUDA tensors."""
    return device.type == "cuda"


def _seed(generator, device):
    """One int32 seed for the short kernel's hash dropout, drawn from
    ``generator`` on ``device`` and left there: the kernel reads it from
    device memory, so drawing it does not synchronise."""
    return torch.randint(-2 ** 31, 2 ** 31, (1,), dtype=torch.int32,
                         device=device, generator=generator)


@dispatch("scaled_dot_product_attention")
def sdpa(q, k, v, mask=None, causal=False, scale=None, impl="auto",
         dropout_p=0.0, generator=None):
    """Scaled dot-product attention on ``[B, S, H, D]`` (the paddle
    flash-attention layout), GQA when k/v have fewer heads, with
    attention dropout at rate ``dropout_p`` (0 outside training) drawn
    from ``generator`` on q's device.

    Routes as ``_sdpa_plain`` does, with "a CUDA tensor" in place of "on
    a TPU": causal S in [1024, 2048] without dropout (S % 256 == 0,
    D % 128 == 0, the same heads for q and k/v, no mask) goes to the
    hand-written ``long_attention`` kernels; Sq == Sk <= 1024 (S % 128 ==
    0, D 64 or 128, no GQA, no mask) to the hand-written
    ``short_attention`` kernel, whose hash dropout takes an int32 seed
    drawn from the generator; the stock-flash region (``impl="flash"``,
    or causal S >= 1024 with GQA or S > 2048; S % 512 == 0, D % 128 ==
    0, no mask, no dropout) to ``long_attention`` too, with GQA by
    indexing and causal or not (JAX's ``_flash_attention_tpu``); the
    rest is the einsum path, grouped for GQA (q and k/v of two float
    dtypes meet in jnp's promotion, as an fp32 decode cache meets a bf16
    step): scores in q's dtype, then fp32 times the scale, masked, fp32
    softmax, probabilities cast to q's dtype, then dropped with a
    Bernoulli mask from the generator and divided by ``1 - p``."""
    B, Sq, H, D = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dropout_p = float(dropout_p)
    if dropout_p > 0.0:
        _need_generator(generator, q.device, "attention dropout")
    route = attention_route(Sq, Sk, H, Hkv, D, causal,
                            has_mask=mask is not None, impl=impl,
                            accelerated=_accelerated(q.device),
                            has_dropout=dropout_p > 0.0)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # B H S D
    if route in ("long", "flash"):
        from .kernels.long_attention import long_attention

        out = long_attention(qt, kt, vt, float(scale), bool(causal))
        return out.transpose(1, 2)
    if route == "short":
        from .kernels.short_attention import short_attention

        seed = _seed(generator, q.device) if dropout_p > 0.0 else None
        out = short_attention(qt, kt, vt, seed, float(scale), dropout_p,
                              bool(causal))
        return out.transpose(1, 2)
    grouped = Hkv != H
    if grouped:
        qt = qt.reshape(B, Hkv, H // Hkv, Sq, D)
        logits = einsum("bngqd,bnkd->bngqk", qt, kt)
    else:
        logits = einsum("bhqd,bhkd->bhqk", qt, kt)
    logits = logits.float() * scale
    if causal:
        keep = torch.ones(Sq, Sk, dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        logits = torch.where(keep, logits, torch.finfo(torch.float32).min)
    if mask is not None:
        if grouped and mask.dim() == 4:
            mask = (mask.reshape(B, Hkv, H // Hkv, Sq, Sk)
                    if mask.shape[1] == H else mask[:, :, None])
        logits = logits + mask
    probs = dropout(torch.softmax(logits, dim=-1).to(q.dtype), dropout_p,
                    True, "upscale_in_train", generator)
    if grouped:
        out = einsum("bngqk,bnkd->bngqd", probs, vt)
        out = out.reshape(B, H, Sq, D)
    else:
        out = einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)


# -- losses -------------------------------------------------------------------

def cross_entropy(logits, labels, ignore_index=-100):
    """Mean cross entropy of ``logits [N, V]`` against ``labels [N]``
    (``softmax_with_cross_entropy``: log-softmax in fp32): rows whose
    label is ``ignore_index`` give 0 and still count in the mean
    (``F.cross_entropy(reduction='mean')`` with a negative
    ``ignore_index``)."""
    return softmax_with_cross_entropy(logits, labels,
                                      ignore_index=ignore_index).mean()


def _flce_logits(hidden, weight, tied):
    return hidden @ (weight.t() if tied else weight)


def _flce_forward(hidden, weight, labels, tied, ignore_index):
    """``_flce_fwd``: (mean loss, lse [N] fp32)."""
    lf = _flce_logits(hidden, weight, tied).float()
    mx = lf.amax(dim=-1)
    lse = mx + torch.log(torch.exp(lf - mx[:, None]).sum(dim=-1))
    lab = labels.clamp(0, lf.shape[-1] - 1)
    tgt = lf.gather(-1, lab[:, None])[:, 0]
    nll = torch.where(labels != ignore_index, lse - tgt,
                      torch.zeros_like(lse))
    return nll.mean(), lse


class FusedLinearCrossEntropy(torch.autograd.Function):
    """``fused_linear_cross_entropy``'s custom VJP: the backward recomputes
    the logits and forms ``softmax - onehot`` in the hidden dtype, so the
    ``[N, V]`` fp32 log-softmax is never kept for the backward.  Under
    ``create_graph=True`` the backward is the VJP of the plain forward,
    recomputed under autograd (``registry.recompute_vjp``), as the
    reference differentiates its plain forward there."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, tied, ignore_index):
        loss, lse = _flce_forward(hidden, weight, labels, tied,
                                  ignore_index)
        ctx.save_for_backward(hidden, weight, labels, lse)
        ctx.cfg = (tied, ignore_index)
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, lse = ctx.saved_tensors
        tied, ignore_index = ctx.cfg
        if torch.is_grad_enabled():
            gs = recompute_vjp(
                lambda h, w: _flce_forward(h, w, labels, tied,
                                           ignore_index)[0],
                [hidden, weight], [g],
                [i for i in (0, 1) if ctx.needs_input_grad[i]])
            return gs[0], gs[1], None, None, None
        lf = _flce_logits(hidden, weight, tied).float()
        n, V = lf.shape
        lab = labels.clamp(0, V - 1)
        sm = torch.exp(lf - lse[:, None])
        oh = torch.arange(V, device=lf.device)[None, :] == lab[:, None]
        scale = (labels != ignore_index).float() * (g / n)
        dlogits = ((sm - oh.float()) * scale[:, None]).to(hidden.dtype)
        if tied:
            dh = dlogits @ weight
            dw = dlogits.t() @ hidden
        else:
            dh = dlogits @ weight.t()
            dw = hidden.t() @ dlogits
        return (dh.to(hidden.dtype), dw.to(weight.dtype), None, None,
                None)


def fused_linear_cross_entropy(hidden, weight, labels, tied=False,
                               ignore_index=-100):
    """Mean cross entropy over ``hidden [N, h] @ weight`` logits, weight
    ``[h, V]`` (``[V, h]`` when ``tied``, an embedding table used as the
    head); rows labelled ``ignore_index`` give 0 and count in the
    mean."""
    return FusedLinearCrossEntropy.apply(hidden, weight, labels,
                                         bool(tied), int(ignore_index))


# -- vision: convolution and pooling --------------------------------------------

def _pair(v, n=2):
    """``paddle_tpu``'s ``_pair``: an int repeated, a tuple of n taken as
    it is, any other sequence's first element repeated."""
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        return tuple(int(v[0]) for _ in range(n))
    return tuple(int(v) for _ in range(n))


def _acc(x):
    """x in its accumulation dtype: fp32 for bf16, fp16 and fp32 (the
    reference's ``astype(float32)``), fp64 kept as it is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


@dispatch("reduce_mean")
def mean_fp32acc(x, dim=None):
    """``jnp.mean``'s rounding: the sum accumulated in fp32, divided by
    the count and rounded once to x's dtype (bf16 included).  torch's
    own mean over bf16 also rounds once, but forms the quotient as
    ``sum * (1 / n)`` on CUDA; this form is the same on both devices."""
    if dim is None:
        dim = tuple(range(x.dim()))
    n = math.prod(x.shape[d] for d in dim)
    return (_acc(x).sum(dim=dim) / n).to(x.dtype)


@contextlib.contextmanager
def _fp32_conv(x):
    """Around a cuDNN convolution of fp32 CUDA tensors: TF32 off, so fp32
    computes in fp32 as the JAX op does.  ``torch.backends.cudnn.
    allow_tf32`` is True by default, and the library reads it when the
    convolution (or its backward) runs, so the flag is held off around
    both."""
    if not (x.is_cuda and x.dtype == torch.float32
            and torch.backends.cudnn.allow_tf32):
        yield
        return
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = True


class _Conv(torch.autograd.Function):
    """The library's convolution (cuDNN on the card), plain or transposed,
    in 1, 2 or 3 spatial dimensions, with its backward under the same
    TF32 rule as its forward.  With the library's defaults (no
    ``benchmark``, no ``deterministic``) the algorithms cuDNN picked for
    ResNet-50's forward, dgrad and wgrad gave the same bits run to run on
    the H100 (chip_smoke 12c), so no convolution of the port's own is
    needed for repeatable steps."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups,
                transposed=False, output_padding=None):
        output_padding = output_padding or (0,) * len(stride)
        ctx.save_for_backward(x, w)
        ctx.cfg = (stride, padding, dilation, transposed, output_padding,
                   groups)
        with _fp32_conv(x):
            return torch.ops.aten.convolution(
                x, w, None, stride, padding, dilation, transposed,
                output_padding, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _fp32_conv(x):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, *ctx.cfg, mask)
        return dx, dw, None, None, None, None, None, None


class _Conv2d(_Conv):
    """The 2-D convolution of ``conv2d`` (its own class, so that profiles
    name its backward ``_Conv2dBackward``)."""


def _same_pads(size, k, stride, dilation):
    """XLA's ``SAME`` padding of one axis: (lo, hi), the odd one at hi."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _conv2d_operands(args, kwargs):
    """The validator's view of a conv2d call, the weight as OIHW: an
    NHWC call takes an HWIO weight, which the reference's validator
    reads as OIHW (and refuses valid grouped calls)."""
    x, w = arg(args, kwargs, 0, "x"), arg(args, kwargs, 1, "weight")
    fmt = arg(args, kwargs, 6, "data_format", "NCHW")
    if fmt == "NHWC" and w.dim() == 4:
        w = types.SimpleNamespace(shape=(w.shape[3], w.shape[2],
                                         w.shape[0], w.shape[1]))
    return (x, w), {"groups": arg(args, kwargs, 5, "groups", 1),
                    "data_format": fmt}


@dispatch("conv2d", operands=_conv2d_operands)
def conv2d(x, weight, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """``_conv2d_plain``: the weight cast to x's dtype (``_conv_dtype``:
    an fp32 master weight joins a bf16 stream as bf16); stride, padding
    and dilation as ints, pairs or (padding) ``"SAME"`` / ``"VALID"``;
    ``groups``.  NCHW takes an OIHW weight; NHWC, as in the reference,
    an HWIO one.  Computed by the library's convolution (cuDNN on the
    card) in whatever memory format x and the weight carry; fp32 on the
    card computes in fp32 (TF32 off, see ``_fp32_conv``)."""
    w = weight.to(x.dtype)
    if data_format == "NHWC":
        x, w = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    elif data_format != "NCHW":
        raise ValueError(f"unknown data_format {data_format!r}")
    stride, dilation = _pair(stride), _pair(dilation)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        pads = [(0, 0), (0, 0)] if mode == "VALID" else [
            _same_pads(x.shape[2 + i], w.shape[2 + i], stride[i],
                       dilation[i]) for i in range(2)]
        if any(lo != hi for lo, hi in pads):
            x = F.pad(x, (*pads[1], *pads[0]))
            pads = [(0, 0), (0, 0)]
        padding = (pads[0][0], pads[1][0])
    else:
        padding = _pair(padding)
    out = _Conv2d.apply(x, w, stride, padding, dilation, int(groups))
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


@dispatch("conv1d")
def conv1d(x, weight, stride=1, padding=0, dilation=1, groups=1):
    """``_conv1d_plain``: ``[N, C, L]`` by an OIL weight ``[out, in /
    groups, k]`` cast to x's dtype; int stride, padding (both sides) and
    dilation."""
    return _Conv.apply(x, weight.to(x.dtype), (int(stride),),
                       (int(padding),), (int(dilation),), int(groups))


@dispatch("conv2d_transpose")
def conv2d_transpose(x, weight, stride=1, padding=0, output_padding=0,
                     dilation=1, groups=1, data_format="NCHW"):
    """``_conv2d_transpose_plain``: the gradient of a convolution (XLA's
    lhs-dilated convolution over the mirrored kernel is the library's
    transposed convolution), output ``(H - 1) * stride - 2 * padding +
    dilation * (k - 1) + output_padding + 1``.  NCHW takes an IOHW weight
    ``[in, out / groups, kh, kw]``; NHWC, as in the reference, an HWIO
    one."""
    w = weight.to(x.dtype)
    if data_format == "NHWC":
        x, w = x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1)
    elif data_format != "NCHW":
        raise ValueError(f"unknown data_format {data_format!r}")
    out = _Conv.apply(x, w, _pair(stride), _pair(padding), _pair(dilation),
                      int(groups), True, _pair(output_padding))
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def _pool_args(x, kernel_size, stride, padding, data_format):
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    elif data_format != "NCHW":
        raise ValueError(f"unknown data_format {data_format!r}")
    k = _pair(kernel_size)
    return (x, k, _pair(kernel_size if stride is None else stride),
            _pair(padding))


@dispatch("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, data_format="NCHW"):
    """``_max_pool2d_plain``: the max over each window, padding at -inf
    (the output size is the floor one).  The gradient goes to the first
    maximum in window order, as XLA's ``select_and_scatter`` gives it
    (``ge`` keeps the element already selected) and as the library's
    max-pool backward does (its argmax takes a later element only when
    strictly greater)."""
    x, k, s, p = _pool_args(x, kernel_size, stride, padding, data_format)
    if p[0] > k[0] // 2 or p[1] > k[1] // 2:    # past the library's limit
        x = F.pad(x, (p[1], p[1], p[0], p[0]), value=float("-inf"))
        p = (0, 0)
    out = F.max_pool2d(x, k, s, p)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


@dispatch("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               data_format="NCHW"):
    """``_avg_pool2d_plain``: window sums over the zero-padded input
    divided by the window size, or, with ``exclusive`` (the default), by
    the number of elements of the window inside the input."""
    x, k, s, p = _pool_args(x, kernel_size, stride, padding, data_format)
    if p[0] > k[0] // 2 or p[1] > k[1] // 2:    # past the library's limit
        pad = (p[1], p[1], p[0], p[0])
        out = F.avg_pool2d(F.pad(x, pad), k, s)
        if exclusive:
            ones = torch.ones_like(x[:1, :1])
            out = out / F.avg_pool2d(F.pad(ones, pad), k, s)
    else:
        out = F.avg_pool2d(x, k, s, p, count_include_pad=not exclusive)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


@dispatch("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """``_adaptive_avg_pool2d_plain``: a reshape and a mean when the
    sizes divide, else the mean of each interval ``[i*h // oh,
    ceil((i+1)*h / oh))``; means as ``jnp.mean`` rounds them
    (``mean_fp32acc``)."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    oh, ow = _pair(output_size)
    if h % oh == 0 and w % ow == 0:
        out = mean_fp32acc(x.reshape(n, c, oh, h // oh, ow, w // ow), (3, 5))
    else:
        hs = [(i * h // oh, ((i + 1) * h + oh - 1) // oh) for i in range(oh)]
        ws = [(j * w // ow, ((j + 1) * w + ow - 1) // ow) for j in range(ow)]
        out = torch.stack([torch.stack(
            [mean_fp32acc(x[:, :, h0:h1, w0:w1], (2, 3)) for w0, w1 in ws], -1)
            for h0, h1 in hs], -2)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


# -- vision: batch norm -----------------------------------------------------------

def _bn_axes_shape(ndim, data_format):
    """The reduced axes and the per-channel broadcast shape of the fused
    train op (``_bn_axes_shape``)."""
    if ndim == 2:
        return (0,), (1, -1)
    if data_format in ("NCHW", "NCL", "NCDHW"):
        return (0,) + tuple(range(2, ndim)), (1, -1) + (1,) * (ndim - 2)
    return tuple(range(ndim - 1)), (1,) * (ndim - 1) + (-1,)


@dispatch("batch_norm_stats")
def batch_norm_stats(x, data_format="NCHW"):
    """``_batch_norm_stats``: the batch mean and the biased variance in
    x's dtype (each accumulated in fp32 and rounded once, as ``jnp.mean``
    and ``jnp.var`` do).  The axes are the reference's: (0, 2, 3) for a
    4-D NCHW input, every axis but the last for any other input of more
    than two (its channel axis is taken to be the last), 0 for 2-D."""
    if data_format == "NCHW" and x.dim() == 4:
        axes = (0, 2, 3)
    elif x.dim() > 2:
        axes = tuple(range(x.dim() - 1))
    else:
        axes = (0,)
    n = math.prod(x.shape[a] for a in axes)
    xf = _acc(x)
    m = xf.sum(dim=axes, keepdim=True) / n
    var = (xf - m).square().sum(dim=axes) / n
    return mean_fp32acc(x, axes), var.to(x.dtype)


@dispatch("batch_norm_infer")
def batch_norm_infer(x, mean, var, weight=None, bias=None, epsilon=1e-5,
                     data_format="NCHW"):
    """``_batch_norm_infer``: ``rsqrt`` of the fp32 variance plus epsilon,
    cast to x's dtype; mean, weight and bias cast to x's dtype, so fp32
    statistics never promote a bf16 stream.  Per-channel shape as the
    reference has it: (1, C, 1, 1) for 4-D NCHW, (1, C) for 2-D, the
    last axis otherwise."""
    if data_format == "NCHW" and x.dim() == 4:
        shape = (1, -1, 1, 1)
    elif x.dim() == 2:
        shape = (1, -1)
    else:
        shape = (1,) * (x.dim() - 1) + (-1,)
    dt = x.dtype
    inv = torch.rsqrt(var.float().reshape(shape) + epsilon).to(dt)
    out = (x - mean.to(dt).reshape(shape)) * inv
    if weight is not None:
        out = out * weight.to(dt).reshape(shape)
    if bias is not None:
        out = out + bias.to(dt).reshape(shape)
    return out


def _bn_train_forward(x, w, b, epsilon, data_format):
    """``_bn_train_fwd``: (y, batch mean, variance, inv), the statistics
    in fp32."""
    axes, shape = _bn_axes_shape(x.dim(), data_format)
    n = math.prod(x.shape[a] for a in axes)
    xf = _acc(x)
    s = xf.sum(dim=axes)
    ss = (xf * xf).sum(dim=axes)
    del xf
    m = s / n
    var = torch.clamp(ss / n - m * m, min=0.0)
    inv = torch.rsqrt(var + epsilon)
    dt = x.dtype
    xhat = (x - m.to(dt).reshape(shape)) * inv.to(dt).reshape(shape)
    y = xhat * w.to(dt).reshape(shape) + b.to(dt).reshape(shape)
    return y, m, var, inv


class _BatchNormTrain(torch.autograd.Function):
    """``_bn_train_fwd`` / ``_bn_train_bwd``: one fp32 pass for Σx and Σx²,
    ``var = max(E[x²] - E[x]², 0)``; x̂ formed in x's dtype and y = x̂·w
    + b in x's dtype.  The backward recomputes x̂ from what the forward
    saved (x, w, mean, inv: saving x̂ would double the activation memory
    batch norm keeps), takes Σg and Σg·x̂ in fp32, forms w·inv in fp32
    and casts it, and returns dγ, dβ in w's dtype.  The batch mean and
    variance (fp32) come out beside y, without gradient.  Under
    ``create_graph=True`` the backward is the VJP of the plain forward
    recomputed under autograd (``registry.recompute_vjp``): the
    reference differentiates its plain forward there, so the second
    derivative is the true one (a train-mode batch norm's dx sums to 0
    per channel)."""

    @staticmethod
    def forward(ctx, x, w, b, epsilon, data_format):
        y, m, var, inv = _bn_train_forward(x, w, b, epsilon, data_format)
        axes, shape = _bn_axes_shape(x.dim(), data_format)
        ctx.save_for_backward(x, w, b, m, inv)
        ctx.cfg = (axes, shape, math.prod(x.shape[a] for a in axes),
                   epsilon, data_format)
        ctx.mark_non_differentiable(m, var)
        return y, m, var

    @staticmethod
    def backward(ctx, gy, _gm, _gv):
        x, w, b, m, inv = ctx.saved_tensors
        axes, shape, n, epsilon, data_format = ctx.cfg
        if torch.is_grad_enabled():     # create_graph: see the docstring
            gs = recompute_vjp(
                lambda x, w, b: _bn_train_forward(x, w, b, epsilon,
                                                  data_format)[0],
                [x, w, b], [gy],
                [i for i in range(3) if ctx.needs_input_grad[i]])
            return (*gs, None, None)
        dt = x.dtype
        xhat = (x - m.to(dt).reshape(shape)) * inv.to(dt).reshape(shape)
        gyf = _acc(gy)
        dbeta = gyf.sum(dim=axes)
        dgamma = (gyf * _acc(xhat)).sum(dim=axes)
        del gyf
        wi = (_acc(w) * inv).to(dt).reshape(shape)
        dx = wi * (gy - (dbeta / n).to(dt).reshape(shape)
                   - xhat * (dgamma / n).to(dt).reshape(shape))
        return dx, dgamma.to(w.dtype), dbeta.to(w.dtype), None, None


@dispatch("batch_norm_train")
def batch_norm_train(x, weight, bias, epsilon=1e-5, data_format="NCHW"):
    """Training-mode batch norm with a weight and a bias (the fused op):
    ``(y, batch mean, biased batch variance)``, the statistics in fp32
    over every axis but the channel one (``_bn_axes_shape``)."""
    return _BatchNormTrain.apply(x, weight, bias, float(epsilon),
                                 data_format)


# -- vision: softmax cross entropy ---------------------------------------------

def _softmax_ce_forward(logits, label, soft_label, ignore_index, axis):
    """``_softmax_ce_fwd``: (the loss [..., 1] fp32, the fp32
    log-softmax)."""
    lsm = torch.log_softmax(_acc(logits), dim=axis)
    if soft_label:
        return -(label * lsm).sum(dim=axis, keepdim=True), lsm
    lab = label.long().unsqueeze(axis)
    nll = -lsm.gather(axis, lab.clamp(0, lsm.shape[axis] - 1))
    if ignore_index is not None:
        nll = torch.where(lab != ignore_index, nll, torch.zeros_like(nll))
    return nll, lsm


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """``_softmax_ce_fwd`` / ``_softmax_ce_bwd``: log-softmax in fp32, the
    loss ``[..., 1]`` in fp32 (rows labelled ``ignore_index`` give 0);
    the backward ``g·(softmax - onehot)·valid`` (soft labels:
    ``g·(softmax·Σlabel - label)``), returned in the logits' dtype.
    Under ``create_graph=True`` the backward is the VJP of the plain
    forward recomputed under autograd (``registry.recompute_vjp``), as
    the reference differentiates its plain forward there."""

    @staticmethod
    def forward(ctx, logits, label, soft_label, ignore_index, axis):
        nll, lsm = _softmax_ce_forward(logits, label, soft_label,
                                       ignore_index, axis)
        ctx.save_for_backward(lsm, label, logits)
        ctx.cfg = (soft_label, ignore_index, axis, logits.dtype)
        return nll

    @staticmethod
    def backward(ctx, g):
        lsm, label, logits = ctx.saved_tensors
        soft_label, ignore_index, axis, dtype = ctx.cfg
        if torch.is_grad_enabled():     # create_graph: see the docstring
            gs = recompute_vjp(
                lambda z, y: _softmax_ce_forward(z, y, soft_label,
                                                 ignore_index, axis)[0],
                [logits, label], [g],
                [i for i in (0, 1) if ctx.needs_input_grad[i]])
            return gs[0], gs[1], None, None, None
        sm = torch.exp(lsm)
        if soft_label:
            gl = g * (sm * label.sum(dim=axis, keepdim=True) - label)
            return gl.to(dtype), None, None, None, None
        lab = label.long().unsqueeze(axis)
        classes = torch.arange(lsm.shape[axis], device=lsm.device)
        classes = classes.reshape([-1 if d == axis % lsm.dim() else 1
                                   for d in range(lsm.dim())])
        gl = g * (sm - (classes == lab).to(sm.dtype))
        if ignore_index is not None:
            gl = gl * (lab != ignore_index).to(sm.dtype)
        return gl.to(dtype), None, None, None, None


@dispatch("softmax_with_cross_entropy")
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1):
    """The per-row loss ``[..., 1]`` (fp32) of ``logits`` against integer
    labels ``[...]`` (or soft labels shaped as the logits)."""
    return _SoftmaxCrossEntropy.apply(
        logits, label, bool(soft_label),
        None if ignore_index is None else int(ignore_index), int(axis))
