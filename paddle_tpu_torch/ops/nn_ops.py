"""Plain PyTorch versions of the ops on the serving and training paths.

Counterparts of ``paddle_tpu/ops/nn_ops.py`` (``_rms_norm_plain``,
``_layer_norm_plain``, ``_rope_plain``, ``_sdpa_plain``, ``dropout_raw``,
``fused_linear_cross_entropy``, ``_softmax_ce_plain``) and
``paddle_tpu/ops/activation.py`` (``_swiglu_plain``, ``gelu``), with the
same dtype rules, so a bf16 stream rounds at the same places in both
packages.  Of these, only attention reaches a kernel here (``sdpa``
routes long causal sequences to ``ops.kernels.long_attention`` and
short ones to ``ops.kernels.short_attention``); the rest is plain
PyTorch in both packages (XLA ops in ``paddle_tpu``).  Every random draw
(dropout) takes an explicit ``torch.Generator`` on the tensor's device.
"""
from __future__ import annotations

import math

import torch


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


def swiglu(x, y=None):
    """``silu(x) * y``; with one argument, its last axis is split in two."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return x * torch.sigmoid(x) * y


def gelu(x):
    """GELU in its exact erf form (``ops.gelu``'s default,
    ``approximate=False``, which BERT uses), in x's dtype."""
    return torch.nn.functional.gelu(x)


def _need_generator(generator, device, what):
    if generator is None:
        raise ValueError(f"{what} draws random numbers: pass an explicit "
                         "torch.Generator on the tensor's device")
    if generator.device.type != device.type:
        raise ValueError(f"{what}: the generator is on "
                         f"{generator.device}, the tensor on {device}")


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

#: where ``sdpa`` sends each region JAX gives to a Pallas kernel that is
#: not ported yet (ROADMAP.md, Queue 2)
_NOT_PORTED = {
    "flash": "the stock Pallas flash-attention path (S % 512 == 0, "
             "D % 128 == 0) is not ported yet: ROADMAP.md Queue 2, "
             "'stock flash attention'",
}


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


def sdpa(q, k, v, mask=None, causal=False, scale=None, impl="auto",
         dropout_p=0.0, generator=None):
    """Scaled dot-product attention on ``[B, S, H, D]`` (the paddle
    flash-attention layout), GQA when k/v have fewer heads, with
    attention dropout at rate ``dropout_p`` (0 outside training) drawn
    from ``generator`` on q's device.

    Routes as ``_sdpa_plain`` does, with "a CUDA tensor" in place of "on
    a TPU": causal S in [1024, 2048] without dropout (S % 256 == 0,
    D % 128 == 0, the same heads for q and k/v, no mask) goes to the
    hand-written ``long_attention`` kernel; Sq == Sk <= 1024 (S % 128 ==
    0, D 64 or 128, no GQA, no mask) to the hand-written
    ``short_attention`` kernel, whose hash dropout takes an int32 seed
    drawn from the generator; on CUDA, the stock-flash region raises
    ``NotImplementedError``; the rest is the einsum path, grouped for
    GQA: scores in q's dtype, then fp32 times the scale, masked, fp32
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
    if route == "long":
        from .kernels.long_attention import long_attention

        out = long_attention(qt, kt, vt, float(scale), bool(causal))
        return out.transpose(1, 2)
    if route == "short":
        from .kernels.short_attention import short_attention

        seed = _seed(generator, q.device) if dropout_p > 0.0 else None
        out = short_attention(qt, kt, vt, seed, float(scale), dropout_p,
                              bool(causal))
        return out.transpose(1, 2)
    if route in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[route])
    grouped = Hkv != H
    if grouped:
        qt = qt.reshape(B, Hkv, H // Hkv, Sq, D)
        logits = torch.einsum("bngqd,bnkd->bngqk", qt, kt)
    else:
        logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt)
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
        out = torch.einsum("bngqk,bnkd->bngqd", probs, vt)
        out = out.reshape(B, H, Sq, D)
    else:
        out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2)


# -- losses -------------------------------------------------------------------

def cross_entropy(logits, labels, ignore_index=-100):
    """Mean cross entropy of ``logits [N, V]`` against ``labels [N]``:
    log-softmax in fp32, rows whose label is ``ignore_index`` give 0 and
    still count in the mean (``F.cross_entropy(reduction='mean')`` with a
    negative ``ignore_index``)."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    lab = labels.clamp(0, logits.shape[-1] - 1)
    nll = -lsm.gather(-1, lab[:, None])[:, 0]
    nll = torch.where(labels != ignore_index, nll, torch.zeros_like(nll))
    return nll.mean()


def _flce_logits(hidden, weight, tied):
    return hidden @ (weight.t() if tied else weight)


class FusedLinearCrossEntropy(torch.autograd.Function):
    """``fused_linear_cross_entropy``'s custom VJP: the backward recomputes
    the logits and forms ``softmax - onehot`` in the hidden dtype, so the
    ``[N, V]`` fp32 log-softmax is never kept for the backward."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, tied, ignore_index):
        lf = _flce_logits(hidden, weight, tied).float()
        mx = lf.amax(dim=-1)
        lse = mx + torch.log(torch.exp(lf - mx[:, None]).sum(dim=-1))
        lab = labels.clamp(0, lf.shape[-1] - 1)
        tgt = lf.gather(-1, lab[:, None])[:, 0]
        nll = torch.where(labels != ignore_index, lse - tgt,
                          torch.zeros_like(lse))
        ctx.save_for_backward(hidden, weight, labels, lse)
        ctx.cfg = (tied, ignore_index)
        return nll.mean()

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, lse = ctx.saved_tensors
        tied, ignore_index = ctx.cfg
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
