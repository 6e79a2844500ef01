"""The diffusion UNet (BASELINE config 5: Stable Diffusion v1.5's UNet
trained on noise prediction).  Counterpart of ``paddle_tpu/models/
unet.py``: ``timestep_embedding``, ``ResnetBlock``, ``CrossAttention``,
``TransformerBlock``, ``Downsample``, ``Upsample`` and
``UNet2DConditionModel`` with the same ops in the same order and the
same parameter names (the skip stack, the ``LayerList`` nesting and the
``Identity`` samplers are kept, so a key such as
``down_blocks.0.1.1.attn2.to_k.weight`` matches letter for letter and
``models.convert.load_numpy_state`` loads a ``paddle_tpu`` state dict
as it is).

Every layer is made on ``device`` (default CUDA, see
``device.resolve_device``; ``"meta"`` builds the shapes alone) and drawn
from one ``torch.Generator`` seeded with ``seed``, in construction
order, with the reference's initializers: convs Kaiming-uniform (bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in))), Linear weights ``[in, out]``
Xavier-uniform and biases 0, GroupNorm and LayerNorm weights 1 and
biases 0.

No Pallas kernel lies on this path in ``paddle_tpu``: GroupNorm is an
XLA fusion, the resize ``jax.image.resize``, the attention an einsum and
a softmax, the convs ``conv_general_dilated``.  So the port is plain
PyTorch over cuDNN and cuBLAS.  The attention stays an einsum, a
softmax and an einsum in the stream's dtype, as the reference computes
it: fused attention (SDPA) is another function with other rounding.

The fp32 stream: under ``CompiledTrainStep(compute_dtype="bfloat16")``
the reference's UNet step computes almost everything in fp32.  Its
inputs are fp32 and are not cast, so ``conv_in`` casts its bf16 weight
up to them and every Linear multiplies fp32 by bf16 in fp32; and even a
bf16 input would turn fp32 at the first GroupNorm, whose fp32 weight
(kept so by the train step's ``"norm"`` rule) promotes its output.  The
port keeps those rounding points: the weights are rounded to bf16, the
convolutions and GEMMs run in fp32 (ROADMAP.md Queue 3).  Casting the
inputs, GroupNorm's output or the convs to bf16 would give another
result than the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..nn import functional as F
from ..nn.initializer import seeded_generator
from ..ops import nn_ops


def timestep_frequencies(dim, max_period=10000.0):
    """The embedding's ``dim // 2`` fp32 frequencies, made with numpy on
    the host exactly as the reference makes them."""
    half = dim // 2
    return np.exp(-math.log(max_period)
                  * np.arange(half, dtype=np.float32) / half)


def timestep_embedding(t, dim, max_period=10000.0, freqs=None):
    """Sinusoidal embedding ``[B] -> [B, dim]`` (the SD convention:
    cosines, then sines).  ``t`` (any numeric dtype) times the fp32
    frequencies (``timestep_frequencies``, or ``freqs`` already on t's
    device) is the reference's fp32 product, bit for bit.  Its cosine and
    sine are taken in fp64 and rounded once to fp32: the correctly
    rounded values, the same on the CPU and the card (XLA's fp32 cos and
    sin on the CPU, and torch's, are each within one ulp of them)."""
    if freqs is None:
        freqs = torch.from_numpy(timestep_frequencies(dim, max_period)).to(
            t.device)
    emb = (t.to(torch.float32)[:, None] * freqs[None, :]).double()
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1).float()


def _linear(fan_in, fan_out, device, generator, bias=True):
    """A ``pnn.Linear`` drawn as ``paddle_tpu``'s default: the weight
    Xavier-uniform, the bias 0."""
    return pnn.Linear(fan_in, fan_out, bias_attr=None if bias else False,
                      device=device, generator=generator)


def _groups(ch, groups=32):
    """The ResnetBlock's group count: ``min(groups, ch)``, lowered until
    it divides ``ch`` (48 channels -> 24 groups)."""
    g = min(groups, ch)
    while ch % g:
        g -= 1
    return g


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, groups=32, device=None,
                 generator=None):
        super().__init__()
        conv = dict(device=device, generator=generator)
        self.norm1 = pnn.GroupNorm(_groups(in_ch, groups), in_ch,
                                   device=device)
        self.conv1 = pnn.Conv2D(in_ch, out_ch, 3, padding=1, **conv)
        self.temb_proj = _linear(temb_ch, out_ch, device, generator)
        self.norm2 = pnn.GroupNorm(_groups(out_ch, groups), out_ch,
                                   device=device)
        self.conv2 = pnn.Conv2D(out_ch, out_ch, 3, padding=1, **conv)
        self.act = pnn.Silu()
        self.skip = (pnn.Conv2D(in_ch, out_ch, 1, **conv)
                     if in_ch != out_ch else None)

    def forward(self, x, temb):
        h = self.conv1(self.act(self.norm1(x)))
        h = h + self.temb_proj(self.act(temb))[:, :, None, None]
        h = self.conv2(self.act(self.norm2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, heads=8, device=None,
                 generator=None):
        super().__init__()
        self.heads = heads
        self.to_q = _linear(query_dim, query_dim, device, generator,
                            bias=False)
        self.to_k = _linear(context_dim, query_dim, device, generator,
                            bias=False)
        self.to_v = _linear(context_dim, query_dim, device, generator,
                            bias=False)
        self.to_out = _linear(query_dim, query_dim, device, generator)

    def forward(self, x, context=None):
        context = x if context is None else context
        B, N, C = x.shape
        H, M = self.heads, context.shape[1]
        q = self.to_q(x).reshape(B, N, H, C // H)
        k = self.to_k(context).reshape(B, M, H, C // H)
        v = self.to_v(context).reshape(B, M, H, C // H)
        logits = nn_ops.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(C // H)
        p = nn_ops.softmax(logits, -1)
        out = nn_ops.einsum("bhnm,bmhd->bnhd", p, v)
        return self.to_out(out.reshape(B, N, C))


class TransformerBlock(nn.Module):
    """self-attention -> cross-attention -> GELU FFN over the
    ``[B, H*W, C]`` tokens, between a GroupNorm + 1x1 conv in and a 1x1
    conv out, with a residual around the whole."""

    def __init__(self, channels, context_dim, heads=8, device=None,
                 generator=None):
        super().__init__()
        conv = dict(device=device, generator=generator)
        self.norm_in = pnn.GroupNorm(min(32, channels), channels,
                                     device=device)
        self.proj_in = pnn.Conv2D(channels, channels, 1, **conv)
        self.norm1 = pnn.LayerNorm(channels, device=device)
        self.attn1 = CrossAttention(channels, channels, heads, **conv)
        self.norm2 = pnn.LayerNorm(channels, device=device)
        self.attn2 = CrossAttention(channels, context_dim, heads, **conv)
        self.norm3 = pnn.LayerNorm(channels, device=device)
        self.ff1 = _linear(channels, channels * 4, device, generator)
        self.ff2 = _linear(channels * 4, channels, device, generator)
        self.act = pnn.GELU()
        self.proj_out = pnn.Conv2D(channels, channels, 1, **conv)

    def forward(self, x, context):
        B, C, H, W = x.shape
        res = x
        h = self.proj_in(self.norm_in(x))
        h = h.reshape(B, C, H * W).transpose(1, 2)
        h = h + self.attn1(self.norm1(h))
        h = h + self.attn2(self.norm2(h), context)
        h = h + self.ff2(self.act(self.ff1(self.norm3(h))))
        h = h.transpose(1, 2).reshape(B, C, H, W)
        return res + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, ch, device=None, generator=None):
        super().__init__()
        self.conv = pnn.Conv2D(ch, ch, 3, stride=2, padding=1, device=device,
                               generator=generator)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x (the reference's index rule: torch's ``nearest-exact``,
    which at integer upsampling equals plain ``nearest``) and a 3x3
    conv."""

    def __init__(self, ch, device=None, generator=None):
        super().__init__()
        self.conv = pnn.Conv2D(ch, ch, 3, padding=1, device=device,
                               generator=generator)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x)


class UNet2DConditionModel(nn.Module):
    """SD v1.5-shaped conditional UNet (ppdiffusers'
    ``UNet2DConditionModel``): ``block_out_channels=(320, 640, 1280,
    1280)`` and ``cross_attention_dim=768`` are v1.5's widths (809.9 M
    parameters); ``tiny()`` is for tests.  ``forward(sample [B, C, H,
    W], timestep [B], encoder_hidden_states [B, M, cross_dim])`` returns
    the predicted noise, shaped as ``sample``."""

    def __init__(self, in_channels=4, out_channels=4,
                 block_out_channels=(320, 640, 1280, 1280),
                 layers_per_block=2, cross_attention_dim=768,
                 attention_head_dim=8, sample_size=64, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = seeded_generator(device, seed)
        kw = dict(device=device, generator=gen)
        self.config_in_channels = in_channels
        self.sample_size = sample_size
        chs = list(block_out_channels)
        temb_ch = chs[0] * 4
        self.time_embed_dim = chs[0]
        self.register_buffer("time_freqs", torch.from_numpy(
            timestep_frequencies(chs[0])).to(device), persistent=False)
        self.time_mlp1 = _linear(chs[0], temb_ch, device, gen)
        self.time_mlp2 = _linear(temb_ch, temb_ch, device, gen)
        self.act = pnn.Silu()
        self.conv_in = pnn.Conv2D(in_channels, chs[0], 3, padding=1, **kw)

        def heads(ch):
            return max(1, ch // (attention_head_dim * 8))

        # down path: stages 0..n-2 have attention; the last is conv-only
        self.down_blocks = pnn.LayerList()
        self.downsamplers = pnn.LayerList()
        skip_chs = [chs[0]]
        ch = chs[0]
        for i, out_ch in enumerate(chs):
            with_attn = i < len(chs) - 1
            stage = pnn.LayerList()
            for _ in range(layers_per_block):
                blk = pnn.LayerList([ResnetBlock(ch, out_ch, temb_ch, **kw)])
                if with_attn:
                    blk.append(TransformerBlock(out_ch, cross_attention_dim,
                                                heads(out_ch), **kw))
                stage.append(blk)
                ch = out_ch
                skip_chs.append(ch)
            self.down_blocks.append(stage)
            if i < len(chs) - 1:
                self.downsamplers.append(Downsample(ch, **kw))
                skip_chs.append(ch)
            else:
                self.downsamplers.append(pnn.Identity())

        self.mid_res1 = ResnetBlock(ch, ch, temb_ch, **kw)
        self.mid_attn = TransformerBlock(ch, cross_attention_dim, heads(ch),
                                         **kw)
        self.mid_res2 = ResnetBlock(ch, ch, temb_ch, **kw)

        # up path mirrors down, each block taking a skip from the stack
        self.up_blocks = pnn.LayerList()
        self.upsamplers = pnn.LayerList()
        for i, out_ch in enumerate(reversed(chs)):
            with_attn = i > 0
            stage = pnn.LayerList()
            for _ in range(layers_per_block + 1):
                skip = skip_chs.pop()
                blk = pnn.LayerList(
                    [ResnetBlock(ch + skip, out_ch, temb_ch, **kw)])
                if with_attn:
                    blk.append(TransformerBlock(out_ch, cross_attention_dim,
                                                heads(out_ch), **kw))
                stage.append(blk)
                ch = out_ch
            self.up_blocks.append(stage)
            if i < len(chs) - 1:
                self.upsamplers.append(Upsample(ch, **kw))
            else:
                self.upsamplers.append(pnn.Identity())

        self.norm_out = pnn.GroupNorm(min(32, ch), ch, device=device)
        self.conv_out = pnn.Conv2D(ch, out_channels, 3, padding=1, **kw)

    @classmethod
    def tiny(cls, device=None, seed=0):
        return cls(in_channels=4, out_channels=4, block_out_channels=(32, 64),
                   layers_per_block=1, cross_attention_dim=32,
                   attention_head_dim=4, sample_size=8, device=device,
                   seed=seed)

    def forward(self, sample, timestep, encoder_hidden_states):
        temb = timestep_embedding(timestep, self.time_embed_dim,
                                  freqs=self.time_freqs)
        temb = self.time_mlp2(self.act(self.time_mlp1(temb)))

        h = self.conv_in(sample)
        skips = [h]
        for stage, down in zip(self.down_blocks, self.downsamplers):
            for blk in stage:
                h = blk[0](h, temb)
                if len(blk) > 1:
                    h = blk[1](h, encoder_hidden_states)
                skips.append(h)
            if not isinstance(down, pnn.Identity):
                h = down(h)
                skips.append(h)

        h = self.mid_res2(self.mid_attn(self.mid_res1(h, temb),
                                        encoder_hidden_states), temb)

        for stage, up in zip(self.up_blocks, self.upsamplers):
            for blk in stage:
                h = blk[0](torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk) > 1:
                    h = blk[1](h, encoder_hidden_states)
            if not isinstance(up, pnn.Identity):
                h = up(h)

        return self.conv_out(self.act(self.norm_out(h)))

    def num_params(self):
        return int(sum(p.numel() for p in self.parameters()))
