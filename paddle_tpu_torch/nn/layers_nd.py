"""N-d conv and pool layers.  Counterpart of the conv and pool part of
``paddle_tpu/nn/layers_nd.py``: ``Conv3D``, ``Conv1DTranspose``,
``Conv3DTranspose``, ``MaxPool1D`` / ``3D``, ``AvgPool1D`` / ``3D``,
``LPPool1D`` / ``2D``, the adaptive pools, ``MaxUnPool1D`` / ``2D`` /
``3D`` and ``FractionalMaxPool2D`` / ``3D``, thin layers over
``nn.functional``.

The conv layers' weights are the reference's: ``[out, in / groups, *k]``
(``[in, out / groups, *k]`` transposed) drawn Kaiming-uniform with
``fan_in = in * prod(k) / groups``, and a bias from U(-1/sqrt(fan_in),
1/sqrt(fan_in)) unless ``bias_attr=False``, on ``device`` (default
the current place) from ``generator`` (default: the port's generator of
that device).  ``device``, ``dtype`` and ``generator`` are keyword-only.
The pool layers pass on what the reference's pass on: the max
pools ``return_mask`` (not ``ceil_mode``), the average pools
``exclusive`` (not ``ceil_mode``).  ``FractionalMaxPool2D`` / ``3D``
without ``random_u`` draw it from ``generator`` at every call (default:
a CPU generator seeded with 0).

The rest of the reference's module: ``Maxout``, ``Softmax2D``,
``FeatureAlphaDropout``, ``ZeroPad1D`` / ``3D``, ``SpectralNorm`` (the
standalone layer), the loss layers ``HSigmoidLoss``,
``MultiMarginLoss``, ``TripletMarginWithDistanceLoss``, ``RNNTLoss``
and ``AdaptiveLogSoftmaxWithLoss``, and beam search
(``BeamSearchDecoder``, ``dynamic_decode``: a host-driven loop over a
cell, its beams kept in numpy as the reference keeps them).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import functional as F
from .conv import _conv_params
from .initializer import Uniform, seeded_generator
from .layers import Layer


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _ConvNd(Layer):
    def __init__(self, nd, transpose, in_channels, out_channels,
                 kernel_size, stride, padding, output_padding, dilation,
                 groups, weight_attr, bias_attr, device, dtype, generator):
        super().__init__()
        k = _ntuple(kernel_size, nd)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        fan_in = in_channels * math.prod(k) // groups
        shape = ((in_channels, out_channels // groups) if transpose
                 else (out_channels, in_channels // groups)) + k
        bound = 1.0 / math.sqrt(fan_in)
        _conv_params(self, shape, out_channels, fan_in, weight_attr,
                     bias_attr, device, dtype, generator,
                     bias_init=Uniform(-bound, bound))


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(3, False, in_channels, out_channels, kernel_size,
                         stride, padding, 0, dilation, groups, weight_attr,
                         bias_attr, device, dtype, generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, dtype=None, generator=None):
        super().__init__(1, True, in_channels, out_channels, kernel_size,
                         stride, padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, device, dtype, generator)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(3, True, in_channels, out_channels, kernel_size,
                         stride, padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, device, dtype, generator)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._groups, self._dilation)


# -- pooling -----------------------------------------------------------------

def _pool_layer(fn_name, has_exclusive=False):
    class _Pool(Layer):
        def __init__(self, kernel_size=None, stride=None, padding=0,
                     ceil_mode=False, exclusive=True, return_mask=False,
                     norm_type=None, data_format=None, name=None):
            super().__init__()
            self.kernel_size = kernel_size
            self.stride = stride
            self.padding = padding
            self.ceil_mode = ceil_mode
            self.exclusive = exclusive
            self.return_mask = return_mask

        def forward(self, x):
            kw = ({"return_mask": self.return_mask} if "max" in fn_name
                  else {"exclusive": self.exclusive} if has_exclusive
                  else {})
            return getattr(F, fn_name)(x, self.kernel_size, self.stride,
                                       self.padding, **kw)

    _Pool.__name__ = _Pool.__qualname__ = fn_name.title().replace("_", "")
    return _Pool


MaxPool1D = _pool_layer("max_pool1d")
MaxPool3D = _pool_layer("max_pool3d")
AvgPool1D = _pool_layer("avg_pool1d", has_exclusive=True)
AvgPool3D = _pool_layer("avg_pool3d", has_exclusive=True)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.norm_type = norm_type
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return F.lp_pool1d(x, self.norm_type, self.kernel_size, self.stride,
                           self.padding, self.ceil_mode)


class LPPool2D(LPPool1D):
    def forward(self, x):
        return F.lp_pool2d(x, self.norm_type, self.kernel_size, self.stride,
                           self.padding, self.ceil_mode)


def _adaptive_layer(fn_name):
    class _Adaptive(Layer):
        def __init__(self, output_size, return_mask=False,
                     data_format=None, name=None):
            super().__init__()
            self.output_size = output_size
            self.return_mask = return_mask

        def forward(self, x):
            fn = getattr(F, fn_name)
            if "max" in fn_name:
                return fn(x, self.output_size, return_mask=self.return_mask)
            return fn(x, self.output_size)

    _Adaptive.__name__ = _Adaptive.__qualname__ = \
        fn_name.title().replace("_", "")
    return _Adaptive


AdaptiveAvgPool1D = _adaptive_layer("adaptive_avg_pool1d")
AdaptiveAvgPool3D = _adaptive_layer("adaptive_avg_pool3d")
AdaptiveMaxPool1D = _adaptive_layer("adaptive_max_pool1d")
AdaptiveMaxPool2D = _adaptive_layer("adaptive_max_pool2d")
AdaptiveMaxPool3D = _adaptive_layer("adaptive_max_pool3d")


def _unpool_layer(fn_name):
    class _Unpool(Layer):
        def __init__(self, kernel_size, stride=None, padding=0,
                     data_format=None, output_size=None, name=None):
            super().__init__()
            self.kernel_size = kernel_size
            self.stride = stride
            self.padding = padding
            self.output_size = output_size

        def forward(self, x, indices):
            return getattr(F, fn_name)(x, indices, self.kernel_size,
                                       self.stride, self.padding,
                                       output_size=self.output_size)

    _Unpool.__name__ = _Unpool.__qualname__ = \
        fn_name.title().replace("_", "")
    return _Unpool


MaxUnPool1D = _unpool_layer("max_unpool1d")
MaxUnPool2D = _unpool_layer("max_unpool2d")
MaxUnPool3D = _unpool_layer("max_unpool3d")


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None, *, generator=None):
        super().__init__()
        self.output_size = output_size
        self.random_u = random_u
        self.generator = generator or seeded_generator("cpu")

    def forward(self, x):
        return F.fractional_max_pool2d(x, self.output_size,
                                       random_u=self.random_u,
                                       generator=self.generator)


class FractionalMaxPool3D(FractionalMaxPool2D):
    def forward(self, x):
        return F.fractional_max_pool3d(x, self.output_size,
                                       random_u=self.random_u,
                                       generator=self.generator)


# -- misc layers ------------------------------------------------------------------

class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups = groups
        self.axis = axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class Softmax2D(Layer):
    """Softmax over the channel axis of ``[N, C, H, W]`` (axis -3)."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, training=self.training,
                                       generator=self.generator)


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        p = padding if isinstance(padding, (list, tuple)) else [padding] * 2
        self.padding = [int(v) for v in p]

    def forward(self, x):
        return F.pad(x, self.padding)


class ZeroPad3D(ZeroPad1D):
    def __init__(self, padding, data_format="NCDHW", name=None):
        Layer.__init__(self)
        p = padding if isinstance(padding, (list, tuple)) else [padding] * 6
        self.padding = [int(v) for v in p]


class SpectralNorm(Layer):
    """``forward(weight) = weight / sigma``, sigma the top singular value
    of ``weight`` (``dim`` first, the rest flattened) estimated by
    ``power_iters`` power iterations from the buffers ``weight_u`` /
    ``weight_v`` (drawn from ``np.random.RandomState(0)`` as in the
    reference; updated in training mode); sigma is differentiated
    through the weight with u and v held constant."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, *, device=None):
        super().__init__()
        from ..device import resolve_device

        self.dim, self.power_iters, self.eps = dim, power_iters, eps
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        rng = np.random.RandomState(0)
        dev = resolve_device(device)
        self.register_buffer("weight_u", torch.from_numpy(
            rng.randn(h).astype(np.float32)).to(dev))
        self.register_buffer("weight_v", torch.from_numpy(
            rng.randn(w).astype(np.float32)).to(dev))

    def forward(self, weight):
        mat = torch.movedim(weight, self.dim, 0)
        mat = mat.reshape(mat.shape[0], -1)
        with torch.no_grad():
            u, v = self.weight_u, self.weight_v
            for _ in range(self.power_iters):
                v = mat.t() @ u
                v = v / (torch.linalg.vector_norm(v) + self.eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + self.eps)
            if self.training:
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        sigma = (u[None, :] @ mat @ v[:, None]).reshape(())
        return weight / sigma


# -- loss layers ----------------------------------------------------------------------

class HSigmoidLoss(Layer):
    """``F.hsigmoid_loss`` with ``weight [num_classes - 1, feature_size]``
    (XavierUniform) and a bias (zeros; none with ``bias_attr=False``)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr, **kw)
        self.bias = self.create_parameter(
            [num_classes - 1], attr=bias_attr, is_bias=True, **kw)

    def forward(self, input, label, path_table=None, path_code=None):
        b = self.bias
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               None if b is None else b.reshape(-1))


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.p, self.margin = p, margin
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap = margin, swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class RNNTLoss(Layer):
    """``F.rnnt_loss`` with ``blank`` and ``reduction``; its FastEmit
    weight stays the function's default, as in the reference."""

    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           self.blank, reduction=self.reduction)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """The adaptive softmax: a head over the shortlist and one logit per
    tail cluster (``head_weight [shortlist + clusters, in]``), tail i a
    projection ``[in / div_value^(i+1), in]`` and an output ``[cluster
    size, that]`` (``tail_proj_i``, ``tail_emb_i``), all XavierUniform."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.cutoffs = list(cutoffs) + [n_classes]
        self.shortlist = self.cutoffs[0]
        n_clusters = len(self.cutoffs) - 1
        self.head_weight = self.create_parameter(
            [self.shortlist + n_clusters, in_features], **kw)
        self.head_bias = (self.create_parameter(
            [self.shortlist + n_clusters], is_bias=True, **kw)
            if head_bias else None)
        self.tail_weights = []
        for i in range(n_clusters):
            hsz = max(int(in_features / (div_value ** (i + 1))), 1)
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            proj = self.create_parameter([hsz, in_features], **kw)
            emb = self.create_parameter([osz, hsz], **kw)
            setattr(self, f"tail_proj_{i}", proj)
            setattr(self, f"tail_emb_{i}", emb)
            self.tail_weights.append([proj, emb])

    def forward(self, input, label):
        tails = [[getattr(self, f"tail_proj_{i}"),
                  getattr(self, f"tail_emb_{i}")]
                 for i in range(len(self.tail_weights))]
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, tails, self.cutoffs,
            self.head_bias)


# -- decoding ---------------------------------------------------------------------------

class BeamSearchDecoder:
    """Beam decoding over a cell (``cell(inputs, states) -> (output,
    new_states)``); ``embedding_fn`` maps token ids to the cell's
    inputs, ``output_fn`` its output to vocabulary logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _logits(self, out):
        return self.output_fn(out) if self.output_fn is not None else out


def dynamic_decode(decoder, inits=None, max_step_num=32, batch_size=1,
                   **kwargs):
    """Run ``decoder`` until every beam has emitted ``end_token`` or for
    ``max_step_num`` steps: ``(token ids [B, beam, T] int64, scores
    [B, beam] fp32)``.  The beams are chosen on the host in float64, as
    the reference chooses them; the cell runs on its own device."""
    K, B = decoder.beam_size, batch_size
    rep = lambda t: torch.repeat_interleave(  # noqa: E731
        torch.as_tensor(t), K, dim=0)
    if inits is None:
        states = None
    elif isinstance(inits, (tuple, list)):
        states = type(inits)(rep(s) for s in inits)
    else:
        states = rep(inits)
    dev = None
    tokens = np.full((B, K), decoder.start_token, np.int64)
    scores = np.zeros((B, K), np.float64)
    scores[:, 1:] = -1e9
    finished = np.zeros((B, K), bool)
    out_tokens = []
    for _ in range(max_step_num):
        inp = torch.from_numpy(tokens.reshape(-1))
        if dev is None:
            params = [p for p in getattr(decoder.cell, "parameters",
                                         lambda: [])()]
            dev = params[0].device if params else torch.device("cpu")
        inp = inp.to(dev)
        if decoder.embedding_fn is not None:
            inp = decoder.embedding_fn(inp)
        out, states = decoder.cell(inp, states)
        logp = torch.log_softmax(decoder._logits(out).double(), -1)
        logp = logp.detach().cpu().numpy().reshape(B, K, -1)
        V = logp.shape[-1]
        logp = np.where(finished[:, :, None],
                        np.where(np.arange(V)[None, None, :]
                                 == decoder.end_token, 0.0, -1e9), logp)
        flat = (scores[:, :, None] + logp).reshape(B, -1)
        top = np.argsort(-flat, axis=1, kind="stable")[:, :K]
        scores = np.take_along_axis(flat, top, 1)
        beam_idx, tok = top // V, top % V

        def reorder(t):
            d = t.reshape((B, K) + tuple(t.shape[1:]))
            idx = torch.from_numpy(beam_idx).to(d.device).reshape(
                (B, K) + (1,) * (d.dim() - 2)).expand_as(d)
            return torch.gather(d, 1, idx).reshape((B * K,)
                                                   + tuple(t.shape[1:]))

        if isinstance(states, (tuple, list)):
            states = type(states)(reorder(s) for s in states)
        elif states is not None:
            states = reorder(states)
        finished = np.take_along_axis(finished, beam_idx, 1) | (
            tok == decoder.end_token)
        for t_ in out_tokens:
            t_[:] = np.take_along_axis(t_, beam_idx, 1)
        out_tokens.append(tok.copy())
        tokens = tok
        if finished.all():
            break
    ids = np.stack(out_tokens, axis=-1)
    return (torch.from_numpy(ids),
            torch.from_numpy(scores.astype(np.float32)))
