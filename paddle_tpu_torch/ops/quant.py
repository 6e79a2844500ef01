"""Int8 quantized serving — weights and KV pages (``PT_QUANT``).

Counterpart of ``paddle_tpu/ops/quant.py``, with the same two
compressions behind one mode knob:

* **Weights**: per-output-channel symmetric int8.  ``quantize_linear``
  packs a ``[..., in, out]`` weight into ``{"qweight": int8, "scale":
  f32 [..., 1, out]}``; :func:`qmatmul` computes ``x @ w`` from it
  through the int8-weight matmul kernel (``ops.kernels.quant_matmul``:
  the CUDA kernel for tensors on the card, its plain version on the
  CPU).  Per-output-channel scales commute with the contraction, so the
  scale is applied once to the f32 product.
* **KV pages**: per-page symmetric int8, one f32 scale per (layer, kv
  head, page).  :func:`kv_write` is scatter-max-then-requantize: grow
  the touched pages' scales to cover the incoming tokens, requantize the
  resident cells by ``s_old / s_new``, then write the new cells.

Every rounding point is JAX's: f32 divisions, ``round`` half to even
(``torch.round`` and ``jnp.round`` agree), the ``where(scale > 0,
scale, 1)`` guard and a clip to +-127, so weights, pages and scales are
bit-identical to ``paddle_tpu``'s.  Unlike the JAX package, whose arrays
are immutable, :func:`kv_write` updates the pool IN PLACE.

The JAX package's fault points (``quant.pack``, ``quant.kv_write``,
``quant.dequant``) are not ported.
"""
from __future__ import annotations

import math
import os
import re

import torch

from .kernels.quant_matmul import quant_matmul

__all__ = [
    "MODES", "QMAX", "quant_mode", "quantize_per_channel", "dequantize",
    "quantize_linear", "is_quantized", "DEFAULT_PATTERNS",
    "quantize_state_dict", "qmatmul", "kv_write", "kv_dequant",
    "kv_pool_bytes_per_page",
]

#: recognized PT_QUANT values
MODES = ("none", "int8")

#: symmetric int8 uses the balanced range so q == -q always round-trips
QMAX = 127.0


def quant_mode(mode=None):
    """Resolve and validate the quantization mode: ``None`` follows
    ``PT_QUANT`` (default ``none``), an explicit argument wins.  Raises
    ``ValueError`` on anything outside :data:`MODES`."""
    if mode is None:
        mode = os.environ.get("PT_QUANT", "none").lower()
    if mode not in MODES:
        raise ValueError(
            f"PT_QUANT={mode!r}: expected one of {'|'.join(MODES)}")
    return mode


# -- weights: per-channel symmetric int8 ---------------------------------------


def quantize_per_channel(w, contract_axis=-2):
    """``(qweight int8, scale f32)`` with one scale per output channel.

    ``contract_axis`` is the axis the matmul reduces over (``-2`` for
    the ``[..., in, out]`` layout, so a stacked ``[L, in, out]`` weight
    gets a ``[L, 1, out]`` scale).  ``scale = amax / 127``; a zero
    channel quantizes to zeros with scale 0."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=contract_axis, keepdim=True)
    scale = amax / QMAX
    q = torch.round(w32 / torch.where(scale > 0, scale, 1.0))
    return q.clamp_(-QMAX, QMAX).to(torch.int8), scale


def dequantize(qweight, scale, dtype=None):
    """Inverse of :func:`quantize_per_channel` (up to rounding)."""
    out = qweight.to(torch.float32) * scale
    return out if dtype is None else out.to(dtype)


def quantize_linear(w):
    """Pack one matmul weight into the ``{"qweight", "scale"}`` dict
    (the ``quant.pack`` fault point: a raise fails the engine's build,
    never a serving step)."""
    from ..testing import faults

    faults.fire("quant.pack", "before")
    qweight, scale = quantize_per_channel(w)
    out = {"qweight": qweight, "scale": scale}
    faults.fire("quant.pack", "after")
    return out


def is_quantized(w):
    """True when ``w`` is a ``{"qweight", "scale"}`` dict."""
    return isinstance(w, dict) and "qweight" in w and "scale" in w


#: param-path patterns quantized by default: the llama/bert projection
#: and MLP matmuls.  Embeddings, norms, biases and the LM head stay in
#: the checkpoint dtype.
DEFAULT_PATTERNS = (
    r"\.(q|k|v|o)_proj\.weight$",
    r"\.(gate|up|down)_proj\.weight$",
    r"\.(query|key|value)\.weight$",
    r"\.attention\.output\.dense\.weight$",
    r"\.(intermediate|output)\.dense\.weight$",
)


def quantize_state_dict(state, patterns=DEFAULT_PATTERNS):
    """Quantize the matching matmul weights of a flat ``{path: tensor}``
    state dict; other entries pass through untouched."""
    out = {}
    for name, w in state.items():
        if (getattr(w, "ndim", 0) >= 2
                and any(re.search(p, name) for p in patterns)):
            out[name] = quantize_linear(w)
        else:
            out[name] = w
    return out


def qmatmul(x, qlin):
    """``x [..., K] @ dequant(qlin)`` -> ``[..., N]`` in x's dtype, through
    the int8-weight matmul kernel (its plain version for CPU tensors)."""
    qweight, scale = qlin["qweight"], qlin["scale"]
    k, n = qweight.shape[-2:]
    lead = x.shape[:-1]
    out = quant_matmul(x.reshape(-1, k).contiguous(), qweight,
                       scale.reshape(n))
    return out.reshape(*lead, n)


# -- KV pages: per-page symmetric int8 with scatter-max requantize ------------


def kv_write(pages, scales, pids, offs, vals, pages_touched=None):
    """Quantize-on-write into int8 KV pages, IN PLACE.

    ``pages``: int8 ``[..., num_pages, page_size, head_dim]``;
    ``scales``: f32 ``[..., num_pages]``; ``pids``/``offs``: integer
    ``[T]`` page id and in-page slot per token; ``vals``: float
    ``[..., T, head_dim]`` with leading dims matching ``pages``.

    1. scatter-max each touched page's scale up to cover its incoming
       tokens (``amax / 127`` per token; duplicate page ids reduce to
       their max, the resident scale included);
    2. requantize the touched pages' resident cells by ``s_old /
       s_new`` (a ratio of 1 where the scale did not grow), read before
       anything is written, so duplicate ids write identical blocks;
    3. write the new cells quantized at the settled scale.

    ``pages_touched``, the distinct ids of ``pids`` when the caller knows
    them, makes step 2 requantize each page once instead of once per
    token (a 512-token span then gathers 33 pages, not 512): the same
    bits, since duplicate ids requantize identical blocks."""
    dev = pages.device
    pids = pids.to(device=dev, dtype=torch.long)
    offs = offs.to(device=dev, dtype=torch.long)
    upids = (pids if pages_touched is None
             else pages_touched.to(device=dev, dtype=torch.long))
    v32 = vals.to(torch.float32)
    s_old = scales[..., upids]
    needed = v32.abs().amax(dim=-1) / QMAX                     # [..., T]
    scales.scatter_reduce_(-1, pids.expand_as(needed), needed,
                           reduce="amax", include_self=True)
    s_new = scales[..., upids]
    live = s_new > 0
    safe = torch.where(live, s_new, 1.0)
    ratio = torch.where(live, s_old / safe, 1.0)
    touched = pages[..., upids, :, :].to(torch.float32)
    requant = torch.round(touched * ratio[..., None, None])
    pages[..., upids, :, :] = requant.clamp_(-QMAX, QMAX).to(torch.int8)
    if pages_touched is not None:               # the settled scale per token
        s_tok = scales[..., pids]
        safe = torch.where(s_tok > 0, s_tok, 1.0)
    q = torch.round(v32 / safe[..., None])
    pages[..., pids, offs, :] = q.clamp_(-QMAX, QMAX).to(torch.int8)
    return pages, scales


def kv_dequant(pages, scales, dtype=None):
    """Dequantize int8 pages ``[..., ps, D]`` with per-page scales
    ``[...]`` broadcast over the trailing (slot, head_dim) axes."""
    out = pages.to(torch.float32) * scales[..., None, None]
    return out if dtype is None else out.to(dtype)


def _nbytes(t):
    return t.numel() * t.element_size()


def kv_pool_bytes_per_page(cache):
    """Bytes one page costs in ``cache``: the k and v pools plus any
    scale rows."""
    per = _nbytes(cache.k_pages) + _nbytes(cache.v_pages)
    if getattr(cache, "k_scales", None) is not None:
        per += _nbytes(cache.k_scales) + _nbytes(cache.v_scales)
    return int(math.ceil(per / cache.num_pages))
