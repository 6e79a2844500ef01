"""Detection ops of the port.  Counterpart of ``paddle_tpu/vision/ops.py``:
``nms``, ``box_coder``, ``prior_box``, ``yolo_box``, ``roi_align``,
``roi_pool``, ``psroi_pool`` and their layers, ``deform_conv2d`` /
``DeformConv2D``, ``matrix_nms``, ``generate_proposals``,
``distribute_fpn_proposals``, ``yolo_loss``, ``read_file`` and
``decode_jpeg``.

No op of the reference's module is a Pallas kernel: each is jnp code or
host numpy.  So they are plain PyTorch here, and every op computes on its
inputs' device:

- ``nms`` keeps both of the reference's results.  Eager, it works in
  float64 and returns a data-dependent count of indices: the IoU matrix
  and its threshold on the device, then the greedy scan as a fixed point
  on the device (:func:`_greedy_keep`).  Inside a CUDA graph capture (the
  port's counterpart of a trace) it takes the fixed-size float32 route,
  :func:`_nms_device`: ``top_k`` indices padded with -1, the lower index
  winning ties, batched over a leading image axis.
- The geometry that the reference builds in Python loops on the host
  (``roi_align``'s sampling grid, ``roi_pool``'s and ``psroi_pool``'s
  bins) is built vectorised in float64 on the device with the same
  operations in the same order, so the float32 coordinates are the
  reference's bit for bit; the reductions are ``index_add`` (atomic on
  CUDA) and masked gathers.
- ``matrix_nms``, ``generate_proposals`` and ``distribute_fpn_proposals``
  are host numpy in the reference (float64, stable argsorts); here the
  same orders and rounding in float64 torch (stable sorts).
- ``decode_jpeg`` decodes on the host with PIL, imported when called.

The gradient of ``roi_align``, ``roi_pool``, ``deform_conv2d`` and
``yolo_loss`` flows to x (and ``deform_conv2d``'s offset, mask and
weight); boxes and targets are constants, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.registry import dispatch
from ..device import resolve_device
from ..nn.initializer import Uniform, seeded_generator


def _as(v, like, dtype=None):
    """``v`` as a tensor on ``like``'s device (``dtype`` if given)."""
    t = torch.as_tensor(v, device=like.device)
    return t if dtype is None else t.to(dtype)


def _div(t, d):
    """``t / d`` for a Python number ``d``, correctly rounded on every
    device: the library's CUDA kernels multiply by ``1 / d`` instead,
    which is an ulp off (and moves a bin edge: 29 / 7 * 7 - 1 ceils to 29
    on the CPU and to 28 that way)."""
    return t / torch.full_like(t, d)


# -- nms --------------------------------------------------------------------

def _iou_matrix(b):
    """IoU of every pair of ``[..., n, 4]`` xyxy boxes (``_iou_matrix``:
    areas of negative extent 0, the union at least 1e-10)."""
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


def _greedy_keep(over):
    """The reference's greedy scan over ``over [n, n]`` (box i, in the
    order processed, suppresses box j), as a fixed point on the device:
    ``keep[j]`` is true when no kept box before j suppresses it.  From
    all-true, each pass settles at least the next box, and the recursion
    has one solution, so the first repeated mask is the greedy one (a
    few passes in practice, one device-to-host flag each)."""
    later = torch.triu(over, diagonal=1)
    keep = torch.ones(over.shape[-1], dtype=torch.bool, device=over.device)
    while True:
        new = ~(later & keep[:, None]).any(0)
        if torch.equal(new, keep):
            return keep
        keep = new


def _nms_single(boxes, iou_threshold, order):
    over = _iou_matrix(boxes)[order][:, order] > iou_threshold
    return order[_greedy_keep(over)]


def _nms_device(boxes, scores, iou_threshold, max_out):
    """The reference's ``_nms_device`` over a leading image axis: boxes
    ``[B, n, 4]`` and scores ``[B, n]`` (float32) to ``[B, max_out]``
    int64 indices padded with -1.  Each of ``max_out`` steps takes every
    image's highest live score (the lower index on ties, as
    ``argmax``), and suppresses the boxes whose IoU with it exceeds the
    threshold, and itself.  No host synchronisation: it can be captured
    in a CUDA graph."""
    B, n = scores.shape
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    neg = torch.full((), float("-inf"), device=scores.device)
    s = scores.float().clone()
    live = torch.ones((B, n), dtype=torch.bool, device=scores.device)
    keep = torch.full((B, max_out), -1, dtype=torch.int64,
                      device=scores.device)
    rows = torch.arange(B, device=scores.device)
    cols = torch.arange(n, device=scores.device)[None, :]
    for i in range(max_out):
        idx = s.argmax(1)
        valid = s[rows, idx] > neg
        keep[:, i] = torch.where(valid, idx, -1)
        ix1 = torch.maximum(x1[rows, idx][:, None], x1)
        iy1 = torch.maximum(y1[rows, idx][:, None], y1)
        ix2 = torch.minimum(x2[rows, idx][:, None], x2)
        iy2 = torch.minimum(y2[rows, idx][:, None], y2)
        inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
        iou = inter / (area[rows, idx][:, None] + area - inter).clamp(
            min=1e-10)
        suppress = ((iou > iou_threshold) | (cols == idx[:, None])) \
            & valid[:, None]
        live = live & ~suppress
        s = torch.where(live, s, neg)
    return keep


def _category_shift(b, category_idxs):
    """Boxes ``[..., n, 4]`` moved apart per category (the
    coordinate-offset trick): category k by ``k * (max(x2, y2) - min(x1,
    y1) + 1)`` over each image's boxes, so boxes of two categories never
    overlap."""
    span = (b[..., 2:].amax((-2, -1)) - b[..., :2].amin((-2, -1))) + 1.0
    return b + (category_idxs.to(b.dtype) * span[..., None])[..., None]


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Kept box indices (int64) of ``boxes [n, 4]``: with ``scores`` in
    descending score order (a stable sort), else in index order; with
    ``category_idxs`` per category (the coordinate-offset trick) and
    then sorted by score; at most ``top_k``.

    Eager: float64 on the inputs' device, a data-dependent count.  Inside
    a CUDA graph capture: ``_nms_device`` in float32, exactly ``top_k``
    indices padded with -1 (``top_k`` is then required), the
    reference's traced route."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        if top_k is None:
            raise ValueError("nms under CUDA graph capture needs top_k "
                             "(a fixed output size); got top_k=None")
        b = boxes.float()
        s = (scores.float() if scores is not None else
             -torch.arange(b.shape[0], dtype=torch.float32,
                           device=b.device))
        if category_idxs is not None:
            b = _category_shift(b, category_idxs)
        return _nms_device(b[None], s[None], float(iou_threshold),
                           int(top_k))[0]
    b = boxes.double()
    n = b.shape[0]
    if category_idxs is not None:
        b = _category_shift(b, category_idxs.long())
    if scores is None:
        keep = _nms_single(b, iou_threshold,
                           torch.arange(n, device=b.device))
    else:
        s = scores.double()
        order = torch.sort(-s, stable=True).indices
        keep = _nms_single(b, iou_threshold, order)
        if category_idxs is not None:
            keep = keep[torch.sort(-s[keep], stable=True).indices]
    return keep if top_k is None else keep[:top_k]


# -- roi align / pool -------------------------------------------------------

def _roi_batch_ids(boxes_num, n_rois, device):
    bn = torch.as_tensor(boxes_num, device=device).long().reshape(-1)
    ids = torch.repeat_interleave(torch.arange(bn.numel(), device=device),
                                  bn)
    if ids.numel() != n_rois:
        raise ValueError(f"boxes_num sums to {ids.numel()}, but there are "
                         f"{n_rois} boxes")
    return ids


def _pair_size(output_size):
    if isinstance(output_size, int):
        return output_size, output_size
    return tuple(int(v) for v in output_size)


def roi_align_grid(boxes, boxes_num, output_size, spatial_scale=1.0,
                   sampling_ratio=-1, aligned=True):
    """``roi_align``'s sampling grid, vectorised: for each ROI, bin and
    sample (in the reference's loop order: ROI, bin row, bin column,
    sample row, sample column) its image, its y and x, its bin and
    ``1 / samples in the bin``.  Computed in float64 with the reference's
    operations in its order (``y1 + by * bin_h + (iy + 0.5) * bin_h /
    gy``), the sample counts per ROI ``ceil(roi / bins)`` (at least 1)
    unless ``sampling_ratio > 0``, and cast to float32 once, so the
    coordinates are the reference's bit for bit."""
    ph, pw = _pair_size(output_size)
    dev = boxes.device
    b = boxes.double() * spatial_scale
    off = 0.5 if aligned else 0.0
    x1, y1 = b[:, 0] - off, b[:, 1] - off
    rw = (b[:, 2] - off) - x1
    rh = (b[:, 3] - off) - y1
    if not aligned:     # legacy: at least 1 pixel
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    bin_h, bin_w = _div(rh, ph), _div(rw, pw)
    if sampling_ratio > 0:
        gy = torch.full_like(rh, sampling_ratio, dtype=torch.int64)
        gx = gy
    else:
        gy = torch.ceil(bin_h).clamp(min=1).long()
        gx = torch.ceil(bin_w).clamp(min=1).long()
    counts = ph * pw * gy * gx
    total = int(counts.sum())
    r = torch.repeat_interleave(torch.arange(b.shape[0], device=dev),
                                counts, output_size=total)
    local = torch.arange(total, device=dev) - (torch.cumsum(counts, 0)
                                               - counts)[r]
    gxr, gyr = gx[r], gy[r]
    ix = local % gxr
    t = local // gxr
    iy = t % gyr
    t = t // gyr
    bx, by = t % pw, t // pw
    yy = y1[r] + by * bin_h[r] + (iy.double() + 0.5) * bin_h[r] / gyr
    xx = x1[r] + bx * bin_w[r] + (ix.double() + 0.5) * bin_w[r] / gxr
    bin_id = (r * ph + by) * pw + bx
    inv_cnt = 1.0 / (gyr * gxr).double()
    batch = _roi_batch_ids(boxes_num, b.shape[0], dev)[r]
    return (batch, yy.float(), xx.float(), bin_id, inv_cnt.float(),
            b.shape[0] * ph * pw)


@dispatch("roi_align")
def _roi_align(x, sb, sy, sx, bin_id, inv_cnt, n_bins, ph, pw):
    """The reference's ``roi_align`` body: a bilinear sample at each grid
    point, zero outside (-1, H) x (-1, W), coordinates clamped into the
    image, times ``1 / samples``, summed per bin."""
    N, C, H, W = x.shape
    valid = (sy > -1.0) & (sy < H) & (sx > -1.0) & (sx < W)
    yc = sy.clamp(0.0, H - 1)
    xc = sx.clamp(0.0, W - 1)
    y0 = torch.floor(yc).long()
    x0 = torch.floor(xc).long()
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    ly = yc - y0
    lx = xc - x0
    w00 = (1 - ly) * (1 - lx)
    w01 = (1 - ly) * lx
    w10 = ly * (1 - lx)
    w11 = ly * lx
    xh = x.permute(0, 2, 3, 1).contiguous()          # rows of C values
    g = (xh[sb, y0, x0] * w00[:, None] + xh[sb, y0, x1] * w01[:, None]
         + xh[sb, y1, x0] * w10[:, None] + xh[sb, y1, x1] * w11[:, None])
    g = g * (valid.to(g.dtype) * inv_cnt)[:, None]
    pooled = g.new_zeros((n_bins, C)).index_add(0, bin_id, g)
    return pooled.reshape(-1, ph, pw, C).permute(0, 3, 1, 2)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """Mask R-CNN RoIAlign with Detectron2's ``aligned`` half-pixel shift
    (reference vision/ops.py:1707): ``[R, C, ph, pw]``, differentiable in
    x.  The grid is :func:`roi_align_grid`'s."""
    ph, pw = _pair_size(output_size)
    sb, sy, sx, bin_id, inv_cnt, n_bins = roi_align_grid(
        boxes, boxes_num, (ph, pw), spatial_scale, sampling_ratio, aligned)
    return _roi_align(x, sb, sy, sx, bin_id, inv_cnt, n_bins, ph, pw)


def _bin_edges(start, size, n, limit):
    """Per-ROI bin edges ``[floor(start + i * size), ceil(start + (i + 1) *
    size))`` for i < n, each clipped to [0, limit] (float64 in, int64
    out)."""
    i = torch.arange(n, device=start.device, dtype=torch.float64)
    lo = torch.floor(start[:, None] + i * size[:, None])
    hi = torch.ceil(start[:, None] + (i + 1) * size[:, None])
    return lo.clamp(0, limit).long(), hi.clamp(0, limit).long()


def _region_index(lo, hi, size):
    """Indices ``[R, n, span]`` of each bin's ``[lo, hi)``, ``span`` the
    longest bin; past a bin's end its last index repeats; an empty bin
    reads index 0 (masked by the caller)."""
    span = max(int((hi - lo).max()), 1)
    idx = lo[..., None] + torch.arange(span, device=lo.device)
    return torch.minimum(idx, hi[..., None] - 1).clamp(0, size - 1), \
        idx < hi[..., None]


@dispatch("roi_pool")
def _roi_pool(x, sb, ys, ye, xs, xe):
    N, C, H, W = x.shape
    yi, _ = _region_index(ys, ye, H)                  # [R, ph, sh]
    xi, _ = _region_index(xs, xe, W)                  # [R, pw, sw]
    xh = x.permute(0, 2, 3, 1)
    g = xh[sb[:, None, None, None, None], yi[:, :, None, :, None],
           xi[:, None, :, None, :]]                   # [R, ph, pw, sh, sw, C]
    pooled = g.amax((3, 4))
    empty = ((ye <= ys)[:, :, None] | (xe <= xs)[:, None, :])[..., None]
    pooled = torch.where(empty | ~torch.isfinite(pooled),
                         torch.zeros((), dtype=pooled.dtype,
                                     device=pooled.device), pooled)
    return pooled.permute(0, 3, 1, 2)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Fast R-CNN RoI max pooling (reference vision/ops.py:1574): each
    box rounded to whole pixels (half to even) after scaling, bin (i, j)
    the max over ``[floor(y1 + i * h / ph), ceil(y1 + (i + 1) * h / ph))``
    by the same in x, clipped to the image; an empty bin is 0."""
    ph, pw = _pair_size(output_size)
    H, W = x.shape[2:]
    b = torch.round(boxes.double() * spatial_scale)
    x1, y1, x2, y2 = b.unbind(-1)
    rh = (y2 - y1 + 1).clamp(min=1)
    rw = (x2 - x1 + 1).clamp(min=1)
    ys, ye = _bin_edges(y1, _div(rh, ph), ph, H)
    xs, xe = _bin_edges(x1, _div(rw, pw), pw, W)
    sb = _roi_batch_ids(boxes_num, b.shape[0], x.device)
    return _roi_pool(x, sb, ys, ye, xs, xe)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Position-sensitive RoI average pooling (R-FCN; reference
    vision/ops.py:1443): C must equal out_channels * ph * pw; bin (i, j)
    of output channel c is the mean of input channel ``c * ph * pw + i *
    pw + j`` over ``[floor(y1 + i * h / ph), ceil(y1 + (i + 1) * h /
    ph))`` (by the same in x, clipped; h at least 0.1), boxes rounded half
    to even after scaling; an empty bin is 0.  Computed without a
    gradient, as the reference's host loop has none."""
    ph, pw = _pair_size(output_size)
    N, C, H, W = x.shape
    if C % (ph * pw) != 0:
        raise ValueError(f"input channels {C} must be divisible by pooled "
                         f"size {ph}x{pw}")
    out_ch = C // (ph * pw)
    with torch.no_grad():
        b = torch.round(boxes.double() * spatial_scale)
        x1, y1, x2, y2 = b.unbind(-1)
        rh = (y2 - y1).clamp(min=0.1)
        rw = (x2 - x1).clamp(min=0.1)
        ys, ye = _bin_edges(y1, _div(rh, ph), ph, H)
        xs, xe = _bin_edges(x1, _div(rw, pw), pw, W)
        yi, ym = _region_index(ys, ye, H)             # [R, ph, sh]
        xi, xm = _region_index(xs, xe, W)
        sb = _roi_batch_ids(boxes_num, b.shape[0], x.device)
        ch = (torch.arange(out_ch, device=x.device) * ph * pw
              + (torch.arange(ph, device=x.device)[:, None] * pw
                 + torch.arange(pw, device=x.device)[None, :])[..., None])
        xh = x.permute(0, 2, 3, 1)
        g = xh[sb[:, None, None, None, None, None],
               yi[:, :, None, :, None, None], xi[:, None, :, None, :, None],
               ch[None, :, :, None, None, :]]         # [R,ph,pw,sh,sw,oc]
        m = (ym[:, :, None, :, None] & xm[:, None, :, None, :])[..., None]
        s = torch.where(m, g, 0).sum((3, 4))
        cnt = ((ye - ys)[:, :, None] * (xe - xs)[:, None, :])[..., None]
        out = torch.where(cnt > 0, s / cnt.clamp(min=1).to(s.dtype), 0)
        return out.permute(0, 3, 1, 2).float()


# -- box coder --------------------------------------------------------------

@dispatch("box_encode")
def _box_encode(p, v, t, norm):
    pw = p[:, 2] - p[:, 0] + norm
    ph_ = p[:, 3] - p[:, 1] + norm
    px = p[:, 0] + pw * 0.5
    py = p[:, 1] + ph_ * 0.5
    tw = t[:, None, 2] - t[:, None, 0] + norm
    th = t[:, None, 3] - t[:, None, 1] + norm
    tx = t[:, None, 0] + tw * 0.5
    ty = t[:, None, 1] + th * 0.5
    v = (v.reshape(-1, 4) if v.dim() == 1 else v).expand(p.shape)
    ox = (tx - px[None, :]) / pw[None, :] / v[None, :, 0]
    oy = (ty - py[None, :]) / ph_[None, :] / v[None, :, 1]
    ow = torch.log(torch.abs(tw / pw[None, :])) / v[None, :, 2]
    oh = torch.log(torch.abs(th / ph_[None, :])) / v[None, :, 3]
    return torch.stack([ox, oy, ow, oh], dim=-1)


@dispatch("box_decode")
def _box_decode(p, v, t, norm, axis):
    if p.dim() == 2:
        p = p.unsqueeze(axis)              # [1, M, 4] or [N, 1, 4]
    vv = v
    if vv.dim() == 1:
        vv = vv.expand(p.shape)
    elif vv.dim() == 2:
        vv = vv.unsqueeze(axis)
        if p.shape[0] == 1:
            vv = vv.expand((t.shape[0],) + tuple(p.shape[1:]))
    pw = p[..., 2] - p[..., 0] + norm
    ph_ = p[..., 3] - p[..., 1] + norm
    px = p[..., 0] + pw * 0.5
    py = p[..., 1] + ph_ * 0.5
    ox = vv[..., 0] * t[..., 0] * pw + px
    oy = vv[..., 1] * t[..., 1] * ph_ + py
    ow = torch.exp(vv[..., 2] * t[..., 2]) * pw
    oh = torch.exp(vv[..., 3] * t[..., 3]) * ph_
    return torch.stack([ox - ow * 0.5, oy - oh * 0.5, ox + ow * 0.5 - norm,
                        oy + oh * 0.5 - norm], dim=-1)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0):
    """Encode or decode center-size box deltas (reference
    vision/ops.py:584); ``prior_box_var`` a tensor or a list of 4."""
    norm = 0.0 if box_normalized else 1.0
    var = prior_box_var
    if isinstance(var, (list, tuple)):
        var = _as(np.array(var, np.float32), prior_box)
    if code_type == "encode_center_size":
        return _box_encode(prior_box, var, target_box, norm)
    if code_type == "decode_center_size":
        return _box_decode(prior_box, var, target_box, norm, int(axis))
    raise ValueError(f"unknown code_type {code_type!r}")


# -- deformable convolution -------------------------------------------------

def _bilinear_sample(x, fy, fx):
    """x ``[B, C, H, W]``; fy / fx ``[B, L]`` float coordinates -> ``[B, C,
    L]`` bilinear samples.  Each of the four corners reads zero when it
    falls outside the image (``_bilinear_sample``'s per-corner zero
    padding)."""
    B, C, H, W = x.shape
    flat = x.reshape(B, C, H * W)

    def gather(iy, ix):
        inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        at = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        vals = flat.gather(2, at[:, None, :].expand(B, C, at.shape[1]))
        return vals * inb[:, None].to(x.dtype)

    y0 = torch.floor(fy).long()
    x0 = torch.floor(fx).long()
    wy = (fy - y0)[:, None].to(x.dtype)
    wx = (fx - x0)[:, None].to(x.dtype)
    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


@dispatch("deform_conv2d")
def _deform_conv2d(x, offset, weight, mask, sh, sw, ph, pw, dh, dw, dg,
                   groups):
    B, Cin, H, W = x.shape
    Cout, Cin_g, Kh, Kw = weight.shape
    Ho = (H + 2 * ph - (dh * (Kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (Kw - 1) + 1)) // sw + 1
    K = Kh * Kw
    dev = x.device
    off = offset.reshape(B, dg, K, 2, Ho, Wo)
    base_y = (torch.arange(Ho, device=dev) * sh - ph)[None, :, None]
    base_x = (torch.arange(Wo, device=dev) * sw - pw)[None, None, :]
    ky = (torch.arange(Kh, device=dev) * dh)[:, None].expand(Kh, Kw) \
        .reshape(K)
    kx = (torch.arange(Kw, device=dev) * dw)[None, :].expand(Kh, Kw) \
        .reshape(K)
    cg = Cin // dg
    samples = []
    for g in range(dg):
        fy = base_y + ky[:, None, None] + off[:, g, :, 0]   # [B, K, Ho, Wo]
        fx = base_x + kx[:, None, None] + off[:, g, :, 1]
        s = _bilinear_sample(x[:, g * cg:(g + 1) * cg], fy.reshape(B, -1),
                             fx.reshape(B, -1)).reshape(B, cg, K, Ho, Wo)
        if mask is not None:
            s = s * mask.reshape(B, dg, K, Ho, Wo)[:, g][:, None]
        samples.append(s)
    sampled = torch.cat(samples, 1) if dg > 1 else samples[0]
    # one product: [groups, Cout/g, Cin/g * K] x [B, groups, Cin/g * K, L]
    cols = sampled.reshape(B, groups, Cin_g * K, Ho * Wo)
    w = weight.reshape(groups, Cout // groups, Cin_g * K)
    dt = torch.promote_types(w.dtype, cols.dtype)
    return torch.matmul(w.to(dt), cols.to(dt)).reshape(B, Cout, Ho, Wo)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 (``mask`` None) and v2 (reference
    vision/ops.py deform_conv2d): x ``[B, Cin, H, W]``, offset ``[B, 2 *
    dg * Kh * Kw, Ho, Wo]`` as (dy, dx) pairs per tap, mask ``[B, dg * Kh
    * Kw, Ho, Wo]``.  Each tap is a bilinear gather at its offset
    position (per-corner zero padding); the taps stack into ``[B, Cin *
    K, Ho * Wo]`` and one matmul against the weight contracts them."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    dh, dw = (dilation, dilation) if isinstance(dilation, int) \
        else dilation
    out = _deform_conv2d(x, offset, weight, mask, int(sh), int(sw),
                         int(ph), int(pw), int(dh), int(dw),
                         int(deformable_groups), int(groups))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


class DeformConv2D(nn.Module):
    """Layer form of ``deform_conv2d`` (reference vision/ops.py
    DeformConv2D): weight ``[out, in / groups, kh, kw]`` and bias, both
    from U(-1/sqrt(in * kh * kw), 1/sqrt(in * kh * kw)), on ``device``
    (default CUDA) from ``generator`` (default: seeded with 0); the
    caller passes offset (and mask for v2) to ``forward``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        kh, kw = (kernel_size, kernel_size) \
            if isinstance(kernel_size, int) else kernel_size
        self._cfg = (stride, padding, dilation, deformable_groups, groups)
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kh, kw, device=device,
            dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device,
                                             dtype=dtype))
        generator = generator or seeded_generator(device)
        Uniform(-bound, bound)(self.weight, generator)
        Uniform(-bound, bound)(self.bias, generator)

    def forward(self, x, offset, mask=None):
        stride, padding, dilation, dg, groups = self._cfg
        return deform_conv2d(x, offset, self.weight, self.bias,
                             stride=stride, padding=padding,
                             dilation=dilation, deformable_groups=dg,
                             groups=groups, mask=mask)


# -- YOLO -------------------------------------------------------------------

def _sig(v):
    return 1.0 / (1.0 + torch.exp(-v))


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """YOLOv3 head decode (reference vision/ops.py:277): ``b = (cell +
    sigmoid(t) * scale + bias) * img / grid``, sizes ``exp(t) * anchor *
    img / input``, boxes and scores zeroed under ``conf_thresh``; boxes
    ``[N, A * H * W, 4]`` and scores ``[N, A * H * W, class_num]``,
    anchor-major over the grid cells.  ``img_size [N, 2]`` (h, w) stays
    on its device."""
    imgs = torch.as_tensor(img_size, device=x.device).to(torch.int32)
    an = np.asarray(anchors, np.int32).reshape(-1, 2)
    an_num = an.shape[0]
    N, C, H, W = x.shape
    in_h, in_w = downsample_ratio * H, downsample_ratio * W
    scale, bias = float(scale_x_y), -0.5 * (float(scale_x_y) - 1.0)
    if iou_aware:
        iou_logits = x[:, :an_num].reshape(N, an_num, H, W)
        body = x[:, an_num:].reshape(N, an_num, 5 + class_num, H, W)
    else:
        body = x.reshape(N, an_num, 5 + class_num, H, W)
    cx = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, None, :]
    cy = torch.arange(H, dtype=x.dtype, device=x.device)[None, None, :, None]
    img_w = imgs[:, 1].to(x.dtype)[:, None, None, None]
    img_h = imgs[:, 0].to(x.dtype)[:, None, None, None]
    aw = _as(an[:, 0], x, x.dtype)[None, :, None, None]
    ah = _as(an[:, 1], x, x.dtype)[None, :, None, None]
    bx = _div((cx + _sig(body[:, :, 0]) * scale + bias) * img_w, W)
    by = _div((cy + _sig(body[:, :, 1]) * scale + bias) * img_h, H)
    bw = _div(torch.exp(body[:, :, 2]) * aw * img_w, in_w)
    bh = _div(torch.exp(body[:, :, 3]) * ah * img_h, in_h)
    conf = _sig(body[:, :, 4])
    if iou_aware:
        iou = _sig(iou_logits)
        conf = conf ** (1.0 - iou_aware_factor) * iou ** iou_aware_factor
    keep = (conf >= conf_thresh).to(x.dtype)
    x1, y1 = bx - bw / 2, by - bh / 2
    x2, y2 = bx + bw / 2, by + bh / 2
    if clip_bbox:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=2) * keep[:, :, None]
    scores = conf[:, :, None] * _sig(body[:, :, 5:])
    scores = scores * keep[:, :, None]
    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(N, an_num * H * W, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(N, an_num * H * W,
                                                    class_num)
    return boxes, scores


def _bce(logit, label):
    return torch.relu(logit) - logit * label + \
        torch.log1p(torch.exp(-torch.abs(logit)))


def _iou_xywh(x1, y1, w1, h1, x2, y2, w2, h2):
    ow = torch.minimum(x1 + w1 / 2, x2 + w2 / 2) - \
        torch.maximum(x1 - w1 / 2, x2 - w2 / 2)
    oh = torch.minimum(y1 + h1 / 2, y2 + h2 / 2) - \
        torch.maximum(y1 - h1 / 2, y2 - h2 / 2)
    inter = torch.where((ow < 0) | (oh < 0), 0.0, ow * oh)
    return inter / (w1 * h1 + w2 * h2 - inter)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, scale_x_y=1.0):
    """YOLOv3 training loss (reference vision/ops.py:69): location BCE +
    L1 at the matched cells, class BCE, objectness BCE with the ignore
    region masked; ``[N]``, differentiable in x.  ``gt_box [N, B, 4]``
    (relative xywh), ``gt_label [N, B]``, ``gt_score [N, B]`` (default
    1)."""
    dev = x.device
    gtb = torch.as_tensor(gt_box, device=dev).float()
    gtl = torch.as_tensor(gt_label, device=dev).long()
    gts = (torch.as_tensor(gt_score, device=dev).float()
           if gt_score is not None else torch.ones(gtl.shape, device=dev))
    an = np.asarray(anchors, np.float64).reshape(-1, 2)
    mask = list(anchor_mask)
    mask_num = len(mask)
    N, C, H, W = x.shape
    input_size = downsample_ratio * H
    scale, bias = float(scale_x_y), -0.5 * (float(scale_x_y) - 1.0)
    body = x.reshape(N, mask_num, 5 + class_num, H, W).float()
    if use_label_smooth:
        sw = min(1.0 / class_num, 1.0 / 40)
        label_pos, label_neg = 1.0 - sw, sw
    else:
        label_pos, label_neg = 1.0, 0.0
    valid = (gtb[:, :, 2] > 1e-6) & (gtb[:, :, 3] > 1e-6)          # [N, B]

    # predicted boxes (relative units) for the ignore mask
    cx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None]
    cy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :,
                                                          None]
    anm = _as(np.asarray([an[m] for m in mask], np.float32), x)
    px = _div(cx + _sig(body[:, :, 0]) * scale + bias, W)
    py = _div(cy + _sig(body[:, :, 1]) * scale + bias, H)
    pw = _div(torch.exp(body[:, :, 2]) * anm[None, :, 0, None, None],
              input_size)
    phh = _div(torch.exp(body[:, :, 3]) * anm[None, :, 1, None, None],
               input_size)
    g = gtb[:, None, None, None, :]
    ious = _iou_xywh(px[..., None], py[..., None], pw[..., None],
                     phh[..., None], g[..., 0], g[..., 1], g[..., 2],
                     g[..., 3])
    ious = torch.where(valid[:, None, None, None, :], ious, 0.0)
    ignore = ious.amax(-1) > ignore_thresh                          # [N,m,H,W]

    # per-gt best anchor over all anchors (shape-only IoU)
    an_w = _div(_as(an[:, 0], x, torch.float32), input_size)
    an_h = _div(_as(an[:, 1], x, torch.float32), input_size)
    zero = torch.zeros((), device=dev)
    shape_iou = _iou_xywh(zero, zero, gtb[:, :, 2, None], gtb[:, :, 3, None],
                          zero, zero, an_w[None, None, :],
                          an_h[None, None, :])                      # [N,B,A]
    best_n = shape_iou.argmax(-1)
    mask_arr = np.full(an.shape[0], -1, np.int64)
    for mi, a in enumerate(mask):
        mask_arr[a] = mi
    gt_mask_idx = _as(mask_arr, x)[best_n]
    matched = valid & (gt_mask_idx >= 0)
    gi = (gtb[:, :, 0] * W).to(torch.int32).clamp(0, W - 1).long()
    gj = (gtb[:, :, 1] * H).to(torch.int32).clamp(0, H - 1).long()
    nidx = torch.arange(N, device=dev)[:, None]
    mi_ = gt_mask_idx.clamp(min=0)
    sel = body[nidx, mi_, :, gj, gi]                                # [N,B,5+c]
    tx = gtb[:, :, 0] * W - gi
    ty = gtb[:, :, 1] * H - gj
    anm_all = torch.stack([an_w, an_h], -1) * input_size
    tw = torch.log(torch.clamp(gtb[:, :, 2] * input_size
                               / anm_all[best_n, 0], min=1e-9))
    th = torch.log(torch.clamp(gtb[:, :, 3] * input_size
                               / anm_all[best_n, 1], min=1e-9))
    loc_scale = (2.0 - gtb[:, :, 2] * gtb[:, :, 3]) * gts
    mfl = matched.float()
    loc_loss = (_bce(sel[:, :, 0], tx) + _bce(sel[:, :, 1], ty)
                + torch.abs(sel[:, :, 2] - tw)
                + torch.abs(sel[:, :, 3] - th)) * loc_scale * mfl
    onehot = (gtl[..., None] == torch.arange(class_num, device=dev)).float()
    target = onehot * label_pos + (1 - onehot) * label_neg
    cls_loss = _bce(sel[:, :, 5:], target).sum(-1) * gts * mfl

    # objectness target: the score at matched cells, -1 in the ignore
    # zone; unmatched rows write a dropped column past the end
    obj = torch.where(ignore, -1.0, 0.0).reshape(N, -1)
    cells = obj.shape[1]
    pos = (mi_ * H + gj) * W + gi
    pos = torch.where(matched, pos, cells)
    obj = torch.cat([obj, obj.new_zeros((N, 1))], 1).scatter(1, pos, gts)
    obj = obj[:, :cells].reshape(N, mask_num, H, W)
    logit = body[:, :, 4]
    obj_loss = torch.where(obj > 1e-5, _bce(logit, 1.0) * obj,
                           torch.where(obj > -0.5, _bce(logit, 0.0), 0.0))
    return loc_loss.sum(1) + cls_loss.sum(1) + obj_loss.sum((1, 2, 3))


def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False):
    """SSD prior boxes (reference vision/ops.py:438): (boxes ``[H, W,
    priors, 4]``, variances of the same shape), from the static shapes
    of ``input`` and ``image`` alone, on input's device."""
    fH, fW = tuple(input.shape)[2:]
    iH, iW = tuple(image.shape)[2:]
    min_sizes = [float(m) for m in np.atleast_1d(min_sizes)]
    max_sizes = [] if max_sizes is None else \
        [float(m) for m in np.atleast_1d(max_sizes)]
    ars = [1.0]     # ExpandAspectRatios: 1.0 first, then unseen (+ flips)
    for ar in np.atleast_1d(aspect_ratios):
        ar = float(ar)
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    step_w = float(steps[0]) or iW / fW
    step_h = float(steps[1]) or iH / fH
    num_priors = len(ars) * len(min_sizes) + len(max_sizes)
    out = np.zeros((fH, fW, num_priors, 4), np.float32)
    cx = ((np.arange(fW) + offset) * step_w)[None, :]
    cy = ((np.arange(fH) + offset) * step_h)[:, None]

    def put(k, bw, bh):
        out[:, :, k, 0] = (cx - bw) / iW
        out[:, :, k, 1] = (cy - bh) / iH
        out[:, :, k, 2] = (cx + bw) / iW
        out[:, :, k, 3] = (cy + bh) / iH

    k = 0
    for s, ms in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            put(k, ms / 2.0, ms / 2.0)
            k += 1
            if max_sizes:
                sz = math.sqrt(ms * max_sizes[s]) / 2.0
                put(k, sz, sz)
                k += 1
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                put(k, ms * math.sqrt(ar) / 2.0, ms / math.sqrt(ar) / 2.0)
                k += 1
        else:
            for ar in ars:
                put(k, ms * math.sqrt(ar) / 2.0, ms / math.sqrt(ar) / 2.0)
                k += 1
            if max_sizes:
                sz = math.sqrt(ms * max_sizes[s]) / 2.0
                put(k, sz, sz)
                k += 1
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), out.shape).copy()
    return _as(out, input), _as(var, input)


# -- matrix nms, proposals, FPN levels ---------------------------------------

def _box_area(b, normalized):
    off = 0.0 if normalized else 1.0
    return (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)


def _pair_iou(a, b, normalized):
    """IoU between each row of ``a [..., n, 4]`` and ``b [..., m, 4]``
    (``_pair_iou``: +1 extents unless normalized, 1e-12 in the union)."""
    off = 0.0 if normalized else 1.0
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x2 - x1 + off).clamp(min=0) * (y2 - y1 + off).clamp(min=0)
    return inter / (_box_area(a, normalized)[..., :, None]
                    + _box_area(b, normalized)[..., None, :] - inter + 1e-12)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True):
    """SOLOv2 Matrix NMS (reference vision/ops.py:2245): each class's
    boxes above ``score_threshold``, in stable descending score order (at
    most ``nms_top_k``), have their scores decayed by the minimum over
    higher-ranked boxes of ``exp((max_iou^2 - iou^2) * sigma)`` or ``(1 -
    iou) / (1 - max_iou)``; those above ``post_threshold`` are the rows
    ``[class, score, x1, y1, x2, y2]`` (float32), sorted by score
    (stable, class order first) and cut at ``keep_top_k`` per image.
    float64 on the inputs' device, all classes of an image at once (each
    class's list padded at its end, which changes no earlier entry)."""
    bb = bboxes.double()                    # [N, M, 4]
    sc = scores.double()                    # [N, C, M]
    N, C, M = sc.shape
    dev = sc.device
    classes = torch.tensor([c for c in range(C) if c != background_label],
                           device=dev)
    outs, idxs, rois_num = [], [], []
    for n in range(N):
        s = sc[n, classes]                  # [C', M]
        passing = s > score_threshold
        k = int(passing.sum(1).max()) if classes.numel() else 0
        if nms_top_k > -1:
            k = min(k, nms_top_k)
        if k == 0:
            outs.append(torch.zeros((0, 6), device=dev))
            idxs.append(torch.zeros((0,), dtype=torch.int64, device=dev))
            rois_num.append(0)
            continue
        order = torch.sort(-torch.where(passing, s, float("-inf")), dim=1,
                           stable=True).indices[:, :k]
        valid = passing.gather(1, order)
        sp = s.gather(1, order)
        boxes = bb[n][order]                # [C', k, 4]
        iou = torch.tril(_pair_iou(boxes, boxes, normalized), -1)
        iou_max = torch.cat([torch.zeros_like(iou[:, :1, 0]),
                             iou[:, 1:].amax(2)], 1)
        if use_gaussian:
            decay = torch.exp((iou_max[:, None, :] ** 2 - iou ** 2)
                              * gaussian_sigma)
        else:
            decay = (1.0 - iou) / (1.0 - iou_max[:, None, :] + 1e-12)
        rank = torch.arange(k, device=dev)
        min_decay = torch.where(rank[:, None] > rank[None, :], decay,
                                1.0).amin(2)
        min_decay[:, 0] = 1.0
        ds = min_decay * sp
        keep = valid & (ds > post_threshold)
        rows = torch.cat([classes[:, None].expand(-1, k)[..., None].double(),
                          ds[..., None], boxes], -1)[keep].float()
        idx = n * M + order[keep]
        pick = torch.sort(-rows[:, 1], stable=True).indices
        if keep_top_k > -1:
            pick = pick[:keep_top_k]
        outs.append(rows[pick])
        idxs.append(idx[pick])
        rois_num.append(int(pick.numel()))
    out = torch.cat(outs, 0) if outs else torch.zeros((0, 6), device=dev)
    ret = [out]
    if return_index:
        ret.append(torch.cat(idxs, 0)[:, None])
    if return_rois_num:
        ret.append(torch.tensor(rois_num, dtype=torch.int32, device=dev))
    return tuple(ret) if len(ret) > 1 else out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None):
    """FPN level of each ROI (reference vision/ops.py:1175): ``floor(
    log2(sqrt(area) / refer_scale + 1e-8)) + refer_level`` clamped to
    [min_level, max_level]; (per-level ROIs in image order, the
    restore index ``[R, 1]`` int32, per-level ROI counts per image or
    None)."""
    rois = fpn_rois.double()
    dev = rois.device
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = torch.sqrt((w * h).clamp(min=1e-12))
    lvl = torch.floor(torch.log2(_div(scale, refer_scale) + 1e-8)) \
        + refer_level
    lvl = lvl.clamp(min_level, max_level).long()
    rn = (torch.as_tensor(rois_num, device=dev).long().reshape(-1)
          if rois_num is not None
          else torch.tensor([rois.shape[0]], device=dev))
    img_of = torch.repeat_interleave(torch.arange(rn.numel(), device=dev),
                                     rn)
    multi_rois, restore_src, lvl_rois_num = [], [], []
    for lv in range(min_level, max_level + 1):
        sel = torch.nonzero(lvl == lv)[:, 0]
        sel = sel[torch.sort(img_of[sel], stable=True).indices]
        multi_rois.append(rois[sel].float())
        restore_src.append(sel)
        lvl_rois_num.append(torch.bincount(img_of[sel], minlength=rn.numel())
                            .to(torch.int32))
    restore = torch.empty(rois.shape[0], dtype=torch.int64, device=dev)
    restore[torch.cat(restore_src)] = torch.arange(rois.shape[0], device=dev)
    restore = restore[:, None].to(torch.int32)
    return multi_rois, restore, (lvl_rois_num if rois_num is not None
                                 else None)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False):
    """RPN proposals (reference vision/ops.py:2108), per image: the
    ``pre_nms_top_n`` best scores (stable sort, H, W, A order), deltas
    decoded with the variances (sizes capped at ``exp(log(1000 / 16))``),
    clipped to the image, boxes under ``min_size`` dropped, greedy NMS at
    ``nms_thresh``, the first ``post_nms_top_n`` kept.  float64 on the
    inputs' device; (rois float32, probs ``[R, 1]`` float32, and with
    ``return_rois_num`` the count per image, int32)."""
    sc = scores.double()                    # [N, A, H, W]
    bd = bbox_deltas.double()               # [N, 4A, H, W]
    dev = sc.device
    ims = torch.as_tensor(img_size, device=dev).double()
    an = torch.as_tensor(anchors, device=dev).double().reshape(-1, 4)
    va = torch.as_tensor(variances, device=dev).double().reshape(-1, 4)
    N, A, H, W = sc.shape
    off = 1.0 if pixel_offset else 0.0
    cap = math.log(1000 / 16.)
    all_rois, all_probs, nums = [], [], []
    for n in range(N):
        s = sc[n].permute(1, 2, 0).reshape(-1)
        d = bd[n].reshape(A, 4, H, W).permute(2, 3, 0, 1).reshape(-1, 4)
        order = torch.sort(-s, stable=True).indices
        if pre_nms_top_n > 0:
            order = order[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], va[order]
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + aw * 0.5
        acy = a[:, 1] + ah * 0.5
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        bw = torch.exp(torch.clamp(v[:, 2] * d[:, 2], max=cap)) * aw
        bh = torch.exp(torch.clamp(v[:, 3] * d[:, 3], max=cap)) * ah
        ih, iw = ims[n, 0], ims[n, 1]
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        boxes = torch.stack([
            torch.minimum(torch.maximum(cx - bw / 2, zero), iw - off),
            torch.minimum(torch.maximum(cy - bh / 2, zero), ih - off),
            torch.minimum(torch.maximum(cx + bw / 2 - off, zero), iw - off),
            torch.minimum(torch.maximum(cy + bh / 2 - off, zero), ih - off),
        ], 1)
        ws = boxes[:, 2] - boxes[:, 0] + off
        hs = boxes[:, 3] - boxes[:, 1] + off
        big = (ws >= min_size) & (hs >= min_size)
        boxes, s = boxes[big], s[big]
        over = _pair_iou(boxes, boxes, normalized=not pixel_offset) \
            > nms_thresh
        sel = torch.nonzero(_greedy_keep(over))[:, 0]
        if post_nms_top_n > 0:
            sel = sel[:post_nms_top_n]
        all_rois.append(boxes[sel].float())
        all_probs.append(s[sel].float())
        nums.append(int(sel.numel()))
    rois = torch.cat(all_rois, 0)
    probs = torch.cat(all_probs, 0)[:, None]
    if return_rois_num:
        return rois, probs, torch.tensor(nums, dtype=torch.int32,
                                         device=dev)
    return rois, probs


# -- image io ---------------------------------------------------------------

def read_file(filename):
    """A file's bytes as a uint8 CPU tensor (reference
    vision/ops.py:1347)."""
    with open(filename, "rb") as f:
        return torch.frombuffer(bytearray(f.read()), dtype=torch.uint8)


def decode_jpeg(x, mode="unchanged"):
    """A JPEG byte tensor decoded to CHW uint8 on x's device (reference
    vision/ops.py:1390, there with nvjpeg; PIL on the host here, imported
    when called)."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(x.cpu().numpy().astype(np.uint8)
                                .tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.as_tensor(np.array(arr), device=x.device)


# -- layers -----------------------------------------------------------------

class RoIPool(nn.Module):
    """Layer form of ``roi_pool``."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class RoIAlign(nn.Module):
    """Layer form of ``roi_align``."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale, aligned=aligned)


class PSRoIPool(nn.Module):
    """Layer form of ``psroi_pool``."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)
