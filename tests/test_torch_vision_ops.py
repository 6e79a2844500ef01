"""The detection ops of the PyTorch port (``paddle_tpu_torch/vision/ops.py``)
against ``paddle_tpu``'s on the CPU: the same seeded numpy inputs through
both packages.

Tolerances: float outputs within 1e-5 of the largest magnitude (at least
1) (fp32 on both sides, sums in other orders; the roi reductions are
``index_add`` here and ``segment_sum`` there); indices, counts and
integer outputs exactly; ``roi_align``'s and ``deform_conv2d``'s sample
coordinates bit for bit (both build them in float64 with the same
operations and cast once).  The reference's ``roi_align`` builds its grid
in Python loops, so it runs at a few ROIs only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision import ops as pops


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    if isinstance(a, Tensor):
        a = a._data
    return np.asarray(a)


def _close(got, want, atol=1e-5):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


def _j(a, grad=False):
    return paddle.to_tensor(np.asarray(a), stop_gradient=not grad)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _boxes(rng, n, lo=0.0, hi=64.0, size=(4.0, 24.0)):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# -- nms ----------------------------------------------------------------------

NMS_CASES = {
    "scores": dict(scores=True),
    "index order": dict(),
    "categories": dict(scores=True, cats=True),
    "categories, no scores": dict(cats=True),
    "top_k": dict(scores=True, cats=True, top_k=7),
}


@pytest.mark.parametrize("case", list(NMS_CASES))
def test_nms_eager_route(case):
    """Eager: float64, a data-dependent count; the index order, the
    score order (ties to the lower index: scores on a coarse grid) and
    the category re-sort."""
    kw = NMS_CASES[case]
    rng = np.random.RandomState(0)
    n = 60
    b = _boxes(rng, n)
    s = (rng.randint(0, 12, n) / 12).astype(np.float32)
    c = rng.randint(0, 3, n).astype(np.int64)
    args = dict(iou_threshold=0.3, top_k=kw.get("top_k"))
    jk = jops.nms(_j(b), scores=_j(s) if "scores" in kw else None,
                  category_idxs=_j(c) if "cats" in kw else None, **args)
    pk = pops.nms(_t(b), scores=_t(s) if "scores" in kw else None,
                  category_idxs=_t(c) if "cats" in kw else None, **args)
    assert pk.dtype == torch.int64
    np.testing.assert_array_equal(pk.numpy(), _np(jk))
    assert 0 < len(pk) < n or "top_k" in kw


def test_nms_device_route_batched():
    """The fixed-size float32 route: ``_nms_device`` over 3 images at once
    equals the reference's traced nms (``jax.jit`` with ``top_k``) image
    by image, -1 padding included, and its first ``count`` entries equal
    the eager route's."""
    rng = np.random.RandomState(1)
    B, n, K = 3, 40, 32
    b = np.stack([_boxes(rng, n) for _ in range(B)])
    s = rng.rand(B, n).astype(np.float32)
    s[0, 5] = s[0, 9]                            # a tie: index 5 first
    c = rng.randint(0, 4, (B, n)).astype(np.int64)

    @jax.jit
    def traced(bb, ss, cc):
        return jops.nms(Tensor(bb), 0.4, Tensor(ss), Tensor(cc),
                        top_k=K)._data

    shifted = torch.stack([pops._category_shift(_t(b[i]), _t(c[i]))
                           for i in range(B)])
    got = pops._nms_device(shifted, _t(s), 0.4, K)
    assert got.shape == (B, K) and got.dtype == torch.int64
    for i in range(B):
        want = np.asarray(traced(b[i], s[i], c[i]))
        np.testing.assert_array_equal(got[i].numpy(), want)
        eager = pops.nms(_t(b[i]), 0.4, _t(s[i]), _t(c[i])).numpy()
        count = min(len(eager), K)
        np.testing.assert_array_equal(got[i, :count].numpy(),
                                      eager[:count])
        assert (got[i, count:] == -1).all()


# -- roi align / pool ----------------------------------------------------------

@pytest.mark.parametrize("aligned,ratio", [(True, -1), (False, 2)])
def test_roi_align_and_grad(aligned, ratio):
    """Values and the gradient of x; the sampling grid bit for bit."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 12, 14).astype(np.float32)
    b = np.array([[1.3, 2.2, 9.7, 10.1], [0.0, 0.0, 13.0, 11.0],
                  [4.5, 3.0, 6.0, 9.5], [-2.0, 1.0, 3.0, 4.0]], np.float32)
    num = np.array([3, 1], np.int32)
    g = rng.randn(4, 3, 3, 2).astype(np.float32)
    xj = _j(x, True)
    yj = jops.roi_align(xj, _j(b), _j(num), (3, 2), spatial_scale=0.9,
                        sampling_ratio=ratio, aligned=aligned)
    paddle.sum(yj * _j(g)).backward()
    xt = _t(x, True)
    yt = pops.RoIAlign((3, 2), 0.9)(xt, _t(b), _t(num), aligned=aligned) \
        if ratio == -1 else pops.roi_align(
            xt, _t(b), _t(num), (3, 2), 0.9, ratio, aligned)
    yt.backward(_t(g))
    _close(yt, yj)
    _close(xt.grad, xj.grad)
    sb, sy, sx, bin_id, inv, _ = pops.roi_align_grid(
        _t(b), _t(num), (3, 2), 0.9, ratio, aligned)
    want = _reference_grid(b, num, (3, 2), 0.9, ratio, aligned)
    for got, ref in zip((sb, sy, sx, bin_id, inv), want):
        np.testing.assert_array_equal(got.numpy(), ref)


def _reference_grid(b, num, output_size, scale, ratio, aligned):
    """``paddle_tpu``'s roi_align grid loop (vision/ops.py:190-224),
    verbatim but for the names."""
    import math

    ph, pw = output_size
    b = b.astype(np.float64)
    ids = np.repeat(np.arange(len(num)), num)
    off = 0.5 if aligned else 0.0
    out = [[], [], [], [], []]
    for r in range(b.shape[0]):
        x1, y1, x2, y2 = b[r] * scale
        x1, y1 = x1 - off, y1 - off
        x2, y2 = x2 - off, y2 - off
        rw, rh = x2 - x1, y2 - y1
        if not aligned:
            rw, rh = max(rw, 1.0), max(rh, 1.0)
        bin_h, bin_w = rh / ph, rw / pw
        gy = ratio if ratio > 0 else max(1, math.ceil(rh / ph))
        gx = ratio if ratio > 0 else max(1, math.ceil(rw / pw))
        for by in range(ph):
            for bx in range(pw):
                for iy in range(gy):
                    yy = y1 + by * bin_h + (iy + 0.5) * bin_h / gy
                    for ix in range(gx):
                        xx = x1 + bx * bin_w + (ix + 0.5) * bin_w / gx
                        for k, v in enumerate((ids[r], yy, xx,
                                               (r * ph + by) * pw + bx,
                                               1.0 / (gy * gx))):
                            out[k].append(v)
    return [np.array(out[0]), np.array(out[1], np.float32),
            np.array(out[2], np.float32), np.array(out[3]),
            np.array(out[4], np.float32)]


def test_roi_pool_and_psroi_pool():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 10, 12).astype(np.float32)
    b = np.array([[0.4, 1.5, 7.0, 8.5], [2.5, 2.5, 3.5, 3.5],
                  [-3.0, 5.0, 20.0, 30.0]], np.float32)
    num = np.array([1, 2], np.int32)
    g = rng.randn(3, 8, 2, 2).astype(np.float32)
    xj = _j(x, True)
    yj = jops.roi_pool(xj, _j(b), _j(num), 2, 0.8)
    paddle.sum(yj * _j(g)).backward()
    xt = _t(x, True)
    yt = pops.RoIPool(2, 0.8)(xt, _t(b), _t(num))
    yt.backward(_t(g))
    _close(yt, yj)
    _close(xt.grad, xj.grad)
    _close(pops.PSRoIPool(2, 0.8)(_t(x), _t(b), _t(num)),
           jops.psroi_pool(_j(x), _j(b), _j(num), 2, 0.8))


# -- box coder, prior box, yolo --------------------------------------------------

@pytest.mark.parametrize("code,var", [("encode_center_size", "list"),
                                      ("decode_center_size", "tensor")])
def test_box_coder(code, var):
    rng = np.random.RandomState(4)
    p = _boxes(rng, 5, size=(2.0, 9.0))
    v = [0.1, 0.1, 0.2, 0.2] if var == "list" else \
        rng.uniform(0.1, 0.3, (5, 4)).astype(np.float32)
    t = _boxes(rng, 3) if code.startswith("encode") else \
        rng.randn(3, 5, 4).astype(np.float32) * 0.3
    vj = v if var == "list" else _j(v)
    vt = v if var == "list" else _t(v)
    for norm in (True, False):
        _close(pops.box_coder(_t(p), vt, _t(t), code, norm),
               jops.box_coder(_j(p), vj, _j(t), code, norm))


def test_prior_box():
    feat, img = torch.zeros(1, 8, 4, 5), torch.zeros(1, 3, 40, 50)
    kw = dict(min_sizes=[8.0, 16.0], max_sizes=[16.0, 30.0],
              aspect_ratios=[2.0, 3.0], flip=True, clip=True)
    for order in (False, True):
        got = pops.prior_box(feat, img, min_max_aspect_ratios_order=order,
                             **kw)
        want = jops.prior_box(_j(feat.numpy()), _j(img.numpy()),
                              min_max_aspect_ratios_order=order, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("iou_aware", [False, True])
def test_yolo_box(iou_aware):
    rng = np.random.RandomState(5)
    an = [10, 13, 16, 30, 33, 23]
    C = 3 * (5 + 4) + (3 if iou_aware else 0)
    x = rng.randn(2, C, 5, 6).astype(np.float32)
    img = np.array([[160, 192], [150, 170]], np.int32)
    got = pops.yolo_box(_t(x), _t(img), an, 4, 0.3, 32,
                        scale_x_y=1.05, iou_aware=iou_aware)
    want = jax.jit(lambda v: [t._data for t in jops.yolo_box(
        Tensor(v), img, an, 4, 0.3, 32, scale_x_y=1.05,
        iou_aware=iou_aware)])(jnp.asarray(x))
    for g, w in zip(got, want):
        _close(g, w)


def test_yolo_loss_and_grad():
    """The loss and its gradient in x; one row of gt padding (w = h = 0)
    and one gt whose best anchor is outside the mask."""
    rng = np.random.RandomState(6)
    an = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    mask, cls = [0, 1, 2], 5
    x = (rng.randn(2, 3 * (5 + cls), 6, 6) * 0.5).astype(np.float32)
    gtb = rng.uniform(0.1, 0.9, (2, 4, 4)).astype(np.float32)
    gtb[:, :, 2:] *= 0.2
    gtb[0, 3] = 0.0
    gtb[1, 2, 2:] = [0.9, 0.9]
    gtl = rng.randint(0, cls, (2, 4)).astype(np.int64)
    gts = rng.uniform(0.5, 1.0, (2, 4)).astype(np.float32)
    gj = [_j(gtb), _j(gtl), _j(gts)]
    loss, grad = jax.jit(jax.value_and_grad(lambda v: jops.yolo_loss(
        Tensor(v), gj[0], gj[1], an, mask, cls, 0.5, 32, gt_score=gj[2],
        scale_x_y=1.1)._data.sum()))(jnp.asarray(x))
    xt = _t(x, True)
    lt = pops.yolo_loss(xt, _t(gtb), _t(gtl), an, mask, cls, 0.5, 32,
                        gt_score=_t(gts), scale_x_y=1.1)
    lt.sum().backward()
    assert lt.shape == (2,)
    _close(lt.sum(), loss)
    _close(xt.grad, grad)


# -- deformable convolution ------------------------------------------------------

DEFORM = {"v1": dict(), "v2": dict(mask=True),
          "dg 2, groups 2": dict(mask=True, dg=2, groups=2),
          "stride 2, pad, dilation": dict(stride=2, padding=2, dilation=2)}


def _deform_case(i, kw):
    dg, groups = kw.get("dg", 1), kw.get("groups", 1)
    stride, pad, dil = (kw.get("stride", 1), kw.get("padding", 1),
                        kw.get("dilation", 1))
    rng = np.random.RandomState(7 + i)
    B, Cin, H, W, Cout = 2, 4, 7, 8, 6
    Ho = (H + 2 * pad - (dil * 2 + 1)) // stride + 1
    Wo = (W + 2 * pad - (dil * 2 + 1)) // stride + 1
    arrays = [rng.randn(B, Cin, H, W).astype(np.float32),
              (rng.randn(B, 2 * dg * 9, Ho, Wo) * 2).astype(np.float32),
              (rng.randn(Cout, Cin // groups, 3, 3) * 0.3).astype(
                  np.float32),
              rng.randn(Cout).astype(np.float32)]
    if kw.get("mask"):
        arrays.append(rng.rand(B, dg * 9, Ho, Wo).astype(np.float32))
    return dict(cfg=dict(stride=stride, padding=pad, dilation=dil,
                         deformable_groups=dg, groups=groups),
                arrays=arrays,
                g=rng.randn(B, Cout, Ho, Wo).astype(np.float32))


@pytest.fixture(scope="module")
def deform_ref():
    """The reference's outputs and the gradients of x, offset, weight,
    bias and mask, every case in one ``jax.jit``."""
    cases = {n: _deform_case(i, kw) for i, (n, kw) in enumerate(
        DEFORM.items())}

    def run(arrs):
        out = {}
        for n, a in zip(cases, arrs):
            c = cases[n]

            def f(x, off, w, b, *m):
                return jops.deform_conv2d(
                    Tensor(x), Tensor(off), Tensor(w), Tensor(b),
                    mask=Tensor(m[0]) if m else None, **c["cfg"])._data
            o, vjp = jax.vjp(f, *a)
            out[n] = (o, vjp(jnp.asarray(c["g"])))
        return out
    ref = jax.jit(run)([[jnp.asarray(a) for a in c["arrays"]]
                        for c in cases.values()])
    return cases, ref


@pytest.mark.parametrize("case", list(DEFORM))
def test_deform_conv2d(case, deform_ref):
    """Random offsets (taps out of the image included) and masks: values
    and the gradients of x, offset, weight, bias and mask."""
    cases, ref = deform_ref
    c = cases[case]
    want, grads = ref[case]
    ts = [_t(a, True) for a in c["arrays"]]
    got = pops.deform_conv2d(ts[0], ts[1], ts[2], ts[3],
                             mask=ts[4] if len(ts) > 4 else None,
                             **c["cfg"])
    got.backward(_t(c["g"]))
    _close(got, want)
    for t, gw in zip(ts, grads):
        _close(t.grad, gw)


def test_deform_conv2d_zero_offset_is_conv_and_layer():
    """Zero offsets and a unit mask: the port's ``conv2d`` (the strongest
    oracle, ``tests/test_detection_amp.py``).  ``DeformConv2D`` loads the
    reference layer's numpy state (names and shapes the reference's) and
    its forward with random offsets equals the reference layer's."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch.models import load_numpy_state

    rng = np.random.RandomState(8)
    x = rng.randn(2, 4, 9, 9).astype(np.float32)
    const = paddle.ParamAttr(initializer=jnn.initializer.Constant(0.0))
    ref = jops.DeformConv2D(4, 6, 3, padding=1, groups=2,
                            weight_attr=const, bias_attr=const)
    for p in ref.parameters():
        p._data = jnp.asarray(rng.randn(*p.shape).astype(np.float32))
    layer = pops.DeformConv2D(4, 6, 3, padding=1, groups=2, device="cpu")
    load_numpy_state(layer, {k: _np(v) for k, v in
                             ref.state_dict().items()})
    off = (rng.randn(2, 18, 9, 9) * 2).astype(np.float32)
    _close(layer(_t(x), _t(off)), ref(_j(x), _j(off)))
    got = layer(_t(x), torch.zeros(2, 18, 9, 9), torch.ones(2, 9, 9, 9))
    want = PF.conv2d(_t(x), layer.weight, layer.bias, padding=1, groups=2)
    _close(got, want)


# -- matrix nms, proposals, FPN levels ----------------------------------------

@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    rng = np.random.RandomState(9)
    N, C, M = 2, 4, 30
    bb = np.stack([_boxes(rng, M) / 80 for _ in range(N)])
    sc = rng.rand(N, C, M).astype(np.float32)
    sc[1, 2] = 0.0                                   # a class with nothing
    kw = dict(score_threshold=0.3, post_threshold=0.2, nms_top_k=12,
              keep_top_k=25, use_gaussian=gaussian, return_index=True)
    got = pops.matrix_nms(_t(bb), _t(sc), **kw)
    want = jops.matrix_nms(_j(bb), _j(sc), **kw)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_generate_proposals_and_distribute_fpn():
    rng = np.random.RandomState(10)
    N, A, H, W = 2, 3, 5, 6
    sc = rng.rand(N, A, H, W).astype(np.float32)
    bd = (rng.randn(N, 4 * A, H, W) * 0.5).astype(np.float32)
    an = np.stack([_boxes(rng, H * W * A, 0, 90, (8, 40))]).reshape(
        H, W, A, 4)
    va = np.full((H, W, A, 4), 0.5, np.float32)
    im = np.array([[100, 120], [90, 110]], np.float32)
    kw = dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.5,
              min_size=2.0, return_rois_num=True)
    got = pops.generate_proposals(_t(sc), _t(bd), _t(im), _t(an), _t(va),
                                  **kw)
    want = jops.generate_proposals(_j(sc), _j(bd), _j(im), _j(an), _j(va),
                                   **kw)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    rois, num = got[0], got[2]
    g = pops.distribute_fpn_proposals(rois, 2, 5, 4, 24.0, rois_num=num)
    w = jops.distribute_fpn_proposals(_j(rois.numpy()), 2, 5, 4, 24.0,
                                      rois_num=_j(num.numpy()))
    for a, b in zip(g[0], w[0]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(g[1].numpy(), _np(w[1]))
    for a, b in zip(g[2], w[2]):
        np.testing.assert_array_equal(a.numpy(), _np(b))


# -- image io ---------------------------------------------------------------

def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(11)
    path = tmp_path / "a.jpg"
    Image.fromarray(rng.randint(0, 255, (6, 7, 3), np.uint8)).save(path)
    raw = pops.read_file(str(path))
    np.testing.assert_array_equal(raw.numpy(),
                                  _np(jops.read_file(str(path))))
    for mode in ("unchanged", "gray", "rgb"):
        np.testing.assert_array_equal(
            pops.decode_jpeg(raw, mode).numpy(),
            _np(jops.decode_jpeg(jops.read_file(str(path)), mode)))


# -- the eval pipeline of tests/test_detection_amp.py --------------------------

def test_class_aware_nms_batch_of_candidates():
    """The detection eval's filter at a small size: per image the top
    candidates (cell, class) by a stable sort, class-aware nms; the
    eager route against the reference and the batched fixed route
    against the eager one."""
    rng = np.random.RandomState(12)
    B, cells, classes, top, keep = 3, 16, 5, 40, 12
    ys, xs = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    centres = np.stack([xs, ys, xs, ys], -1).reshape(-1, 4) * 8.0 + 4.0
    off = np.abs(rng.randn(B, cells, 4)) * 8.0
    boxes = np.concatenate([centres[None, :, :2] - off[..., :2],
                            centres[None, :, 2:] + off[..., 2:]], -1)
    boxes = (np.round(boxes * 64) / 64).astype(np.float32)
    scores = rng.rand(B, classes, cells).astype(np.float32)
    flat = torch.from_numpy(scores.reshape(B, -1))
    order = torch.sort(-flat, dim=1, stable=True).indices[:, :top]
    cls, cell = order // cells, order % cells
    cand = torch.stack([torch.from_numpy(boxes[i])[cell[i]]
                        for i in range(B)])
    cs = flat.gather(1, order)
    shifted = []
    for i in range(B):
        got = pops.nms(cand[i], 0.3, cs[i], cls[i], top_k=keep)
        want = jops.nms(_j(cand[i].numpy()), 0.3, _j(cs[i].numpy()),
                        _j(cls[i].numpy()), top_k=keep)
        np.testing.assert_array_equal(got.numpy(), _np(want))
        shifted.append(pops._category_shift(cand[i], cls[i]))
        fixed = pops._nms_device(shifted[i][None], cs[i][None], 0.3, keep)
        np.testing.assert_array_equal(fixed[0, :len(got)].numpy(),
                                      got.numpy())
    batched = pops._nms_device(torch.stack(shifted), cs, 0.3, keep)
    for i in range(B):
        np.testing.assert_array_equal(
            batched[i].numpy(),
            pops._nms_device(shifted[i][None], cs[i][None], 0.3, keep)[0])
