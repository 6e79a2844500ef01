"""Vision transforms of the port.  Counterpart of
``paddle_tpu/vision/transforms.py``: host-side numpy on HWC, CHW or HW
arrays, as the reference's (augmentation runs in the input pipeline,
not on the device).

Every random transform takes ``generator``: a ``numpy.random.
RandomState`` (its draws are the reference's ``np.random`` calls, in the
reference's order, so a state seeded as ``np.random.seed`` seeds the
reference gives the reference's arrays) or a ``torch.Generator`` (CPU);
by default a CPU ``torch.Generator`` seeded with 0.  ``Resize`` resizes
with the port's bilinear ``interpolate`` (``jax.image.resize``'s
``"linear"``: half-pixel centres, antialiased when it shrinks);
``to_tensor`` returns a CPU ``torch.Tensor``.
"""
from __future__ import annotations

import numpy as np
import torch


class _TorchDraws:
    """The four ``np.random`` draws the transforms make, from a
    ``torch.Generator``."""

    def __init__(self, generator):
        self.g = generator

    def rand(self):
        return float(torch.rand((), generator=self.g, dtype=torch.float64))

    def uniform(self, low=0.0, high=1.0):
        return low + (high - low) * self.rand()

    def randint(self, low, high):
        return int(torch.randint(int(low), int(high), (), generator=self.g))

    def normal(self, size):
        return torch.randn(size, generator=self.g,
                           dtype=torch.float64).numpy()


def _draws(generator):
    """The draw source of a random transform (see the module's note)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if isinstance(generator, torch.Generator):
        return _TorchDraws(generator)
    return generator


def _is_chw(arr):
    """Channel-first heuristic shared by every transform: 3-d with a
    small leading channel count and a non-channel trailing dim."""
    return (arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
            and arr.shape[-1] not in (1, 3, 4))



class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (x - self.mean.reshape(shape)) / self.std.reshape(shape)


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[None] if self.data_format == "CHW" else arr[..., None]
        elif self.data_format == "CHW" and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
        return arr


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        from ..ops.nn_ops import interpolate

        arr = np.asarray(img, dtype=np.float32)
        chw = _is_chw(arr)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if arr.ndim == 2:
            t = t[None, None]
        elif chw:
            t = t[None]
        else:
            t = t.permute(2, 0, 1)[None]
        out = interpolate(t, self.size, "bilinear")[0]
        if arr.ndim == 2:
            out = out[0]
        elif not chw:
            out = out.permute(1, 2, 0)
        return out.contiguous().numpy()


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, generator=None):
        self.prob = prob
        self.rng = _draws(generator)

    def __call__(self, img):
        if self.rng.rand() < self.prob:
            return np.asarray(img)[..., ::-1].copy()
        return img


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img)
        chw = _is_chw(arr)
        h, w = (arr.shape[1], arr.shape[2]) if chw else arr.shape[:2]
        th, tw = self.size
        i, j = (h - th) // 2, (w - tw) // 2
        return arr[:, i:i + th, j:j + tw] if chw else arr[i:i + th,
                                                          j:j + tw]


class Pad:
    """Pad all sides (reference transforms.Pad); HWC or CHW arrays."""

    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = (padding,) * 4 if isinstance(padding, int) else (
            tuple(padding) * 2 if len(padding) == 2 else tuple(padding))
        self.fill = fill
        self.mode = padding_mode

    def __call__(self, img):
        arr = np.asarray(img)
        left, top, right, bottom = self.padding
        chw = _is_chw(arr)
        if chw:
            pads = [(0, 0), (top, bottom), (left, right)]
        elif arr.ndim == 3:
            pads = [(top, bottom), (left, right), (0, 0)]
        else:
            pads = [(top, bottom), (left, right)]
        if self.mode == "constant":
            return np.pad(arr, pads, mode="constant",
                          constant_values=self.fill)
        return np.pad(arr, pads, mode=self.mode)


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False,
                 generator=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.rng = _draws(generator)

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding is not None:
            arr = Pad(self.padding)(arr)
        chw = _is_chw(arr)
        h, w = (arr.shape[1], arr.shape[2]) if chw else arr.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            ph, pw = max(th - h, 0), max(tw - w, 0)
            arr = Pad((pw, ph, pw, ph))(arr)
            h, w = h + 2 * ph, w + 2 * pw
        i = self.rng.randint(0, h - th + 1)
        j = self.rng.randint(0, w - tw + 1)
        return arr[:, i:i + th, j:j + tw] if chw \
            else arr[i:i + th, j:j + tw]


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 generator=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.rng = _draws(generator)

    def __call__(self, img):
        arr = np.asarray(img)
        chw = _is_chw(arr)
        h, w = (arr.shape[1], arr.shape[2]) if chw else arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * self.rng.uniform(*self.scale)
            ar = np.exp(self.rng.uniform(np.log(self.ratio[0]),
                                         np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = self.rng.randint(0, h - ch + 1)
                j = self.rng.randint(0, w - cw + 1)
                crop = arr[:, i:i + ch, j:j + cw] if chw \
                    else arr[i:i + ch, j:j + cw]
                return Resize(self.size)(crop)
        return Resize(self.size)(CenterCrop(min(h, w))(arr))


class Grayscale:
    def __init__(self, num_output_channels=1):
        self.n = num_output_channels

    def __call__(self, img):
        arr = np.asarray(img).astype(np.float32)
        chw = _is_chw(arr)
        wts = np.array([0.299, 0.587, 0.114], np.float32)
        if chw:
            g = np.tensordot(wts, arr[:3], 1)[None]
            return np.repeat(g, self.n, 0) if self.n > 1 else g
        g = arr[..., :3] @ wts
        g = g[..., None]
        return np.repeat(g, self.n, -1) if self.n > 1 else g


class RandomRotation:
    """Rotation by a uniform angle (nearest-neighbor resample — host
    numpy; augmentations run in the input pipeline, not on device)."""

    def __init__(self, degrees, fill=0, generator=None):
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.fill = fill
        self.rng = _draws(generator)

    def __call__(self, img):
        arr = np.asarray(img)
        angle = np.deg2rad(self.rng.uniform(*self.degrees))
        chw = _is_chw(arr)
        a = arr if not chw else np.moveaxis(arr, 0, -1)
        h, w = a.shape[:2]
        cy, cx = (h - 1) / 2, (w - 1) / 2
        ys, xs = np.mgrid[0:h, 0:w]
        c, s = np.cos(angle), np.sin(angle)
        sy = cy + (ys - cy) * c - (xs - cx) * s
        sx = cx + (ys - cy) * s + (xs - cx) * c
        syi = np.round(sy).astype(int)
        sxi = np.round(sx).astype(int)
        valid = (syi >= 0) & (syi < h) & (sxi >= 0) & (sxi < w)
        out = np.full_like(a, self.fill)
        out[valid] = a[syi[valid], sxi[valid]]
        return np.moveaxis(out, -1, 0) if chw else out


class ColorJitter:
    """Brightness/contrast/saturation jitter (hue omitted — documented
    subset; reference transforms.ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 generator=None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.rng = _draws(generator)

    def __call__(self, img):
        arr = np.asarray(img).astype(np.float32)
        if self.brightness:
            arr = arr * self.rng.uniform(max(0, 1 - self.brightness),
                                         1 + self.brightness)
        if self.contrast:
            f = self.rng.uniform(max(0, 1 - self.contrast),
                                 1 + self.contrast)
            arr = (arr - arr.mean()) * f + arr.mean()
        if self.saturation:
            f = self.rng.uniform(max(0, 1 - self.saturation),
                                 1 + self.saturation)
            chw = _is_chw(arr)
            axis = 0 if chw else -1
            gray = arr.mean(axis=axis, keepdims=True)
            arr = gray + (arr - gray) * f
        return arr


# --- functional API (reference: python/paddle/vision/transforms/
# functional.py) — host-side numpy: augmentation runs in the input
# pipeline, never on device ------------------------------------------------

def _hwc(arr):
    """Return (HWC-view, was_chw) for 2-d/3-d arrays."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        return arr[..., None], "hw"
    if _is_chw(arr):
        return np.moveaxis(arr, 0, -1), "chw"
    return arr, "hwc"


def _unhwc(arr, fmt):
    if fmt == "hw":
        return arr[..., 0]
    if fmt == "chw":
        return np.moveaxis(arr, -1, 0)
    return arr


def to_tensor(pic, data_format="CHW"):
    """PIL/ndarray -> float CPU tensor scaled to [0,1] (reference
    functional.to_tensor)."""
    return torch.from_numpy(np.ascontiguousarray(
        ToTensor(data_format)(pic)))


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def hflip(img):
    a, fmt = _hwc(img)
    return _unhwc(a[:, ::-1].copy(), fmt)


def vflip(img):
    a, fmt = _hwc(img)
    return _unhwc(a[::-1].copy(), fmt)


def resize(img, size, interpolation="bilinear"):
    if isinstance(size, int):
        a, fmt = _hwc(img)
        h, w = a.shape[:2]
        if h <= w:
            size = (size, max(1, int(round(w * size / h))))
        else:
            size = (max(1, int(round(h * size / w))), size)
    return Resize(size, interpolation)(img)


def pad(img, padding, fill=0, padding_mode="constant"):
    return Pad(padding, fill, padding_mode)(img)


def crop(img, top, left, height, width):
    a, fmt = _hwc(img)
    return _unhwc(a[top:top + height, left:left + width].copy(), fmt)


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def to_grayscale(img, num_output_channels=1):
    return Grayscale(num_output_channels)(img)


def adjust_brightness(img, brightness_factor):
    a = np.asarray(img)
    out = np.asarray(a, np.float32) * float(brightness_factor)
    if np.issubdtype(a.dtype, np.integer):
        return np.clip(out, 0, 255).astype(a.dtype)
    return out


def adjust_contrast(img, contrast_factor):
    a = np.asarray(img)
    f32 = np.asarray(a, np.float32)
    gray_mean = to_grayscale(f32).mean()
    out = (f32 - gray_mean) * float(contrast_factor) + gray_mean
    if np.issubdtype(a.dtype, np.integer):
        return np.clip(out, 0, 255).astype(a.dtype)
    return out


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb, -1)
    minc = np.min(rgb, -1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
    dz = np.maximum(delta, 1e-12)
    rc, gc, bc = (maxc - r) / dz, (maxc - g) / dz, (maxc - b) / dz
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, h / 6.0) % 1.0
    return np.stack([h, s, v], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(int) % 6
    choices = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1)], 0)
    return np.take_along_axis(
        choices, i[None, ..., None].repeat(3, -1), 0)[0]


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor in [-0.5, 0.5] (reference
    functional.adjust_hue)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    a = np.asarray(img)
    hwc, fmt = _hwc(a)
    scale = 255.0 if np.issubdtype(a.dtype, np.integer) else 1.0
    hsv = _rgb_to_hsv(np.asarray(hwc, np.float32) / scale)
    hsv[..., 0] = (hsv[..., 0] + hue_factor) % 1.0
    out = _hsv_to_rgb(hsv) * scale
    if np.issubdtype(a.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255)
    return _unhwc(out.astype(a.dtype), fmt)


def erase(img, i, j, h, w, v, inplace=False):
    """Erase the [i:i+h, j:j+w] patch with value v (reference
    functional.erase).  v may be a scalar, a per-channel vector, or a full
    [C, h, w] patch (the RandomErasing 'random' fill)."""
    vv = np.asarray(v)
    patch = None  # full [C, h, w] fill
    if vv.ndim >= 2:
        patch = vv.reshape(-1, h, w)
    elif vv.ndim == 1:
        vv = vv.reshape(-1)  # per-channel vector, any input orientation
    if isinstance(img, torch.Tensor):
        a = np.array(img.cpu().numpy())
        chw = a.ndim == 3 and _is_chw(a)
        if chw:
            pv = patch if patch is not None else (
                vv[:, None, None] if vv.ndim else vv)
            a[:, i:i + h, j:j + w] = np.broadcast_to(
                np.asarray(pv).astype(a.dtype), (a.shape[0], h, w))
        else:
            pv = np.moveaxis(patch, 0, -1) if patch is not None else vv
            a[i:i + h, j:j + w] = np.broadcast_to(
                np.asarray(pv).astype(a.dtype),
                a[i:i + h, j:j + w].shape)
        out = torch.as_tensor(a, device=img.device)
        if inplace:
            img.copy_(out)
            return img
        return out
    a = np.asarray(img)
    hwc, fmt = _hwc(a)
    hwc = hwc.copy()
    pv = np.moveaxis(patch, 0, -1) if patch is not None else vv
    hwc[i:i + h, j:j + w] = np.broadcast_to(
        np.asarray(pv).astype(a.dtype), (h, w, hwc.shape[-1]))
    out = _unhwc(hwc, fmt)
    if inplace and isinstance(img, np.ndarray):
        img[...] = out
        return img
    return out


def _bilinear_sample(a, sy, sx, fill):
    """Sample HWC array at fractional (sy, sx) grids with bilinear
    interpolation and constant fill outside."""
    h, w = a.shape[:2]
    y0 = np.floor(sy).astype(int)
    x0 = np.floor(sx).astype(int)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    out = np.zeros(sy.shape + (a.shape[-1],), np.float32)
    fillv = np.broadcast_to(np.asarray(fill, np.float32), a.shape[-1:])
    for dy, dx, wgt in ((0, 0, (1 - wy) * (1 - wx)),
                        (0, 1, (1 - wy) * wx),
                        (1, 0, wy * (1 - wx)),
                        (1, 1, wy * wx)):
        yy, xx = y0 + dy, x0 + dx
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = np.where(valid[..., None],
                        a[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)],
                        fillv)
        out = out + wgt * vals
    return out


def _warp(img, inv33, fill=0, interpolation="bilinear"):
    """Warp by the inverse 3x3 output->input coordinate map."""
    a, fmt = _hwc(img)
    a32 = np.asarray(a, np.float32)
    h, w = a32.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], 0).reshape(3, -1)
    src = inv33 @ coords
    denom = np.where(np.abs(src[2]) < 1e-12, 1e-12, src[2])
    sx = (src[0] / denom).reshape(h, w)
    sy = (src[1] / denom).reshape(h, w)
    if interpolation == "nearest":
        syi, sxi = np.round(sy).astype(int), np.round(sx).astype(int)
        valid = (syi >= 0) & (syi < h) & (sxi >= 0) & (sxi < w)
        out = np.full_like(
            a32, np.broadcast_to(np.asarray(fill, np.float32),
                                 a32.shape[-1:]))
        out[valid] = a32[syi[valid], sxi[valid]]
    else:
        out = _bilinear_sample(a32, sy, sx, fill)
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        out = np.clip(np.round(out), 0, 255)
    return _unhwc(out.astype(np.asarray(img).dtype), fmt)


def _affine_inverse(center, angle, translate, scale, shear):
    """Inverse affine matrix for output->input mapping (reference
    functional._get_inverse_affine_matrix semantics)."""
    rot = np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in shear)
    cx, cy = center
    tx, ty = translate
    # forward: M = T(center) R(rot) Shear Scale T(-center) + translate
    a = np.cos(rot - sy) / np.cos(sy)
    b = -np.cos(rot - sy) * np.tan(sx) / np.cos(sy) - np.sin(rot)
    c = np.sin(rot - sy) / np.cos(sy)
    d = -np.sin(rot - sy) * np.tan(sx) / np.cos(sy) + np.cos(rot)
    fwd = np.array([[scale * a, scale * b, 0.0],
                    [scale * c, scale * d, 0.0],
                    [0.0, 0.0, 1.0]], np.float64)
    pre = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]],
                   np.float64)
    post = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    return np.linalg.inv(pre @ fwd @ post)


def affine(img, angle, translate=(0, 0), scale=1.0, shear=(0, 0),
           interpolation="nearest", fill=0, center=None):
    """Affine warp (reference functional.affine)."""
    a, _ = _hwc(img)
    h, w = a.shape[:2]
    if np.isscalar(shear):
        shear = (float(shear), 0.0)
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    inv = _affine_inverse(center, angle, translate, scale, shear)
    return _warp(img, inv, fill, interpolation)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate (reference functional.rotate; expand unsupported keeps the
    input canvas, matching the default)."""
    return affine(img, angle, interpolation=interpolation, fill=fill,
                  center=center)


def _homography(src_pts, dst_pts):
    """3x3 homography H with H @ src ~ dst (4 point pairs)."""
    A, b = [], []
    for (sx, sy), (dx, dy) in zip(src_pts, dst_pts):
        A.append([sx, sy, 1, 0, 0, 0, -dx * sx, -dx * sy])
        b.append(dx)
        A.append([0, 0, 0, sx, sy, 1, -dy * sx, -dy * sy])
        b.append(dy)
    h = np.linalg.solve(np.asarray(A, np.float64),
                        np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Perspective warp mapping startpoints->endpoints (reference
    functional.perspective: points are [[x, y]] corner lists)."""
    fwd = _homography(startpoints, endpoints)
    return _warp(img, np.linalg.inv(fwd), fill, interpolation)


# --- class transforms over the functional API ------------------------------

class BaseTransform:
    """Keyed-transform protocol (reference transforms.BaseTransform:
    _get_params once, then _apply_<key> per input); ``generator`` feeds
    the random subclasses' draws."""

    def __init__(self, keys=None, generator=None):
        self.keys = keys if keys is not None else ("image",)
        self.params = None
        self.rng = _draws(generator)

    def _get_params(self, inputs):
        return None

    def __call__(self, inputs):
        if not isinstance(inputs, (tuple, list)):
            inputs = (inputs,)
        self.params = self._get_params(inputs)
        outputs = []
        for i, data in enumerate(inputs):
            key = self.keys[i] if i < len(self.keys) else "image"
            apply_fn = getattr(self, f"_apply_{key}", None)
            outputs.append(data if apply_fn is None else apply_fn(data))
        if len(outputs) == 1:
            return outputs[0]
        return tuple(outputs)

    def _apply_image(self, img):
        return img


class Transpose(BaseTransform):
    """HWC -> CHW (reference transforms.Transpose)."""

    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = tuple(order)

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(self.order)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None, generator=None):
        super().__init__(keys, generator)
        self.prob = prob

    def _apply_image(self, img):
        if self.rng.rand() < self.prob:
            return vflip(img)
        return img


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys, generator)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = self.rng.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys, generator)
        if value < 0:
            raise ValueError("contrast value should be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = self.rng.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys, generator)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = self.rng.uniform(max(0, 1 - self.value), 1 + self.value)
        gray = to_grayscale(np.asarray(img, np.float32),
                            num_output_channels=3)
        a = np.asarray(img, np.float32)
        hwc, fmt = _hwc(a)
        ghwc, _ = _hwc(gray)
        out = ghwc + (hwc - ghwc) * f
        if np.issubdtype(np.asarray(img).dtype, np.integer):
            out = np.clip(np.round(out), 0, 255)
        return _unhwc(out.astype(np.asarray(img).dtype), fmt)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys, generator)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value should be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, self.rng.uniform(-self.value, self.value))


class RandomAffine(BaseTransform):
    """Random affine (reference transforms.RandomAffine)."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None,
                 generator=None):
        super().__init__(keys, generator)
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        a, _ = _hwc(img)
        h, w = a.shape[:2]
        angle = self.rng.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = self.rng.uniform(-self.translate[0],
                                  self.translate[0]) * w
            ty = self.rng.uniform(-self.translate[1],
                                  self.translate[1]) * h
        scale = self.rng.uniform(*self.scale) if self.scale else 1.0
        shear = (0.0, 0.0)
        if self.shear is not None:
            sh = self.shear
            if np.isscalar(sh):
                sh = (-sh, sh)
            shear = (self.rng.uniform(sh[0], sh[1]),
                     self.rng.uniform(sh[2], sh[3])
                     if len(sh) == 4 else 0.0)
        return affine(img, angle, (tx, ty), scale, shear,
                      self.interpolation, self.fill, self.center)


class RandomPerspective(BaseTransform):
    """Random perspective distortion (reference
    transforms.RandomPerspective)."""

    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None,
                 generator=None):
        super().__init__(keys, generator)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        if self.rng.rand() >= self.prob:
            return img
        a, _ = _hwc(img)
        h, w = a.shape[:2]
        d = self.distortion_scale
        half_h, half_w = int(d * h / 2), int(d * w / 2)
        def rnd(lo, hi):
            return int(self.rng.randint(lo, max(hi, lo + 1)))
        start = [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]
        end = [[rnd(0, half_w), rnd(0, half_h)],
               [w - 1 - rnd(0, half_w), rnd(0, half_h)],
               [w - 1 - rnd(0, half_w), h - 1 - rnd(0, half_h)],
               [rnd(0, half_w), h - 1 - rnd(0, half_h)]]
        return perspective(img, start, end, self.interpolation,
                           self.fill)


class RandomErasing(BaseTransform):
    """Random cutout rectangle (reference transforms.RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None, generator=None):
        super().__init__(keys, generator)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        if self.rng.rand() >= self.prob:
            return img
        a, _ = _hwc(np.asarray(
            img.cpu().numpy() if isinstance(img, torch.Tensor) else img))
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * self.rng.uniform(*self.scale)
            ar = np.exp(self.rng.uniform(np.log(self.ratio[0]),
                                         np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                i = self.rng.randint(0, h - eh + 1)
                j = self.rng.randint(0, w - ew + 1)
                if isinstance(self.value, str):
                    if self.value != "random":
                        raise ValueError(
                            "value only supports 'random' as a string")
                    # reference RandomErasing: per-element normal noise
                    c = a.shape[-1]
                    v = self.rng.normal(
                        size=(c, eh, ew)).astype(np.float32)
                elif np.isscalar(self.value):
                    v = self.value
                else:
                    v = np.asarray(self.value, np.float32)
                return erase(img, i, j, eh, ew, v, self.inplace)
        return img
