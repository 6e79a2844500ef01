"""The vision transforms and datasets of the PyTorch port
(``paddle_tpu_torch/vision/transforms.py``, ``vision/datasets.py``)
against ``paddle_tpu``'s on the CPU.

The reference's random transforms draw from numpy's global RNG; the
port's from the ``generator`` each is given.  One ``RandomState(s)``
shared by the port's transforms of a pipeline makes the reference's
draws in the reference's order, so after ``np.random.seed(s)`` both
pipelines give the same arrays.  The datasets read files that the tests
write under ``tmp_path`` (idx files, CIFAR tarballs, a folder of PNGs, a
VOC tar, Flowers' archive and .mat files).

Tolerances: arrays that pass through ``Resize`` (``jax.image.resize``
there, the port's bilinear ``interpolate`` here) within 1e-5 of the
largest magnitude; everything else exactly.
"""
import gzip
import io
import pickle
import tarfile

import numpy as np
import pytest
import torch

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jT
from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import transforms as pT


def _close(got, want, atol=1e-5):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want,
                      np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol * max(1.0, np.abs(want).max()))


def _pipelines(seed):
    """The same pipeline in both packages: the port's transforms share
    one RandomState seeded as the reference's global one is."""
    g = np.random.RandomState(seed)
    mean, std = [120.0, 110.0, 100.0], [60.0, 50.0, 40.0]

    def build(T, **kw):
        return T.Compose([
            T.RandomResizedCrop(20, **kw), T.RandomHorizontalFlip(**kw),
            T.ColorJitter(0.4, 0.4, 0.4, **kw), T.RandomRotation(15, **kw),
            T.Transpose(), T.Normalize(mean, std),
            T.RandomErasing(prob=1.0, value="random", **kw),
            T.RandomVerticalFlip(**kw),
            T.BrightnessTransform(0.3, **kw),
            T.RandomAffine(10, translate=(0.1, 0.1), scale=(0.9, 1.1),
                           shear=(-5, 5, -5, 5), **kw),
            T.RandomPerspective(prob=1.0, **kw)])
    return build(jT), build(pT, generator=g)


def test_seeded_pipeline_array_for_array():
    """Three images through the seeded random pipeline, array for array:
    every draw the reference makes, the port makes in the same order."""
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (32, 40, 3)).astype(np.uint8)
            for _ in range(3)]
    jp, pp = _pipelines(5)
    np.random.seed(5)
    want = [jp(im) for im in imgs]
    got = [pp(im) for im in imgs]
    for g, w in zip(got, want):
        _close(g, w)


FUNCTIONAL = {
    "hflip": lambda T, a: T.hflip(a),
    "vflip": lambda T, a: T.vflip(a),
    "resize short side": lambda T, a: T.resize(a, 12),
    "pad reflect": lambda T, a: T.pad(a, (1, 2), padding_mode="reflect"),
    "crop": lambda T, a: T.crop(a, 2, 3, 8, 9),
    "center crop": lambda T, a: T.center_crop(a, 10),
    "grayscale": lambda T, a: T.to_grayscale(a, 3),
    "brightness": lambda T, a: T.adjust_brightness(a, 1.3),
    "contrast": lambda T, a: T.adjust_contrast(a, 0.7),
    "hue": lambda T, a: T.adjust_hue(a, 0.2),
    "affine": lambda T, a: T.affine(a, 20, (2, 1), 1.1, (5, 3),
                                    interpolation="bilinear"),
    "rotate": lambda T, a: T.rotate(a, 30),
    "perspective": lambda T, a: T.perspective(
        a, [[0, 0], [15, 0], [15, 13], [0, 13]],
        [[1, 2], [14, 0], [13, 12], [2, 13]]),
    "erase": lambda T, a: T.erase(a, 2, 3, 4, 5, 7),
    "to_tensor CHW": lambda T, a: T.to_tensor(a),
    "ToTensor HWC": lambda T, a: T.ToTensor("HWC")(a),
    "Grayscale": lambda T, a: T.Grayscale()(a),
    "Pad": lambda T, a: T.Pad(2, fill=3)(a),
    "Resize CHW": lambda T, a: T.Resize((9, 21))(a.transpose(2, 0, 1)),
    "Resize HW": lambda T, a: T.Resize(7)(a[..., 0]),
    "SaturationTransform": lambda T, a: T.SaturationTransform(0.0)(a),
}


@pytest.mark.parametrize("name", list(FUNCTIONAL))
def test_functional_transforms(name):
    a = np.random.RandomState(1).randint(0, 256, (14, 16, 3)) \
        .astype(np.uint8)
    got = FUNCTIONAL[name](pT, a)
    want = FUNCTIONAL[name](jT, a)
    _close(got, want)
    if not isinstance(got, torch.Tensor):
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_random_transforms_from_a_torch_generator():
    """A ``torch.Generator`` feeds the draws as well: equal seeds, equal
    arrays (the default is a CPU generator seeded with 0)."""
    a = np.random.RandomState(2).rand(3, 18, 22).astype(np.float32)

    def run(gen):
        return pT.Compose([pT.RandomCrop(12, padding=2, generator=gen),
                           pT.HueTransform(0.1, generator=gen),
                           pT.ContrastTransform(0.5, generator=gen),
                           pT.SaturationTransform(0.5, generator=gen)])(a)
    one = run(torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(one, run(torch.Generator().manual_seed(3)))
    np.testing.assert_array_equal(
        pT.RandomCrop(12)(a), pT.RandomCrop(
            12, generator=torch.Generator().manual_seed(0))(a))


# -- datasets -------------------------------------------------------------------

def _idx(path, magic, dims, data):
    head = magic.to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in dims)
    with gzip.open(path, "wb") as f:
        f.write(head + data.tobytes())


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_idx(tmp_path, cls):
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    _idx(tmp_path / "img.gz", 2051, (5, 28, 28), imgs)
    _idx(tmp_path / "lab.gz", 2049, (5,), labels)
    kw = dict(image_path=str(tmp_path / "img.gz"),
              label_path=str(tmp_path / "lab.gz"))
    p, j = getattr(pds, cls)(**kw), getattr(jds, cls)(**kw)
    assert len(p) == len(j) == 5
    for i in range(5):
        for a, b in zip(p[i], j[i]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    with pytest.raises(RuntimeError, match="download"):
        getattr(pds, cls)(download=True)


@pytest.mark.parametrize("cls,members,key", [
    ("Cifar10", ("data_batch_1", "data_batch_2", "test_batch"), b"labels"),
    ("Cifar100", ("train", "test"), b"fine_labels")])
def test_cifar_tarball(tmp_path, cls, members, key):
    rng = np.random.RandomState(4)
    path = tmp_path / "cifar.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        for m in members:
            d = {b"data": rng.randint(0, 256, (3, 3072)).astype(np.uint8),
                 key: rng.randint(0, 10, 3).tolist()}
            raw = pickle.dumps(d)
            info = tarfile.TarInfo(f"cifar/{m}")
            info.size = len(raw)
            tar.addfile(info, io.BytesIO(raw))
    for mode in ("train", "test"):
        p = getattr(pds, cls)(data_file=str(path), mode=mode,
                              transform=pT.Normalize(127.5, 127.5))
        j = getattr(jds, cls)(data_file=str(path), mode=mode,
                              transform=jT.Normalize(127.5, 127.5))
        assert len(p) == len(j)
        for i in range(len(p)):
            for a, b in zip(p[i], j[i]):
                np.testing.assert_array_equal(a, b)


def test_image_folder_and_dataset_folder(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(5)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for k in range(2):
            Image.fromarray(rng.randint(0, 256, (6, 5, 3), np.uint8)).save(
                tmp_path / cls / f"{k}.png")
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    assert pds.has_valid_extension("a.PNG") and not \
        pds.has_valid_extension("a.txt")
    assert pds.make_dataset(str(tmp_path), {"cat": 0, "dog": 1},
                            extensions=pds.IMG_EXTENSIONS) == \
        jds.make_dataset(str(tmp_path), {"cat": 0, "dog": 1},
                         extensions=jds.IMG_EXTENSIONS)
    for P, J in ((pds.DatasetFolder, jds.DatasetFolder),
                 (pds.ImageFolder, jds.ImageFolder)):
        p, j = P(str(tmp_path)), J(str(tmp_path))
        assert len(p) == len(j) == 4 and p.samples == j.samples
        for i in range(4):
            for a, b in zip(p[i], j[i]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pds.DatasetFolder(str(tmp_path)).classes == ["cat", "dog"]
    np.testing.assert_array_equal(
        pds.default_loader(str(tmp_path / "cat" / "0.png"), "cv2"),
        jds.default_loader(str(tmp_path / "cat" / "0.png"), "cv2"))


def test_fake_voc_and_flowers(tmp_path):
    """``FakeImageDataset`` from its seed; ``VOC2012`` and ``Flowers``
    read from tarballs (and .mat files) written here."""
    import scipy.io
    from PIL import Image

    p, j = pds.FakeImageDataset(6, (3, 8, 8), 4, seed=2), \
        jds.FakeImageDataset(6, (3, 8, 8), 4, seed=2)
    for i in range(6):
        for a, b in zip(p[i], j[i]):
            np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(6)

    def add(tar, name, raw):
        info = tarfile.TarInfo(name)
        info.size = len(raw)
        tar.addfile(info, io.BytesIO(raw))

    def png(shape, mode=None):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 20, shape, np.uint8), mode).save(
            buf, "PNG")
        return buf.getvalue()

    voc = tmp_path / "voc.tar"
    with tarfile.open(voc, "w") as tar:
        add(tar, "VOCdevkit/VOC2012/ImageSets/Segmentation/trainval.txt",
            b"a\nb\n")
        for n in "ab":
            add(tar, f"VOCdevkit/VOC2012/JPEGImages/{n}.jpg", png((5, 6, 3)))
            add(tar, f"VOCdevkit/VOC2012/SegmentationClass/{n}.png",
                png((5, 6)))
    p, j = pds.VOC2012(str(voc)), jds.VOC2012(str(voc))
    assert len(p) == len(j) == 2
    for a, b in zip(p[1], j[1]):
        np.testing.assert_array_equal(a, b)
    flowers = tmp_path / "102flowers.tgz"
    with tarfile.open(flowers, "w:gz") as tar:
        for k in (1, 2, 3):
            add(tar, "jpg/image_%05d.jpg" % k, png((4, 5, 3)))
    scipy.io.savemat(tmp_path / "labels.mat",
                     {"labels": np.array([[7, 8, 9]])})
    scipy.io.savemat(tmp_path / "setid.mat",
                     {"tstid": np.array([[3, 1]]), "trnid": np.array([[2]]),
                      "valid": np.array([[1]])})
    kw = dict(data_file=str(flowers), label_file=str(tmp_path / "labels.mat"),
              setid_file=str(tmp_path / "setid.mat"),
              transform=lambda im: np.asarray(im))
    p, j = pds.Flowers(**kw), jds.Flowers(**kw)
    assert len(p) == len(j) == 2
    for i in range(2):
        for a, b in zip(p[i], j[i]):
            np.testing.assert_array_equal(a, b)
