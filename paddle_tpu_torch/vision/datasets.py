"""Vision datasets of the port.  Counterpart of
``paddle_tpu/vision/datasets.py``, over local files only (no download
path): ``FakeImageDataset``; ``MNIST`` / ``FashionMNIST`` from idx files
(gzipped or not) and ``Cifar10`` / ``Cifar100`` from their official
tarballs, read as the reference reads them; the folder datasets
``DatasetFolder`` and ``ImageFolder`` with ``make_dataset``,
``has_valid_extension`` and ``default_loader``; ``VOC2012`` and
``Flowers`` from their local archives.  Samples are numpy arrays (or
what the loader and the transform return), as the reference's; PIL (and
scipy for ``Flowers``) is imported when an image is read.
"""
from __future__ import annotations

import gzip
import os
import pickle
import tarfile

import numpy as np

from ..io import Dataset


class FakeImageDataset(Dataset):
    """Deterministic random images + labels; stands in for real datasets in
    tests/benchmarks (the reference tests use fake readers the same way)."""

    def __init__(self, num_samples=128, image_shape=(3, 32, 32),
                 num_classes=10, seed=0, transform=None):
        rng = np.random.RandomState(seed)
        self.images = rng.rand(num_samples, *image_shape) \
            .astype(np.float32)
        self.labels = rng.randint(0, num_classes,
                                  size=(num_samples, 1)).astype(np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = self.images[i]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[i]


def _read_idx_images(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    if magic != 2051:
        raise ValueError(f"{path}: not an IDX image file (magic {magic})")
    n = int.from_bytes(data[4:8], "big")
    rows = int.from_bytes(data[8:12], "big")
    cols = int.from_bytes(data[12:16], "big")
    arr = np.frombuffer(data, np.uint8, offset=16)
    return arr.reshape(n, rows, cols)


def _read_idx_labels(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    if magic != 2049:
        raise ValueError(f"{path}: not an IDX label file (magic {magic})")
    return np.frombuffer(data, np.uint8, offset=8)


class MNIST(Dataset):
    """Reference mnist.py: idx-format images/labels; mode train|test.
    Files must exist locally (image_path/label_path)."""

    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        if download:
            raise RuntimeError(
                f"{self.NAME}: download is not supported; pass local "
                "image_path/label_path")
        if image_path is None or label_path is None:
            raise ValueError(
                f"{self.NAME}: image_path and label_path are required "
                "(there is no download)")
        for p in (image_path, label_path):
            if not os.path.exists(p):
                raise FileNotFoundError(p)
        self.images = _read_idx_images(image_path)
        self.labels = _read_idx_labels(label_path)
        if len(self.images) != len(self.labels):
            raise ValueError("image/label count mismatch")
        self.mode = mode
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = self.images[i].astype(np.float32)[None]  # [1, 28, 28]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([self.labels[i]], np.int64)


class FashionMNIST(MNIST):
    """Reference fashion-mnist (same idx format)."""

    NAME = "fashion-mnist"


class Cifar10(Dataset):
    """Reference cifar.py: the python-pickle batches inside the official
    tar.gz; mode train|test."""

    _train_members = [f"data_batch_{i}" for i in range(1, 6)]
    _test_members = ["test_batch"]
    _label_key = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if download:
            raise RuntimeError(
                "Cifar: download is not supported; pass a local data_file "
                "tar.gz")
        if data_file is None:
            raise ValueError("Cifar: data_file (the official tar.gz) is "
                             "required")
        wanted = self._train_members if mode == "train" \
            else self._test_members
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tar:
            for m in tar.getmembers():
                base = os.path.basename(m.name)
                if base in wanted:
                    d = pickle.load(tar.extractfile(m), encoding="bytes")
                    images.append(np.asarray(d[b"data"], np.uint8))
                    labels.append(np.asarray(d[self._label_key],
                                             np.int64))
        if not images:
            raise ValueError(f"no {mode} batches found in {data_file}")
        self.images = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.labels = np.concatenate(labels)
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = self.images[i].astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([self.labels[i]], np.int64)


class Cifar100(Cifar10):
    _train_members = ["train"]
    _test_members = ["test"]
    _label_key = b"fine_labels"


# -- folder datasets (reference vision/datasets/folder.py) -------------------

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                  ".tif", ".tiff", ".webp")


def has_valid_extension(filename, extensions=IMG_EXTENSIONS):
    """reference folder.py has_valid_extension."""
    return filename.lower().endswith(tuple(extensions))


def default_loader(path, backend="pil"):
    """reference folder.py default_loader: a PIL RGB image (``backend=
    "cv2"``: its numpy array in BGR order, read through PIL)."""
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f)
        img = img.convert("RGB")
    if backend == "cv2":
        return np.asarray(img)[:, :, ::-1]  # BGR like cv2.imread
    return img


def make_dataset(directory, class_to_idx, extensions=None,
                 is_valid_file=None):
    """reference folder.py make_dataset: walk class subdirs, return
    (path, class_index) samples."""
    if (extensions is None) == (is_valid_file is None):
        raise ValueError("both extensions and is_valid_file cannot be "
                         "None or not None at the same time")
    if is_valid_file is None:
        def is_valid_file(p):
            return has_valid_extension(p, extensions)

    instances = []
    directory = os.path.expanduser(directory)
    for target_class in sorted(class_to_idx.keys()):
        class_index = class_to_idx[target_class]
        target_dir = os.path.join(directory, target_class)
        if not os.path.isdir(target_dir):
            continue
        for root, _, fnames in sorted(os.walk(target_dir,
                                              followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(root, fname)
                if is_valid_file(path):
                    instances.append((path, class_index))
    return instances


class DatasetFolder(Dataset):
    """Generic folder-of-class-subfolders dataset (reference
    vision/datasets/folder.py:90): root/class_x/xxx.png."""

    def __init__(self, root, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        classes, class_to_idx = self._find_classes(root)
        samples = make_dataset(root, class_to_idx, extensions,
                               is_valid_file)
        if len(samples) == 0:
            raise RuntimeError(
                f"Found 0 files in subfolders of: {root}\n"
                f"Supported extensions are: "
                f"{','.join(extensions or [])}")
        self.loader = loader if loader is not None else default_loader
        self.extensions = extensions
        self.classes = classes
        self.class_to_idx = class_to_idx
        self.samples = samples
        self.targets = [s[1] for s in samples]
        self.dtype = "float32"

    @staticmethod
    def _find_classes(directory):
        classes = sorted(e.name for e in os.scandir(directory)
                         if e.is_dir())
        if not classes:
            raise FileNotFoundError(
                f"Couldn't find any class folder in {directory}.")
        return classes, {c: i for i, c in enumerate(classes)}

    def __getitem__(self, index):
        path, target = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat/recursive folder of images, no labels (reference
    vision/datasets/folder.py:342)."""

    def __init__(self, root, loader=None, extensions=None,
                 transform=None, is_valid_file=None):
        self.root = root
        self.transform = transform
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        if is_valid_file is None:
            def is_valid_file(p):
                return has_valid_extension(p, extensions)
        samples = []
        for r, _, fnames in sorted(os.walk(root, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(r, fname)
                if is_valid_file(path):
                    samples.append(path)
        if len(samples) == 0:
            raise RuntimeError(
                f"Found 0 files in subfolders of: {root}\n"
                f"Supported extensions are: "
                f"{','.join(extensions or [])}")
        self.loader = loader if loader is not None else default_loader
        self.extensions = extensions
        self.samples = samples
        self.dtype = "float32"

    def __getitem__(self, index):
        path = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)


class VOC2012(Dataset):
    """VOC2012 segmentation from the devkit tar (reference
    vision/datasets/voc2012.py; pass data_file, there is no download)."""

    MODE_FLAG_MAP = {"train": "trainval", "test": "train",
                     "valid": "val"}
    SET_FILE = ("VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt")
    DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if mode.lower() not in ("train", "valid", "test"):
            raise AssertionError(
                f"mode should be 'train', 'valid' or 'test', "
                f"but got {mode}")
        if data_file is None:
            raise ValueError(
                "data_file must point at the local VOCtrainval tar "
                "(there is no download)")
        self.flag = self.MODE_FLAG_MAP[mode.lower()]
        self.data_file = data_file
        self.transform = transform
        self._load_anno()
        self.dtype = "float32"

    def _load_anno(self):
        self.name2mem = {}
        self.data_tar = tarfile.open(self.data_file)
        for ele in self.data_tar.getmembers():
            self.name2mem[ele.name] = ele
        set_file = self.SET_FILE.format(self.flag)
        sets = self.data_tar.extractfile(self.name2mem[set_file])
        self.data = []
        self.labels = []
        for line in sets:
            line = line.strip().decode("utf-8")
            self.data.append(self.DATA_FILE.format(line))
            self.labels.append(self.LABEL_FILE.format(line))

    def __getitem__(self, idx):
        from PIL import Image

        data_file = self.data[idx]
        label_file = self.labels[idx]
        data = np.asarray(Image.open(
            self.data_tar.extractfile(self.name2mem[data_file])))
        label = np.asarray(Image.open(
            self.data_tar.extractfile(self.name2mem[label_file])))
        if self.transform is not None:
            data = self.transform(data)
        return data.astype(self.dtype), label.astype("int64")

    def __len__(self):
        return len(self.data)


class Flowers(Dataset):
    """Oxford 102 flowers (reference vision/datasets/flowers.py; pass
    data_file/label_file/setid_file, there is no download)."""

    # train uses the (larger) tstid split, mirroring the reference
    # flowers.py:51 MODE_FLAG_MAP.
    MODE_FLAG_MAP = {"train": "tstid", "test": "trnid",
                     "valid": "valid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None):
        if mode.lower() not in ("train", "valid", "test"):
            raise AssertionError(
                f"mode should be 'train', 'valid' or 'test', "
                f"but got {mode}")
        if not (data_file and label_file and setid_file):
            raise ValueError(
                "data_file, label_file and setid_file must point at "
                "local copies (there is no download)")
        if backend is None:
            backend = "pil"
        if backend not in ("pil", "cv2"):
            raise ValueError(
                f"Expected backend are one of ['pil', 'cv2'], "
                f"but got {backend}")
        import scipy.io as sio

        self.backend = backend
        self.flag = self.MODE_FLAG_MAP[mode.lower()]
        self.transform = transform
        self.data_tar = tarfile.open(data_file)
        self.name2mem = {e.name: e for e in self.data_tar.getmembers()}
        self.labels = sio.loadmat(label_file)["labels"][0]
        self.indexes = sio.loadmat(setid_file)[self.flag][0]
        self.dtype = "float32"

    def __getitem__(self, idx):
        from PIL import Image

        index = int(self.indexes[idx])
        label = int(self.labels[index - 1])
        img_name = "jpg/image_%05d.jpg" % index
        # pil backend hands the transform a PIL Image, matching the
        # reference flowers.py (cv2 gets a BGR ndarray).
        img = Image.open(
            self.data_tar.extractfile(self.name2mem[img_name]))
        if self.backend == "cv2":
            img = np.asarray(img)[:, :, ::-1]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.array([label]).astype("int64")

    def __len__(self):
        return len(self.indexes)
