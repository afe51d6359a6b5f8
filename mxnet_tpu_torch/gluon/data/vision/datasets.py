"""Vision datasets (ref: ``mxnet_tpu/gluon/data/vision/datasets.py``).

No network egress: datasets read local files only (pass ``root`` pointing
at the raw files, gz or not); when they are missing, ``synthetic=True``
gives a deterministic random stand-in for smoke tests.  The arrays sit on
``cpu()``: a sample is sliced and transformed on the host, and batches
reach the card through ``prefetch_to_device`` or the training loop.
Whatever decodes images (``ImageRecordDataset``, ``ImageFolderDataset``)
imports PIL when it reads a sample, as the JAX package does.
"""
from __future__ import annotations

import os

import numpy as np

from ....base import MXNetError
from ....context import cpu
from ....ndarray import ndarray as _nd
from ..dataset import Dataset


def _host(arr, dtype=None):
    return _nd.array(arr, ctx=cpu(), dtype=dtype)


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        data = _nd.NDArray(self._data.data[idx], self._data.context)
        if self._transform is not None:
            return self._transform(data, self._label[idx])
        return data, self._label[idx]

    def _make_synthetic(self, image_shape, num_classes, seed):
        """Shared no-egress fallback: deterministic random images."""
        n = 1024 if self._train else 256
        rng = np.random.RandomState(seed)
        data = rng.randint(0, 255, (n,) + image_shape).astype(np.uint8)
        self._data = _host(data, dtype=np.uint8)
        self._label = rng.randint(0, num_classes, n).astype(np.int32)

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local idx files (ref: gluon.data.vision.MNIST)."""

    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None, synthetic=False):
        self._synthetic = synthetic
        super().__init__(root, train, transform)

    def _get_data(self):
        from ....io.io import _read_idx_images, _read_idx_labels

        img, lbl = self._files[self._train]
        img_path = os.path.join(self._root, img)
        lbl_path = os.path.join(self._root, lbl)
        if not (os.path.exists(img_path) or os.path.exists(img_path + ".gz")):
            if self._synthetic:
                self._make_synthetic((28, 28, 1), 10, 42)
                return
            raise MXNetError(
                f"MNIST raw files not found under {self._root} "
                "(no network egress; place idx files there or pass "
                "synthetic=True)")
        if os.path.exists(img_path + ".gz"):
            img_path += ".gz"
            lbl_path += ".gz"
        images = _read_idx_images(img_path)
        labels = _read_idx_labels(lbl_path).astype(np.int32)
        self._data = _host(images[..., None], dtype=np.uint8)
        self._label = labels


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None, synthetic=False):
        super().__init__(root, train, transform, synthetic)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the local python-pickle batches (ref:
    gluon.data.vision.CIFAR10)."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None, synthetic=False):
        self._synthetic = synthetic
        super().__init__(root, train, transform)

    def _get_data(self):
        import pickle

        base = os.path.join(self._root, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]
        if not os.path.exists(base):
            if self._synthetic:
                self._make_synthetic((32, 32, 3), 10, 7)
                return
            raise MXNetError(
                f"CIFAR10 batches not found under {base} (no egress)")
        xs, ys = [], []
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"].reshape(-1, 3, 32, 32)
                      .transpose(0, 2, 3, 1))
            ys.append(np.asarray(d[b"labels"], np.int32))
        self._data = _host(np.concatenate(xs), dtype=np.uint8)
        self._label = np.concatenate(ys)


class CIFAR100(CIFAR10):
    """CIFAR100 (ref: gluon.data.vision.CIFAR100); ``fine_label=False``
    gives the 20 coarse labels."""

    def __init__(self, root="~/.mxnet/datasets/cifar100",
                 fine_label=False, train=True, transform=None,
                 synthetic=False):
        self._fine = fine_label
        super().__init__(root=root, train=train, transform=transform,
                         synthetic=synthetic)

    def _get_data(self):
        import pickle

        base = os.path.join(self._root, "cifar-100-python")
        if not os.path.exists(base):
            if self._synthetic:
                self._make_synthetic((32, 32, 3),
                                     100 if self._fine else 20, 11)
                return
            raise MXNetError(
                f"CIFAR100 batches not found under {base} (no egress)")
        fn = "train" if self._train else "test"
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        key = b"fine_labels" if self._fine else b"coarse_labels"
        self._data = _host(
            d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
            dtype=np.uint8)
        self._label = np.asarray(d[key], np.int32)


class ImageRecordDataset(Dataset):
    """Image dataset over a .rec file (ref: vision.ImageRecordDataset);
    records are decoded with PIL (``recordio.unpack_img``)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset

        self._rec = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._rec)

    def __getitem__(self, idx):
        from ....io import recordio as rio

        header, img = rio.unpack_img(self._rec[idx], iscolor=self._flag)
        label = header.label if np.isscalar(header.label) \
            else header.label[0]
        data = _host(img if img.ndim == 3 else img[..., None],
                     dtype=np.uint8)
        if self._transform is not None:
            return self._transform(data, label)
        return data, np.float32(label)


class ImageFolderDataset(Dataset):
    """Folder-of-class-folders dataset (ref: vision.ImageFolderDataset);
    images are decoded with PIL."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fn in sorted(os.listdir(path)):
                if fn.lower().endswith(exts):
                    self.items.append((os.path.join(path, fn), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from PIL import Image

        path, label = self.items[idx]
        img = Image.open(path)
        img = img.convert("RGB") if self._flag else img.convert("L")
        arr = np.asarray(img)
        data = _host(arr if arr.ndim == 3 else arr[..., None],
                     dtype=np.uint8)
        if self._transform is not None:
            return self._transform(data, label)
        return data, np.float32(label)
