"""Image utilities, augmenters and ImageIter (ref:
``mxnet_tpu/image/image.py``; python/mxnet/image/image.py).

Images are HWC NDArrays on ``cpu()``: decoding, resizing and every
augmenter run on the host and return host arrays, whatever the default
context is, so no sample reaches the card before its batch does.  The
decode and resizes are PIL (imported when called), the arithmetic is torch
on the CPU tensor, and the random augmenters draw from numpy's global
stream, as in the JAX package.  ``ImageIter`` hands its batches to the
context it was built in (the innermost ``with`` context, else ``gpu(0)``),
as the ``io`` iterators do.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray


def _t(src):
    """The CPU tensor of an image (NDArray, tensor or array-like)."""
    if isinstance(src, NDArray):
        src = src.data
    if isinstance(src, torch.Tensor):
        return src.detach().cpu()
    return torch.from_numpy(np.array(src))


def _host(t):
    """A CPU tensor or numpy array as an NDArray on ``cpu()``."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.array(t))
    return NDArray(t, cpu())


def _np(src):
    return _t(src).numpy()


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an encoded image buffer to an HWC uint8 NDArray on ``cpu()``
    (ref: mx.image.imdecode)."""
    import io

    from PIL import Image

    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    img = Image.open(io.BytesIO(bytes(buf)))
    img = img.convert("RGB") if flag else img.convert("L")
    arr = np.array(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return _host(arr)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    from PIL import Image

    arr = _np(src).astype(np.uint8)
    squeeze = arr.shape[-1] == 1
    pil = Image.fromarray(arr[..., 0] if squeeze else arr)
    out = np.asarray(pil.resize((w, h)))
    if squeeze:
        out = out[..., None]
    return _host(out.astype(np.uint8))


def resize_short(src, size, interp=1):
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    out = _host(_t(src)[y0:y0 + h, x0:x0 + w])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=1):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    return fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size,
                      interp), (x0, y0, new_w, new_h)


def random_crop(src, size, interp=1):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = np.random.randint(0, w - new_w + 1)
    y0 = np.random.randint(0, h - new_h + 1)
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=1, **kwargs):
    """Random area/aspect crop resized to `size` (ref:
    mx.image.random_size_crop)."""
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = np.random.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(np.random.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = np.random.randint(0, w - new_w + 1)
            y0 = np.random.randint(0, h - new_h + 1)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    t = _t(src)
    if t.dtype == torch.uint8:
        t = t.to(torch.float32)
    out = t - _t(mean)
    if std is not None:
        out = out / _t(std)
    return _host(out)


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return resize_short(src, self.size)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return center_crop(src, self.size)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return random_crop(src, self.size)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if np.random.rand() < self.p:
            return _host(torch.flip(_t(src), (1,)))
        return src


class CastAug(Augmenter):
    def __call__(self, src):
        return _host(_t(src).to(torch.float32))


class SequentialAug(Augmenter):
    """Apply augmenters in order (ref: SequentialAug)."""

    def __init__(self, ts):
        self._ts = list(ts)

    def __call__(self, src):
        for t in self._ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    """Apply augmenters in a random order (ref: RandomOrderAug); the order
    comes from Python's ``random`` module, as in the JAX package."""

    def __init__(self, ts):
        self._ts = list(ts)

    def __call__(self, src):
        import random as _pyrandom

        order = list(self._ts)
        _pyrandom.shuffle(order)
        for t in order:
            src = t(src)
        return src


class RandomSizedCropAug(Augmenter):
    """Ref: mx.image.RandomSizedCropAug (ImageNet training crop)."""

    def __init__(self, size, area, ratio, interp=1):
        super().__init__(size=size, area=area, ratio=ratio)
        self.size, self.area, self.ratio, self.interp = (size, area, ratio,
                                                         interp)

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


_GRAY_COEF = np.array([[0.299], [0.587], [0.114]], np.float32)

# ImageNet statistics (ref: CreateAugmenter defaults)
IMAGENET_MEAN = np.array([123.68, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)
IMAGENET_PCA_EIGVAL = np.array([55.46, 4.794, 1.148], np.float32)
IMAGENET_PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                                [-0.5808, -0.0045, -0.8140],
                                [-0.5836, -0.6948, 0.4203]], np.float32)


class BrightnessJitterAug(Augmenter):
    """Ref: mx.image.BrightnessJitterAug."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.brightness, self.brightness)
        return _host(_t(src) * alpha)


class ContrastJitterAug(Augmenter):
    """Ref: mx.image.ContrastJitterAug."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.contrast, self.contrast)
        t = _t(src)
        gray = t.numpy() @ _GRAY_COEF
        # reference offset reduces to (1-alpha) * mean luminance, which
        # preserves a uniform image's level under pure contrast change
        offset = (1.0 - alpha) * float(gray.mean())
        return _host(t * alpha + offset)


class SaturationJitterAug(Augmenter):
    """Ref: mx.image.SaturationJitterAug."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.saturation, self.saturation)
        t = _t(src)
        gray = (t.numpy() @ _GRAY_COEF) * (1.0 - alpha)
        return _host(t * alpha + torch.from_numpy(
            np.asarray(gray, np.float32)))


class HueJitterAug(Augmenter):
    """Hue rotation in YIQ space (ref: mx.image.HueJitterAug)."""

    _tyiq = np.array([[0.299, 0.587, 0.114],
                      [0.596, -0.274, -0.321],
                      [0.211, -0.523, 0.311]], np.float32)
    _ityiq = np.array([[1.0, 0.956, 0.621],
                       [1.0, -0.272, -0.647],
                       [1.0, -1.107, 1.705]], np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = np.random.uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], np.float32)
        t = (self._ityiq @ bt @ self._tyiq).T
        return _host(np.asarray(_np(src) @ t, np.float32))


class ColorJitterAug(RandomOrderAug):
    """Ref: mx.image.ColorJitterAug — random-order B/C/S jitter."""

    def __init__(self, brightness, contrast, saturation):
        augs = []
        if brightness > 0:
            augs.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            augs.append(ContrastJitterAug(contrast))
        if saturation > 0:
            augs.append(SaturationJitterAug(saturation))
        super().__init__(augs)


class LightingAug(Augmenter):
    """PCA-based RGB lighting noise (ref: mx.image.LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha) @ self.eigval
        return _host(_t(src) + torch.from_numpy(rgb.astype(np.float32)))


class RandomGrayAug(Augmenter):
    """Randomly convert to 3-channel gray (ref: mx.image.RandomGrayAug)."""

    _mat = np.array([[0.21, 0.21, 0.21],
                     [0.72, 0.72, 0.72],
                     [0.07, 0.07, 0.07]], np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if np.random.random() < self.p:
            return _host(np.asarray(_np(src) @ self._mat, np.float32))
        return src


class ColorNormalizeAug(Augmenter):
    """mean/std normalization augmenter (ref: ColorNormalizeAug)."""

    def __init__(self, mean, std):
        self._mean = mean
        self._std = std

    def __call__(self, src):
        return color_normalize(src, self._mean, self._std)


class ForceResizeAug(Augmenter):
    """Resize to an exact (w, h), ignoring aspect (ref: ForceResizeAug)."""

    def __init__(self, size, interp=2):
        self._size = size
        self._interp = interp

    def __call__(self, src):
        return imresize(src, self._size[0], self._size[1],
                        interp=self._interp)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2, **kwargs):
    """Ref: mx.image.CreateAugmenter."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size))
    else:
        auglist.append(CenterCropAug(crop_size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, IMAGENET_PCA_EIGVAL,
                                   IMAGENET_PCA_EIGVEC))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is not None or std is not None:
        mean, std = _resolve_mean_std(mean, std)
        auglist.append(ColorNormalizeAug(_host(mean), _host(std)))
    return auglist


def _resolve_mean_std(mean, std):
    """mean=True/std=True select the ImageNet constants (ref behavior)."""
    mean = np.asarray(IMAGENET_MEAN if mean is True
                      else (mean if mean is not None else [0, 0, 0]),
                      np.float32)
    std = np.asarray(IMAGENET_STD if std is True
                     else (std if std is not None else [1, 1, 1]),
                     np.float32)
    return mean, std


def _resize_float(arr, w, h):
    """Bilinear resize that preserves float values (PIL mode-F per
    channel) — imresize casts to uint8, which corrupts normalized
    data."""
    from PIL import Image

    chans = [np.asarray(Image.fromarray(arr[..., c].astype(np.float32),
                                        mode="F")
                        .resize((w, h), Image.Resampling.BILINEAR))
             for c in range(arr.shape[2])]
    return np.stack(chans, axis=2)


class ImageIter:
    """Python image iterator over .lst/.rec (ref: mx.image.ImageIter).  In
    ``rec`` mode it is an ``io.ImageRecordIter``; in ``list`` mode it reads
    and augments the listed files on the calling thread."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, **kwargs):
        from ..io.io import DataBatch, _built_ctx

        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self._db = DataBatch
        self._ctx = _built_ctx()
        if path_imgrec:
            from ..io.io import ImageRecordIter

            self._rec_iter = ImageRecordIter(
                path_imgrec=path_imgrec, data_shape=data_shape,
                batch_size=batch_size, shuffle=shuffle, **kwargs)
            self._mode = "rec"
        elif path_imglist:
            self._items = []
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    self._items.append((float(parts[1]),
                                        os.path.join(path_root, parts[-1])))
            self._aug = aug_list if aug_list is not None else \
                CreateAugmenter((data_shape[0], data_shape[1],
                                 data_shape[2]))
            self._shuffle = shuffle
            self._order = list(range(len(self._items)))
            self._pos = 0
            self._mode = "list"
        else:
            raise MXNetError("need path_imgrec or path_imglist")

    def __iter__(self):
        return self

    def reset(self):
        if self._mode == "rec":
            self._rec_iter.reset()
        else:
            self._pos = 0
            if self._shuffle:
                np.random.shuffle(self._order)

    def __next__(self):
        return self.next()

    def next(self):
        if self._mode == "rec":
            return self._rec_iter.next()
        if self._pos + self.batch_size > len(self._items):
            raise StopIteration
        c, h, w = self.data_shape
        data = np.empty((self.batch_size, c, h, w), np.float32)
        labels = np.empty((self.batch_size,), np.float32)
        for i in range(self.batch_size):
            label, path = self._items[self._order[self._pos]]
            self._pos += 1
            img = imread(path, flag=1 if c == 3 else 0)
            for aug in self._aug:
                img = aug(img)
            labels[i] = label
            data[i] = img.asnumpy().transpose(2, 0, 1)
        return self._db([_nd.array(data, ctx=self._ctx)],
                        [_nd.array(labels, ctx=self._ctx)])
