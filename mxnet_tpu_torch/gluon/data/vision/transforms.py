"""Vision transforms (ref: ``mxnet_tpu/gluon/data/vision/transforms.py``).

Transforms are blocks over HWC uint8/float images (MXNet's convention):
``ToTensor`` turns them into CHW float32 in [0, 1].  An NDArray comes back
as an NDArray on its own context (the datasets' samples are on
``cpu()``); the arithmetic runs in torch on its tensor.  Random
transforms draw from numpy's global stream, as in the JAX package.
``Resize``, ``RandomResizedCrop`` and ``CropResize`` import PIL when
called; ``RandomGray`` and ``CropResize`` run through the image tier
(``image/``), whose results are NDArrays on ``cpu()``.
"""
from __future__ import annotations

import numpy as np
import torch

from ....base import MXNetError
from ....ndarray import ndarray as _nd
from ....ndarray.ndarray import NDArray
from ...block import Block, HybridBlock


def _t(x):
    """The tensor of an NDArray, tensor or array-like."""
    if isinstance(x, NDArray):
        return x.data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _like(t, x):
    """``t`` wrapped as ``x`` was: an NDArray on x's context, or a tensor."""
    if isinstance(x, NDArray):
        return NDArray(t, x.context)
    return t


class Compose(Block):
    """Apply transforms in order (ref: transforms.Compose)."""

    def __init__(self, transforms):
        super().__init__()
        self._steps = list(transforms)
        for i, t in enumerate(self._steps):
            if isinstance(t, torch.nn.Module):
                self.register_child(t, str(i))

    def forward(self, x):
        for t in self._steps:
            x = t(x)
        return x


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = _nd.to_torch_dtype(dtype)

    def hybrid_forward(self, F, x):
        return x.to(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (ref: ToTensor); a 4-D NHWC
    batch -> NCHW.  The scaling multiplies by the float32 reciprocal of
    255, as the JAX package's compiled ``/ 255.0`` does (bit for bit)."""

    def hybrid_forward(self, F, x):
        x = x.to(torch.float32)
        if x.ndim == 4:
            return x.permute(0, 3, 1, 2) * (1.0 / 255.0)
        return x.permute(2, 0, 1) * (1.0 / 255.0)


class Normalize(HybridBlock):
    """Channel-wise (x - mean)/std on CHW input (ref: Normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = torch.from_numpy(
            np.asarray(mean, np.float32).reshape(-1, 1, 1))
        self._std = torch.from_numpy(
            np.asarray(std, np.float32).reshape(-1, 1, 1))

    def hybrid_forward(self, F, x):
        if self._mean.device != x.device:
            self._mean = self._mean.to(x.device)
            self._std = self._std.to(x.device)
        return (x - self._mean) / self._std


class Resize(Block):
    """Resize an HWC image (ref: Resize), through PIL."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._keep = keep_ratio

    def forward(self, x):
        from PIL import Image

        arr = _t(x).cpu().numpy().astype(np.uint8)
        squeeze = arr.shape[-1] == 1
        pil = Image.fromarray(arr[..., 0] if squeeze else arr)
        w, h = self._size
        if self._keep:
            scale = max(w / pil.size[0], h / pil.size[1])
            pil = pil.resize((int(round(pil.size[0] * scale)),
                              int(round(pil.size[1] * scale))))
        else:
            pil = pil.resize((w, h))
        out = np.asarray(pil)
        if squeeze:
            out = out[..., None]
        return _like(torch.from_numpy(out.copy()).to(_t(x).device), x)


class CenterCrop(Block):
    def __init__(self, size):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        w, h = self._size
        t = _t(x)
        ih, iw = t.shape[0], t.shape[1]
        y0, x0 = max((ih - h) // 2, 0), max((iw - w) // 2, 0)
        return _like(t[y0:y0 + h, x0:x0 + w], x)


class RandomCrop(Block):
    """Random-position crop, optionally zero-padding first (ref:
    transforms.RandomCrop)."""

    def __init__(self, size, pad=None):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size,
                                                                   size)
        self._pad = pad

    def forward(self, x):
        t = _t(x)
        if self._pad:
            p = self._pad
            t = torch.nn.functional.pad(t, (0, 0, p, p, p, p))
        w, h = self._size
        ih, iw = t.shape[0], t.shape[1]
        if ih < h or iw < w:
            raise MXNetError(
                f"RandomCrop: image ({ih}x{iw}) smaller than crop "
                f"({h}x{w}); use pad= or resize first")
        y0 = np.random.randint(0, ih - h + 1)
        x0 = np.random.randint(0, iw - w + 1)
        return _like(t[y0:y0 + h, x0:x0 + w], x)


class RandomGray(Block):
    """Randomly convert to 3-channel gray (ref: transforms.RandomGray)."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if np.random.rand() < self._p:
            from ....image.image import RandomGrayAug

            # keep the input dtype: the gray matmul promotes to float32,
            # and a stochastic dtype change breaks dtype-sensitive
            # consumers downstream
            out = _t(RandomGrayAug(1.0)(x)).to(_t(x).dtype)
            return _like(out.to(_t(x).device), x)
        return x


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        from PIL import Image

        arr = _t(x).cpu().numpy().astype(np.uint8)
        squeeze = arr.shape[-1] == 1
        pil = Image.fromarray(arr[..., 0] if squeeze else arr)
        iw, ih = pil.size
        area = iw * ih
        for _ in range(10):
            target = area * np.random.uniform(*self._scale)
            ar = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if w <= iw and h <= ih:
                x0 = np.random.randint(0, iw - w + 1)
                y0 = np.random.randint(0, ih - h + 1)
                pil = pil.crop((x0, y0, x0 + w, y0 + h))
                break
        pil = pil.resize(self._size)
        out = np.asarray(pil)
        if squeeze:
            out = out[..., None]
        return _like(torch.from_numpy(out.copy()).to(_t(x).device), x)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _like(torch.flip(_t(x), [1]), x)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _like(torch.flip(_t(x), [0]), x)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        f = 1.0 + np.random.uniform(-self._b, self._b)
        return _like((_t(x).to(torch.float32) * f).clamp(0, 255), x)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        f = 1.0 + np.random.uniform(-self._c, self._c)
        xf = _t(x).to(torch.float32)
        mean = xf.mean()
        return _like(((xf - mean) * f + mean).clamp(0, 255), x)


class RandomSaturation(Block):
    _gray_w = np.array([0.299, 0.587, 0.114], np.float32)

    def __init__(self, saturation):
        super().__init__()
        self._s = saturation
        self._gw = torch.from_numpy(self._gray_w)

    def forward(self, x):
        f = 1.0 + np.random.uniform(-self._s, self._s)
        xf = _t(x).to(torch.float32)
        gray = (xf * self._gw.to(xf.device)).sum(dim=-1, keepdim=True)
        return _like((xf * f + gray * (1 - f)).clamp(0, 255), x)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._h = hue

    # the reference's YIQ transform matrices (image_random-inl.h)
    _t_yiq = np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], np.float32)
    _t_rgb = np.array([[1.0, 0.956, 0.621],
                       [1.0, -0.272, -0.647],
                       [1.0, -1.107, 1.705]], np.float32)

    def forward(self, x):
        theta = np.random.uniform(-self._h, self._h) * np.pi
        cs, sn = np.cos(theta), np.sin(theta)
        rot = np.array([[1, 0, 0], [0, cs, -sn], [0, sn, cs]],
                       np.float32)
        m = self._t_rgb @ rot @ self._t_yiq
        xf = _t(x).to(torch.float32)
        mt = torch.from_numpy(np.ascontiguousarray(m.T)).to(xf.device)
        return _like((xf.reshape(-1, 3) @ mt).reshape(xf.shape)
                     .clamp(0, 255), x)


class RandomColorJitter(Block):
    """brightness -> contrast -> saturation -> hue, each optional (ref:
    transforms.RandomColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._stages = []
        if brightness:
            self._stages.append(RandomBrightness(brightness))
        if contrast:
            self._stages.append(RandomContrast(contrast))
        if saturation:
            self._stages.append(RandomSaturation(saturation))
        if hue:
            self._stages.append(RandomHue(hue))

    def forward(self, x):
        for s in self._stages:
            x = s(x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA noise (ref: transforms.RandomLighting)."""

    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = np.random.normal(0, self._alpha, 3).astype(np.float32)
        noise = (self._eigvec * a * self._eigval).sum(axis=1)
        xf = _t(x).to(torch.float32)
        return _like((xf + torch.from_numpy(noise).to(xf.device))
                     .clamp(0, 255), x)


class CropResize(Block):
    """Crop (x, y, w, h) then optionally resize (ref:
    transforms.CropResize)."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._box = (x, y, width, height)
        self._size = size
        self._interp = interpolation

    def forward(self, data):
        from .... import image as _image

        x, y, w, h = self._box
        s = None
        if self._size:
            s = self._size if isinstance(self._size, (tuple, list)) \
                else (self._size, self._size)
        out = _image.fixed_crop(data, x, y, w, h, size=s,
                                interp=self._interp)
        return _like(out.data.to(_t(data).device), data)
