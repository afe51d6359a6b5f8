"""Detection image iterator + box-aware augmenters (ref:
``mxnet_tpu/image/detection.py``; python/mxnet/image/detection.py — `ImageDetIter`,
`DetHorizontalFlipAug`, `DetRandomCropAug`, `DetBorrowAug`,
`CreateDetAugmenter`. Labels are per-image 2-D float arrays
`(num_obj, obj_width)` with `[cls, xmin, ymin, xmax, ymax, ...]` in
normalized [0,1] coordinates; the packed on-disk layout (lst and
recordio) is `[header_width, obj_width, <header...>, obj0..., ...]`
exactly as `tools/im2rec.py --pack-label` writes it.  Images stay
NDArrays on ``cpu()`` through the augmenters (``image.image``); a batch
goes to the context the iterator was built in.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import ndarray as _nd
from .image import (Augmenter, CastAug, ColorJitterAug, HueJitterAug,
                    LightingAug, RandomGrayAug, _host, _t, imread, imresize)


class DetAugmenter:
    """Augmenter operating on (image, label) pairs."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the det pipeline
    (ref: mx.image.DetBorrowAug)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise MXNetError("DetBorrowAug needs an image Augmenter")
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one augmenter (or skip) — how the reference turns
    rand_crop/rand_pad fractions into probabilities
    (ref: mx.image.DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or np.random.random() < self.skip_prob:
            return src, label
        return self.aug_list[np.random.randint(len(self.aug_list))](
            src, label)


class DetRandomPadAug(DetAugmenter):
    """Random expansion padding; boxes shrink into the new canvas
    (ref: mx.image.DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = (max(area_range[0], 1.0), max(area_range[1], 1.0))
        self.max_attempts = max_attempts
        self.pad_val = np.asarray(pad_val, np.float32)

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        for _ in range(self.max_attempts):
            area = np.random.uniform(*self.area_range)
            ar = np.random.uniform(*self.aspect_ratio_range)
            nw, nh = int(w * np.sqrt(area * ar)), int(h * np.sqrt(area / ar))
            if nw >= w and nh >= h:
                break
        else:
            return src, label
        x0 = np.random.randint(0, nw - w + 1)
        y0 = np.random.randint(0, nh - h + 1)
        arr = src.asnumpy()
        canvas = np.empty((nh, nw, arr.shape[2]), arr.dtype)
        canvas[:] = self.pad_val.astype(arr.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = arr
        out = label.copy()
        valid = out[:, 0] >= 0
        out[valid, 1] = (out[valid, 1] * w + x0) / nw
        out[valid, 3] = (out[valid, 3] * w + x0) / nw
        out[valid, 2] = (out[valid, 2] * h + y0) / nh
        out[valid, 4] = (out[valid, 4] * h + y0) / nh
        return _host(canvas), out


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and x-coordinates (ref: mx.image.DetHorizontalFlipAug)."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if np.random.random() < self.p:
            src = _host(torch.flip(_t(src), (1,)))
            label = label.copy()
            valid = label[:, 0] >= 0
            xmin = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - xmin
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping objects whose center survives, with IoU-style
    coverage constraint (ref: mx.image.DetRandomCropAug)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.05, 1.0), max_attempts=50):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _coverage(self, boxes, crop):
        x0, y0, x1, y1 = crop
        ix0 = np.maximum(boxes[:, 0], x0)
        iy0 = np.maximum(boxes[:, 1], y0)
        ix1 = np.minimum(boxes[:, 2], x1)
        iy1 = np.minimum(boxes[:, 3], y1)
        inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return inter / np.maximum(area, 1e-12)

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        valid = label[:, 0] >= 0
        boxes = label[valid, 1:5]
        for _ in range(self.max_attempts):
            area = np.random.uniform(*self.area_range)
            ar = np.random.uniform(*self.aspect_ratio_range)
            cw = min(np.sqrt(area * ar), 1.0)
            ch = min(np.sqrt(area / ar), 1.0)
            cx = np.random.uniform(0, 1.0 - cw)
            cy = np.random.uniform(0, 1.0 - ch)
            crop = (cx, cy, cx + cw, cy + ch)
            if boxes.size == 0:
                break
            cov = self._coverage(boxes, crop)
            centers_x = (boxes[:, 0] + boxes[:, 2]) / 2
            centers_y = (boxes[:, 1] + boxes[:, 3]) / 2
            keep = ((centers_x > crop[0]) & (centers_x < crop[2])
                    & (centers_y > crop[1]) & (centers_y < crop[3]))
            if keep.any() and cov[keep].min() >= self.min_object_covered:
                break
        else:
            return src, label  # no acceptable crop found
        x0, y0 = int(crop[0] * w), int(crop[1] * h)
        cw_px = max(int((crop[2] - crop[0]) * w), 1)
        ch_px = max(int((crop[3] - crop[1]) * h), 1)
        from .image import fixed_crop

        src = fixed_crop(src, x0, y0, cw_px, ch_px)
        out = label.copy()
        if boxes.size:
            nb = boxes.copy()
            # re-express in crop coordinates, clip, drop centers outside
            nb[:, [0, 2]] = (nb[:, [0, 2]] - crop[0]) / (crop[2] - crop[0])
            nb[:, [1, 3]] = (nb[:, [1, 3]] - crop[1]) / (crop[3] - crop[1])
            nb = np.clip(nb, 0.0, 1.0)
            cxs = (nb[:, 0] + nb[:, 2]) / 2
            cys = (nb[:, 1] + nb[:, 3]) / 2
            dead = ~((cxs > 0) & (cxs < 1) & (cys > 0) & (cys < 1))
            vi = np.where(valid)[0]
            out[vi, 1:5] = nb
            out[vi[dead], 0] = -1.0
        return src, out


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, hue=0,
                       pca_noise=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50, **kwargs):
    """Ref: mx.image.CreateDetAugmenter. rand_crop / rand_pad are
    PROBABILITIES (fraction of images augmented), realized through
    DetRandomSelectAug exactly like the reference."""
    auglist = []
    if rand_crop > 0:
        crop = DetRandomCropAug(
            min_object_covered, aspect_ratio_range,
            (min(area_range[0], 1.0), min(area_range[1], 1.0)),
            max_attempts)
        auglist.append(DetRandomSelectAug([crop],
                                          skip_prob=1.0 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0),
                               max(area_range[1], 1.0)), max_attempts)
        auglist.append(DetRandomSelectAug([pad],
                                          skip_prob=1.0 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # geometric augs done: force to the final shape (boxes are
    # normalized, so a pure resize leaves labels untouched)
    from .image import ForceResizeAug

    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2],
                                                data_shape[1]),
                                               inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        from .image import IMAGENET_PCA_EIGVAL, IMAGENET_PCA_EIGVEC

        auglist.append(DetBorrowAug(LightingAug(
            pca_noise, IMAGENET_PCA_EIGVAL, IMAGENET_PCA_EIGVEC)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is not None or std is not None:
        from .image import ColorNormalizeAug, _resolve_mean_std

        mean, std = _resolve_mean_std(mean, std)
        auglist.append(DetBorrowAug(ColorNormalizeAug(_host(mean),
                                                      _host(std))))
    return auglist


class _LazyRecKey:
    """Marker for an on-demand indexed-recordio payload."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key


def _parse_det_label(raw):
    """[header_w, obj_w, <header...>, objs...] → (num_obj, obj_w) array."""
    raw = np.asarray(raw, np.float32).ravel()
    if raw.size < 2:
        raise MXNetError(f"malformed det label (size {raw.size})")
    header_w, obj_w = int(raw[0]), int(raw[1])
    if header_w < 2 or obj_w < 5:
        raise MXNetError(
            f"det label header_width={header_w} object_width={obj_w}; "
            "need >=2 and >=5 ([cls, xmin, ymin, xmax, ymax, ...])")
    body = raw[header_w:]
    if body.size % obj_w:
        raise MXNetError("det label body not a multiple of object width")
    return body.reshape(-1, obj_w)


class ImageDetIter:
    """Detection iterator over .lst/.rec with box labels
    (ref: mx.image.ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, label_pad_width=None,
                 label_pad_value=-1.0, data_name="data",
                 label_name="label", last_batch_handle="pad",
                 num_parts=1, part_index=0):
        from ..io.io import DataDesc, _built_ctx

        self.batch_size = batch_size
        self._ctx = _built_ctx()
        self.data_shape = tuple(data_shape)
        self.label_pad_value = float(label_pad_value)
        from ..io.io import _check_partition

        _check_partition(num_parts, part_index)  # before any dataset scan
        self._shuffle = shuffle
        # each item: (label 2-D array, source) where source is a str
        # path, raw encoded bytes, or a lazy-read key into self._rec
        self._items = []
        self._rec = None
        if path_imgrec:
            from ..io import recordio as _recordio

            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                # indexed: scan labels once (headers only), keep the
                # reader open and fetch payloads on demand — a COCO-size
                # .rec must not be held in RAM (ref: streaming iter)
                self._rec = _recordio.MXIndexedRecordIO(idx_path,
                                                        path_imgrec, "r")
                for key in self._rec.keys:
                    header, _ = _recordio.unpack(self._rec.read_idx(key))
                    self._items.append((_parse_det_label(header.label),
                                        _LazyRecKey(key)))
            else:
                rec = _recordio.MXRecordIO(path_imgrec, "r")
                while True:
                    s = rec.read()
                    if s is None:
                        break
                    header, img = _recordio.unpack(s)
                    self._items.append((_parse_det_label(header.label),
                                        img))
                rec.close()
        elif path_imglist:
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = _parse_det_label([float(v) for v in
                                              parts[1:-1]])
                    self._items.append(
                        (label, os.path.join(path_root, parts[-1])))
        else:
            raise MXNetError("need path_imgrec or path_imglist")
        if num_parts > 1:  # dist-worker shard (ref: num_parts/part_index)
            self._items = self._items[part_index::num_parts]
        if not self._items:
            raise MXNetError("empty detection dataset")

        obj_w = self._items[0][0].shape[1]
        for lab, _ in self._items:
            if lab.shape[1] != obj_w:
                raise MXNetError("inconsistent object widths across images")
        max_obj = max(lab.shape[0] for lab, _ in self._items)
        if label_pad_width and label_pad_width < max_obj:
            raise MXNetError(
                f"label_pad_width={label_pad_width} is smaller than the "
                f"dataset's max object count {max_obj}; raise it or drop "
                "the argument")
        self.max_objects = label_pad_width or max_obj
        self.obj_width = obj_w
        self._aug = (aug_list if aug_list is not None
                     else CreateDetAugmenter((data_shape[0], data_shape[1],
                                              data_shape[2])))
        self.provide_data = [DataDesc(data_name, (batch_size,)
                                      + self.data_shape)]
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, self.max_objects,
                                        obj_w))]
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(
                f"unknown last_batch_handle {last_batch_handle!r}")
        self._order = list(range(len(self._items)))
        self._pos = 0
        self._last_batch_handle = last_batch_handle
        self._rollover = []  # leftover indices carried to the next epoch
        self.reset()

    def __iter__(self):
        return self

    def reset(self):
        self._pos = 0
        if self._shuffle:
            np.random.shuffle(self._order)
        if self._rollover:
            # roll_over: leftover samples lead the new epoch
            rest = [i for i in self._order if i not in set(self._rollover)]
            self._order = self._rollover + rest
            self._rollover = []

    def _load_image(self, src):
        if isinstance(src, _LazyRecKey):
            from ..io import recordio as _recordio

            _, payload = _recordio.unpack(self._rec.read_idx(src.key))
            src = payload
        if isinstance(src, (bytes, bytearray)):
            from .image import imdecode

            return imdecode(src)
        return imread(src)

    def next(self):
        from ..io.io import DataBatch

        n = len(self._items)
        if self._pos >= n:
            raise StopIteration
        remaining = n - self._pos
        if remaining < self.batch_size:
            if self._last_batch_handle == "discard":
                self._pos = n
                raise StopIteration
            if self._last_batch_handle == "roll_over":
                # keep the leftovers for the start of the next epoch
                self._rollover = self._order[self._pos:]
                self._pos = n
                raise StopIteration
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        labels = np.full((self.batch_size, self.max_objects,
                          self.obj_width), self.label_pad_value,
                         np.float32)
        pad = 0
        for i in range(self.batch_size):
            if self._pos >= n:
                pad += 1  # "pad": wrap around, report pad count
                self._pos += 1
                idx = self._order[(self._pos - 1) % n]
            else:
                idx = self._order[self._pos]
                self._pos += 1
            lab, src = self._items[idx]
            img = self._load_image(src)
            lab = lab.copy()
            for aug in self._aug:
                img, lab = aug(img, lab)
            arr = img.asnumpy().astype(np.float32)
            if arr.shape[0] != h or arr.shape[1] != w:
                # aug chain without a resize step: fix up float-safely
                # (imresize would cast normalized data through uint8)
                from .image import _resize_float

                arr = _resize_float(arr, w, h)
            data[i] = arr.transpose(2, 0, 1)
            labels[i, :lab.shape[0]] = lab
        return DataBatch(data=[_nd.array(data, ctx=self._ctx)],
                         label=[_nd.array(labels, ctx=self._ctx)], pad=pad)

    def __next__(self):
        return self.next()

    def draw_next(self, color=255, thickness=2):
        """Yield images with boxes burned in (debug aid; ref: draw_next)."""
        for lab, src in self._items:
            img = imresize(self._load_image(src), self.data_shape[2],
                           self.data_shape[1]).asnumpy().copy()
            h, w = img.shape[0], img.shape[1]
            for obj in lab:
                if obj[0] < 0:
                    continue
                x0, y0, x1, y1 = (int(obj[1] * w), int(obj[2] * h),
                                  int(obj[3] * w), int(obj[4] * h))
                img[y0:y1, x0:x0 + thickness] = color
                img[y0:y1, max(x1 - thickness, 0):x1] = color
                img[y0:y0 + thickness, x0:x1] = color
                img[max(y1 - thickness, 0):y1, x0:x1] = color
            yield img
