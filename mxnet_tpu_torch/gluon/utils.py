"""gluon.utils (ref: python/mxnet/gluon/utils.py; ``mxnet_tpu/gluon/
utils.py``): ``split_data``, ``split_and_load``, ``clip_global_norm``,
``check_sha1`` and ``download``."""
from __future__ import annotations

import hashlib
import math

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array, as_tensor


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split ``data`` (an NDArray or tensor) along ``batch_axis`` into
    ``num_slice`` views; with ``even_split=False`` the last takes the rest."""
    t = as_tensor(data)
    size = t.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(f"data size {size} not divisible by {num_slice} "
                         "slices; set even_split=False")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if (i < num_slice - 1 or even_split) else size
        part = t.narrow(batch_axis, begin, end - begin)
        slices.append(NDArray(part) if isinstance(data, NDArray) else part)
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch (numpy, tensor or NDArray) along ``batch_axis`` and put
    one slice on each context of ``ctx_list``, as NDArrays."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [array(data, ctx=ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [array(s, ctx=c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (tensors or NDArrays, e.g. the gradients) in place
    so their joint L2 norm is at most ``max_norm``; return the norm before
    scaling.  A non-finite norm raises when ``check_isfinite``."""
    if not arrays:
        raise MXNetError("clip_global_norm needs at least one array")
    ts = [as_tensor(a) for a in arrays]
    with torch.no_grad():
        total = ts[0].float().square().sum()
        for t in ts[1:]:
            total = total + t.float().square().sum().to(total.device)
        total_norm = float(total.sqrt())
        if check_isfinite and not math.isfinite(total_norm):
            raise MXNetError(f"global norm is not finite: {total_norm}")
        scale = max_norm / (total_norm + 1e-8)
        if scale < 1.0:
            for t in ts:
                t.mul_(scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the SHA-1 of the file's bytes is ``sha1_hash`` (hex)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Raises: the package reads no network (place the file locally and
    pass its path), as the JAX package's ``download``."""
    raise MXNetError(
        "download() is unavailable: this environment has no network egress. "
        "Place files locally and pass a path instead.")
