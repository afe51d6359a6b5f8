"""NDArray (de)serialization (ref: ``mxnet_tpu/utils/serialization.py``).

The container of the JAX package, byte for byte, so a ``.params`` file
written by either package loads in the other: little-endian; the magic
``MXTPU1\\n``, the manifest's length as ``<Q``, a JSON manifest
``{"version": 1, "names", "tensors": [{"shape", "dtype"}]}`` (``names``
None for a list), then each tensor's raw bytes in C order.

bfloat16 has no numpy dtype here, so it never goes through numpy: the
writer takes the tensor's own two-byte words (``view(torch.int16)``) and
names them ``"bfloat16"``, as the JAX package's ml_dtypes arrays are
named, and the reader makes a bfloat16 tensor of them.  Loaded arrays
are NDArrays over tensors on the CPU; ``loads_ndarrays(numpy=True)``
gives numpy arrays instead, bfloat16 widened to float32 as
``NDArray.asnumpy`` gives it.
"""
from __future__ import annotations

import io
import json
import struct

import numpy as np
import torch

from ..base import MXNetError

_MAGIC = b"MXTPU1\n"
# Container format version, embedded in the JSON manifest.  The loader
# rejects newer-versioned files with an actionable error instead of
# misparsing them.
FORMAT_VERSION = 1


def _read_exact(f, n, fname, what):
    buf = f.read(n)
    if len(buf) != n:
        raise MXNetError(
            f"{fname}: corrupt or truncated NDArray file — wanted "
            f"{n} bytes for {what}, got {len(buf)} (was the writer "
            "killed mid-save? use checkpoint.atomic_file / "
            "CheckpointManager, which commit via temp-file + rename)")
    return buf


def _encode(value):
    """``(shape, dtype name, C-contiguous array of the raw bytes)`` of an
    NDArray, tensor or array-like.  The file is written from the arrays'
    own memory (no copy to ``bytes``), so a writer thread holds the GIL
    only briefly while it saves."""
    from ..ndarray.ndarray import NDArray

    if isinstance(value, NDArray):
        value = value.data
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return (list(t.shape), "bfloat16",
                    t.view(torch.int16).numpy().reshape(-1))
        value = t.numpy()
    a = np.asarray(value)
    return (list(a.shape), str(a.dtype),
            np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _write_container(f, data):
    """Write the versioned container to an open binary file object."""
    from ..ndarray.ndarray import NDArray

    if isinstance(data, dict):
        names = list(data.keys())
        values = list(data.values())
    elif isinstance(data, (list, tuple)):
        names, values = None, list(data)
    elif isinstance(data, (NDArray, torch.Tensor)):
        names, values = None, [data]
    else:
        raise MXNetError(f"cannot save {type(data)}")
    encoded = [_encode(v) for v in values]
    manifest = {"version": FORMAT_VERSION, "names": names,
                "tensors": [{"shape": shape, "dtype": dtype}
                            for shape, dtype, _ in encoded]}
    mbytes = json.dumps(manifest).encode()
    f.write(_MAGIC)
    f.write(struct.pack("<Q", len(mbytes)))
    f.write(mbytes)
    for _, _, raw in encoded:
        f.write(raw)


def _decode(buf, shape, dtype, numpy):
    if dtype == "bfloat16":
        words = np.frombuffer(buf, dtype=np.int16).copy()
        t = torch.from_numpy(words).view(torch.bfloat16).reshape(shape)
        return t.float().numpy() if numpy else t
    a = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
    return a if numpy else torch.from_numpy(a.copy())


def _read_container(f, fname, numpy=False):
    """Read one container from an open binary file object; ``numpy=True``
    returns numpy arrays instead of NDArrays."""
    from ..ndarray.ndarray import NDArray

    magic = f.read(len(_MAGIC))
    if magic != _MAGIC:
        raise MXNetError(f"{fname}: not an NDArray file (bad magic)")
    (mlen,) = struct.unpack(
        "<Q", _read_exact(f, 8, fname, "the manifest length"))
    try:
        manifest = json.loads(
            _read_exact(f, mlen, fname, "the manifest").decode())
    except ValueError as e:
        raise MXNetError(
            f"{fname}: corrupt NDArray file (unparseable manifest: "
            f"{e})") from None
    version = manifest.get("version", 1)
    if version > FORMAT_VERSION:
        raise MXNetError(
            f"{fname}: NDArray container format v{version} was "
            f"written by a newer mxnet_tpu (this build reads <= "
            f"v{FORMAT_VERSION}); upgrade to load it")
    arrays = []
    for i, t in enumerate(manifest["tensors"]):
        dtype = t["dtype"]
        itemsize = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
        n = int(np.prod(t["shape"])) if t["shape"] else 1
        buf = _read_exact(f, n * itemsize, fname,
                          f"tensor {i} of {len(manifest['tensors'])}")
        a = _decode(buf, t["shape"], dtype, numpy)
        arrays.append(a if numpy else NDArray(a))
    if manifest["names"] is None:
        return arrays
    return dict(zip(manifest["names"], arrays))


def save_ndarrays(fname, data):
    """data: a list of arrays or a dict str -> array (ref: mx.nd.save);
    arrays may be NDArrays, tensors or numpy arrays."""
    with open(fname, "wb") as f:
        _write_container(f, data)


def load_ndarrays(fname):
    with open(fname, "rb") as f:
        return _read_container(f, fname)


def dumps_ndarrays(data):
    """The same versioned container as :func:`save_ndarrays`, to bytes."""
    buf = io.BytesIO()
    _write_container(buf, data)
    return buf.getvalue()


def loads_ndarrays(buf, name="<bytes>", numpy=True):
    """Decode :func:`dumps_ndarrays` bytes; numpy arrays by default."""
    return _read_container(io.BytesIO(buf), name, numpy=numpy)
