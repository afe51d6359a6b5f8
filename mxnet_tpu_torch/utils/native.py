"""ctypes binding of the native IO library (``src/recordio.cc`` ->
``lib/libmxtpu_io.so``; ref: ``mxnet_tpu/utils/native.py``): the RecordIO
writer of ``NativeIndexedRecordIO`` and the JPEG decode pipeline of
``io.ImageRecordIter``'s native lane.

``load()`` returns the library or None, decided once a process.  The
library links libjpeg; where it cannot be built or loaded (a machine
without ``jpeglib.h`` or ``libjpeg.so``) the build's or loader's own
message is logged once, at the first ``load()``, and kept for
:func:`load_error`.  ``MXTPU_NO_NATIVE=1`` disables it.
"""
from __future__ import annotations

import ctypes
import logging

import numpy as np

from ..base import MXNetError

SO_NAME = "libmxtpu_io.so"
_lib = None
_tried = False
_log = logging.getLogger(__name__)


def load_error():
    """Why the library is unavailable, or None when it loaded."""
    from .libloader import load_error as _why

    return None if _lib is not None else _why(SO_NAME)


def load():
    """The native IO library handle, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from .libloader import load_native_lib

    lib = load_native_lib(SO_NAME)
    if lib is None:
        _log.warning("native IO library unavailable, the Python decode "
                     "lane runs: %s", load_error())
        return None
    lib.MXTPURecordIOWriterCreate.restype = ctypes.c_void_p
    lib.MXTPURecordIOWriterCreate.argtypes = [ctypes.c_char_p]
    lib.MXTPURecordIOWrite.restype = ctypes.c_int64
    lib.MXTPURecordIOWrite.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_uint64]
    lib.MXTPURecordIOWriterFree.argtypes = [ctypes.c_void_p]
    lib.MXTPUImagePipelineCreate.restype = ctypes.c_void_p
    lib.MXTPUImagePipelineCreate.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float)]
    lib.MXTPUImagePipelineReset.argtypes = [ctypes.c_void_p,
                                            ctypes.c_uint64]
    lib.MXTPUImagePipelineNext.restype = ctypes.c_int
    lib.MXTPUImagePipelineNext.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p]
    lib.MXTPUImagePipelineNumBatches.restype = ctypes.c_uint64
    lib.MXTPUImagePipelineNumBatches.argtypes = [ctypes.c_void_p]
    lib.MXTPUImagePipelineFree.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


class NativeImagePipeline:
    """The C++ decode pipeline (ref: ImageRecordIOParser2): its own
    ``num_threads`` workers decode, augment and normalise whole batches of
    the records at ``offsets``; :meth:`next_into` copies the next batch
    into caller memory (a pinned staging block)."""

    def __init__(self, rec_path, offsets, data_shape, batch_size,
                 num_threads=4, shuffle=False, rand_crop=False,
                 rand_mirror=False, resize_short=-1, mean=(0, 0, 0),
                 std=(1, 1, 1), seed=0, random_resized_crop=False,
                 min_random_area=1.0, max_random_area=1.0,
                 min_aspect_ratio=1.0, max_aspect_ratio=1.0,
                 brightness=0.0, contrast=0.0, saturation=0.0,
                 random_h=0.0, inter_method=1):
        lib = load()
        if lib is None:
            raise MXNetError(f"native IO library unavailable: "
                             f"{load_error()}")
        self._lib = lib
        offs = np.asarray(offsets, np.uint64)
        mean_arr = (ctypes.c_float * 3)(*[float(m) for m in mean])
        std_arr = (ctypes.c_float * 3)(*[float(s) for s in std])
        aug = (ctypes.c_float * 10)(
            float(bool(random_resized_crop)), float(min_random_area),
            float(max_random_area), float(min_aspect_ratio),
            float(max_aspect_ratio), float(brightness), float(contrast),
            float(saturation), float(random_h), float(inter_method))
        self._handle = lib.MXTPUImagePipelineCreate(
            rec_path.encode(), offs.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint64)), len(offs),
            data_shape[0], data_shape[1], data_shape[2], batch_size,
            num_threads, int(shuffle), int(rand_crop), int(rand_mirror),
            int(resize_short), mean_arr, std_arr, seed, aug)
        if not self._handle:
            raise MXNetError(f"native pipeline: cannot open {rec_path}")
        self._epoch = 0

    def reset(self):
        """Start the next epoch (the first call starts epoch 0)."""
        self._lib.MXTPUImagePipelineReset(self._handle, self._epoch)
        self._epoch += 1

    def next_into(self, data_ptr, label_ptr):
        """Copy the next batch to ``data_ptr`` (batch_size x data_shape
        float32) and its labels to ``label_ptr`` (batch_size float32);
        returns the count of records, 0 at the end of the epoch."""
        return self._lib.MXTPUImagePipelineNext(self._handle, data_ptr,
                                                label_ptr)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.MXTPUImagePipelineFree(self._handle)
                self._handle = None
        except Exception:
            pass
