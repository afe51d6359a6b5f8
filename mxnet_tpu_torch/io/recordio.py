"""RecordIO / IndexedRecordIO (ref: ``mxnet_tpu/io/recordio.py``; dmlc-core's
recordio.h and python/mxnet/recordio.py).

Byte-format compatible with the reference so .rec files pack/unpack
across frameworks: each record is
  [kMagic u32][lrec u32][data][pad to 4B]
where lrec's upper 3 bits are the continuation flag and lower 29 bits
the length.  IRHeader (image records) = [flag u32][label f32][id u64]
[id2 u64] optionally followed by extra float labels when flag > 1.

The files are byte-identical to the JAX package's.  The C++ twin of this
reader and writer (src/recordio.cc, lib/libmxtpu_io.so) serves
``NativeIndexedRecordIO`` and ``io.ImageRecordIter``'s native decode lane.
``pack_img``/``unpack_img`` import PIL when called.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

from ..base import MXNetError

KMAGIC = 0xCED7230A
_LEN_MASK = (1 << 29) - 1


class MXRecordIO:
    """Sequential record reader/writer (ref: dmlc::RecordIOWriter/Reader)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag}")

    def close(self):
        if self.record is not None:
            self.record.close()
            self.record = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.record.tell()

    def seek(self, pos):
        assert not self.writable
        self.record.seek(pos)

    def _write_chunk(self, chunk, cflag):
        if len(chunk) > _LEN_MASK:
            raise MXNetError(
                "record chunk too large (>512MB between aligned magic "
                "words) — the recordio length field cannot represent it")
        lrec = (cflag << 29) | len(chunk)
        self.record.write(struct.pack("<II", KMAGIC, lrec))
        self.record.write(chunk)
        pad = (4 - len(chunk) % 4) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def write(self, buf):
        assert self.writable
        if isinstance(buf, str):
            buf = buf.encode()
        # dmlc recordio escaping: the payload must never contain the
        # magic word at a 4-byte boundary, so the writer splits the
        # record at each aligned magic occurrence (dropping those 4
        # bytes — the reader re-inserts them) and marks the pieces with
        # the cflag in the top 3 bits of the length word
        # (0 whole, 1 begin, 2 middle, 3 end)
        view = memoryview(buf)
        magic = struct.pack("<I", KMAGIC)
        # C-speed scan: find() hops between candidates; only 4-byte-
        # aligned hits split (the common no-magic payload costs one find)
        splits = []
        pos = buf.find(magic)
        while pos != -1:
            if pos % 4 == 0:
                splits.append(pos)
                pos = buf.find(magic, pos + 4)
            else:
                pos = buf.find(magic, pos + 1)
        if not splits:
            self._write_chunk(view, 0)
            return
        bounds = [0] + [p + 4 for p in splits]
        ends = splits + [len(buf)]
        # validate EVERY chunk before writing any bytes: raising midway
        # would leave a dangling continuation chunk in the file
        for b, e in zip(bounds, ends):
            if e - b > _LEN_MASK:
                raise MXNetError(
                    "record chunk too large (>512MB between aligned "
                    "magic words) — the recordio length field cannot "
                    "represent it")
        n_chunks = len(bounds)
        for i, (b, e) in enumerate(zip(bounds, ends)):
            flag = 1 if i == 0 else (3 if i == n_chunks - 1 else 2)
            self._write_chunk(view[b:e], flag)

    def _read_chunk(self):
        header = self.record.read(8)
        if len(header) < 8:
            return None, 0
        magic, lrec = struct.unpack("<II", header)
        if magic != KMAGIC:
            raise MXNetError(f"{self.uri}: bad record magic {magic:#x}")
        n = lrec & _LEN_MASK
        data = self.record.read(n)
        if len(data) != n:
            raise MXNetError(
                f"{self.uri}: truncated record (wanted {n} bytes, got "
                f"{len(data)})")
        pad = (4 - n % 4) % 4
        if pad:
            self.record.read(pad)
        return data, lrec >> 29

    def read(self):
        assert not self.writable
        data, cflag = self._read_chunk()
        if data is None:
            return None
        if cflag == 0:
            return data
        if cflag != 1:
            raise MXNetError(
                f"{self.uri}: dangling continuation chunk (cflag={cflag})")
        # the writer removed an aligned magic word at every split point;
        # reassembly re-inserts it (dmlc RecordIOReader behavior)
        magic = struct.pack("<I", KMAGIC)
        parts = [data]
        while True:
            piece, cf = self._read_chunk()
            if piece is None:
                raise MXNetError(f"{self.uri}: truncated chunked record")
            parts.append(magic)
            parts.append(piece)
            if cf == 3:
                return b"".join(parts)
            if cf != 2:
                raise MXNetError(
                    f"{self.uri}: bad continuation cflag {cf}")


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records via a .idx file (ref: MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        k = self.key_type(parts[0])
                        self.idx[k] = int(parts[1])
                        self.keys.append(k)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


class NativeIndexedRecordIO:
    """Write-side MXIndexedRecordIO backed by the native C++ writer
    (``src/recordio.cc`` MXTPURecordIOWriter*, ``lib/libmxtpu_io.so``) —
    the ``tools/im2rec.cc`` binary's role (ref: dmlc recordio.h writer).
    The record/index output is byte-identical to the Python writer: same
    magic-escape chunking, same ``idx\\tpos`` index lines.  Without the
    library it raises."""

    def __init__(self, idx_path, uri, flag="w", key_type=int):
        from ..utils import native

        if flag != "w":
            raise MXNetError(
                "NativeIndexedRecordIO is the packer (write) side; "
                "read through MXIndexedRecordIO or the native pipeline")
        lib = native.load()
        if lib is None:
            raise MXNetError(
                "native IO library unavailable (build lib/libmxtpu_io.so"
                f" or use MXIndexedRecordIO): {native.load_error()}")
        self._lib = lib
        self._h = lib.MXTPURecordIOWriterCreate(uri.encode())
        if not self._h:
            raise MXNetError(f"cannot open {uri} for writing")
        self.idx_path = idx_path
        self.key_type = key_type
        self.fidx = open(idx_path, "w")
        self.idx = {}
        self.keys = []

    def write_idx(self, idx, buf):
        if self._h is None or self.fidx is None:
            # a NULL handle would be dereferenced by the C writer
            raise MXNetError("NativeIndexedRecordIO is closed")
        key = self.key_type(idx)
        pos = self._lib.MXTPURecordIOWrite(self._h, bytes(buf), len(buf))
        if pos < 0:
            raise MXNetError("native recordio write failed "
                             f"(record {key}, {len(buf)} bytes)")
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)

    def close(self):
        if self._h:
            self._lib.MXTPURecordIOWriterFree(self._h)
            self._h = None
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an IRHeader + payload (ref: mx.recordio.pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, header.flag, float(header.label),
                          header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                          header.id2) + label.tobytes()
    if isinstance(s, str):
        s = s.encode()
    return hdr + s


def unpack(s):
    """Unpack to (IRHeader, payload) (ref: mx.recordio.unpack)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    payload = s[_IR_SIZE:]
    if flag > 0:
        # packed float label vector (size-1 included — ref strips for
        # flag > 0, not flag > 1)
        label = np.frombuffer(payload[:4 * flag], dtype=np.float32)
        payload = payload[4 * flag:]
    return IRHeader(flag, label, id_, id2), payload


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an image array and pack (ref: mx.recordio.pack_img)."""
    import io as _io

    from PIL import Image

    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 3:
        pil = Image.fromarray(arr.astype(np.uint8))
    else:
        pil = Image.fromarray(arr.astype(np.uint8))
    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG"
    pil.save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """Unpack to (IRHeader, image ndarray HWC BGR-free/RGB)."""
    import io as _io

    from PIL import Image

    header, payload = unpack(s)
    img = Image.open(_io.BytesIO(payload))
    if iscolor == 0:
        img = img.convert("L")
    elif iscolor == 1:
        img = img.convert("RGB")
    return header, np.asarray(img)
