"""Atomic filesystem commit primitives for checkpointing (ref:
``mxnet_tpu/checkpoint/atomic.py``).

A file is committed by write-to-temp -> fsync -> atomic rename, so a
reader only ever sees an absent or a complete file, never a partial one.
"""
from __future__ import annotations

import contextlib
import json
import os


def fsync_file(path):
    """Flush a written file's blocks to stable storage."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path):
    """Flush a directory entry (the rename itself) to stable storage.

    POSIX: durability of a rename requires an fsync on the PARENT
    directory; some filesystems refuse O_RDONLY fsync on dirs — best
    effort there (the rename is still atomic, just not yet durable).
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_file(path):
    """Yield a temp path to write; on success fsync + rename onto `path`.

    Usage::

        with atomic_file(fname) as tmp:
            writer(tmp)          # arbitrary writer, may crash freely
    """
    path = os.fspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        yield tmp
        fsync_file(tmp)
        os.replace(tmp, path)
        fsync_dir(os.path.dirname(path) or ".")
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def write_json(path, obj):
    """Durably write a JSON file (fsync'd; atomic when replacing)."""
    with atomic_file(path) as tmp:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1, sort_keys=True)
