"""Atomic tmp-rename + crc32 blob primitives (DESIGN.md §13.1); the
port's own copy of ``repro.store.blobio``.

The durable-write idiom — write to a pid-suffixed temp file in the same
directory, flush + fsync, then ``os.rename`` into place so a crash
mid-write can never corrupt the last good file — shared by
:mod:`repro_torch.checkpoint.manager` and the segment store. Same for the
per-array integrity envelope: every serialized array carries dtype, shape
and a crc32 of its raw bytes, verified on the way back in.

Nothing here takes a lock: callers run these on background workers, and
the static lock pass (``lock-blocking-call``) bars file I/O under any
hierarchy lock anyway.
"""

from __future__ import annotations

import os
import zlib

import numpy as np


def atomic_write(path: str, data: bytes, *, tmp: str | None = None,
                 fsync: bool = True) -> None:
    """Write ``data`` to ``path`` atomically: temp file, optional fsync,
    rename. ``tmp`` overrides the temp name (the checkpoint manager keeps
    its historical ``step_<n>.tmp-<pid>`` naming); the default is
    ``<path>.tmp-<pid>`` in the same directory, so the rename never
    crosses a filesystem. ``fsync=False`` is for pointer files whose loss
    is recoverable (a stale pointer only costs a directory walk)."""
    if tmp is None:
        tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.rename(tmp, path)


def array_blob(arr) -> dict:
    """Integrity envelope for one array: raw bytes plus the dtype/shape/crc
    needed to verify and reconstruct them."""
    arr = np.asarray(arr)
    raw = arr.tobytes()
    return {
        "dtype": str(arr.dtype), "shape": arr.shape,
        "crc": zlib.crc32(raw), "raw": raw,
    }


def blob_array(blob: dict, *, label: str = "blob") -> np.ndarray:
    """Reconstruct an :func:`array_blob`; raises ``IOError`` (with
    ``label`` naming the source) when the crc32 does not verify."""
    arr = np.frombuffer(blob["raw"], dtype=blob["dtype"]).reshape(blob["shape"])
    if zlib.crc32(blob["raw"]) != blob["crc"]:
        raise IOError(f"{label} failed crc32 verification")
    return arr


def crc32(buf) -> int:
    """crc32 over any buffer (bytes, memoryview, mmap slice)."""
    return zlib.crc32(buf)
