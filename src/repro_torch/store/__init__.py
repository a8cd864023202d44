"""Persistent index store (DESIGN.md §13): mmap-able segment files with
atomic manifest commits, giving the serving plane a disk tier. PyTorch
port of ``repro.store``: the same files, byte for byte, so either package
reads a store the other wrote (numpy, zlib and the standard library only;
the device mirror of a loaded index is the registry's business).

Three layers, lowest first:

* :mod:`blobio` — the atomic tmp-rename + crc32 write/read primitives
  that the checkpoint manager (``checkpoint/manager.py``) and the segment
  store share: one durable-write idiom instead of two copies.
* :mod:`segment` — the on-disk format for one workload key: alloc-
  rounded append-only segment files holding raw array bytes, plus JSON
  manifests (epoch, per-array dtype/shape/parts/crc32) committed by
  atomic rename. Suffix epochs commit as *deltas* against the resident
  chain; recovery walks manifests newest-first to the last valid commit.
* :mod:`index_store` — :class:`IndexStore`, the registry-facing tier:
  ``put_handle`` persists a built
  :class:`~repro_torch.serving.registry.IndexHandle` (write-through on
  build, delta on refresh/trim, demote on eviction), ``load`` mmaps a
  stored epoch back into host index objects so a warm restart pays a
  device upload instead of a rebuild.
"""

from .blobio import array_blob, atomic_write, blob_array
from .index_store import IndexStore, StoredIndex
from .segment import StoreCorruption

__all__ = [
    "IndexStore", "StoredIndex", "StoreCorruption",
    "array_blob", "atomic_write", "blob_array",
]
