"""Atomic, async, versioned checkpoints of a tree of tensors. PyTorch
counterpart of ``repro.checkpoint.manager`` on one device.

* **The tree** — nested ``dict`` / ``list`` / ``tuple`` with tensors at
  the leaves, such as a model's ``state_dict()``. :func:`flatten` walks it
  in order into a plain structure (containers and leaf numbers, pickled)
  and a list of leaves; each leaf is stored as a
  :func:`~repro_torch.store.blobio.array_blob` (raw bytes, dtype, shape,
  crc32) beside its torch dtype, so bf16 round-trips through its bits.
  numpy arrays and Python numbers are leaves too and restore as tensors.
  The file is the port's own: the reference's pickles a JAX treedef.
* **Atomicity** — a checkpoint is written to ``step_<n>.tmp-<pid>`` and
  renamed to ``step_<n>.ckpt``; a crash mid-write can never corrupt the
  latest good checkpoint. The ``latest`` pointer is rewritten last (also
  by rename, without fsync: a lost pointer only costs discovery).
* **Async** — ``save_async`` copies the tree to the host now and hands
  serialization to a daemon worker; ``wait()`` joins it and raises what
  the worker raised.
* **Restore** — ``restore(step=None, device="cuda")`` places every leaf
  on ``device``. The reference's ``shardings=`` is a separate step here:
  ``runtime.elastic.remesh`` of the restored tree (``device="cpu"``)
  distributes it onto a mesh under its logical specs.
* **Retention** — monotone step numbers; the ``keep`` newest survive.
* **Integrity** — restore verifies every leaf's crc32.

The atomic write and the crc32 envelope are the shared
:mod:`repro_torch.store.blobio` primitives, one durable-write idiom for
checkpoints and the persistent index store (DESIGN.md §13.1).
"""

from __future__ import annotations

import collections
import os
import pickle
import threading
import time

import numpy as np
import torch

from repro_torch.obs.locks import named_lock
from repro_torch.store.blobio import array_blob, atomic_write, blob_array


def flatten(tree, leaves: list):
    """The structure of ``tree`` with each leaf replaced by ``("leaf",
    i)``, appending the leaves to ``leaves`` in order. Containers are
    ``dict`` (its subclasses, such as a ``state_dict``'s ``OrderedDict``,
    are kept by class), ``list`` and ``tuple``; everything else is a
    leaf."""
    if isinstance(tree, dict):
        kind = "odict" if isinstance(tree, collections.OrderedDict) else "dict"
        return (kind, [(k, flatten(v, leaves)) for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [flatten(v, leaves) for v in tree])
    leaves.append(tree)
    return ("leaf", len(leaves) - 1)


def unflatten(spec, leaves: list):
    """Inverse of :func:`flatten`."""
    kind, body = spec
    if kind == "leaf":
        return leaves[body]
    if kind in ("dict", "odict"):
        cls = collections.OrderedDict if kind == "odict" else dict
        return cls((k, unflatten(v, leaves)) for k, v in body)
    items = [unflatten(v, leaves) for v in body]
    return items if kind == "list" else tuple(items)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array of its own bytes (a copy, so a later
    in-place update of the tensor cannot reach a pending write) and its
    torch dtype's name. bf16 travels as its int16 bits."""
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True).contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _from_host(arr: np.ndarray, name: str, device) -> torch.Tensor:
    t = torch.from_numpy(arr.copy())
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # guards the worker slot + last error; the join itself happens
        # outside the lock so a slow disk write never blocks other callers
        # on the mutex ("checkpoint" is the innermost hierarchy level)
        self._lock = named_lock("checkpoint")
        self._thread: threading.Thread | None = None
        self._last_error: Exception | None = None

    # -- save ------------------------------------------------------------
    @staticmethod
    def _snapshot(tree) -> tuple:
        leaves: list = []
        spec = flatten(tree, leaves)
        return spec, [_to_host(leaf) for leaf in leaves]

    def _serialize(self, step: int, snapshot: tuple, meta: dict):
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp-{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:010d}.ckpt")
        spec, host = snapshot
        payload = {"step": step, "tree": spec, "meta": meta,
                   "blobs": [array_blob(arr) for arr, _ in host],
                   "dtypes": [name for _, name in host],
                   "written_at": time.time()}
        atomic_write(final,
                     pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL),
                     tmp=tmp)
        atomic_write(os.path.join(self.dir, "latest"),
                     os.path.basename(final).encode(),
                     tmp=os.path.join(self.dir, f".latest.tmp-{os.getpid()}"),
                     fsync=False)
        self._gc()

    def _gc(self):
        ckpts = sorted(p for p in os.listdir(self.dir) if p.endswith(".ckpt"))
        for stale in ckpts[: -self.keep] if self.keep else []:
            try:
                os.remove(os.path.join(self.dir, stale))
            except OSError:
                pass

    def save(self, step: int, tree, meta: dict | None = None):
        """Synchronous save."""
        self._serialize(step, self._snapshot(tree), meta or {})

    def save_async(self, step: int, tree, meta: dict | None = None):
        """Device -> host now; the disk write on a daemon worker."""
        self.wait()
        snapshot = self._snapshot(tree)

        def work():
            try:
                self._serialize(step, snapshot, meta or {})
            except Exception as e:  # surfaced on the next wait()
                with self._lock:
                    self._last_error = e

        t = threading.Thread(target=work, daemon=True, name="checkpoint-save")
        with self._lock:
            self._thread = t
        t.start()

    def wait(self):
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join()
        with self._lock:
            err, self._last_error = self._last_error, None
        if err is not None:
            raise err

    # -- restore -----------------------------------------------------------
    def latest_step(self) -> int | None:
        ptr = os.path.join(self.dir, "latest")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1].split(".")[0])

    def restore(self, step: int | None = None, device="cuda"):
        """``(step, tree, meta)`` with every leaf a tensor on ``device``;
        ``IOError`` when a leaf fails its crc32."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}.ckpt")
        with open(path, "rb") as f:
            payload = pickle.load(f)
        device = torch.device(device)
        leaves = [_from_host(blob_array(blob, label=f"checkpoint {path}"),
                             name, device)
                  for blob, name in zip(payload["blobs"], payload["dtypes"])]
        return payload["step"], unflatten(payload["tree"], leaves), \
            payload["meta"]
