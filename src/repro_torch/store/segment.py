"""On-disk segment/manifest format for one stored workload key
(DESIGN.md §13.2). PyTorch port of ``repro.store.segment``: the format is
the reference's, so the same commits give byte-equal segment files and
manifests equal but for ``written_at``.

One key directory holds:

* ``seg_<seq>.bin`` — append-only segment files: raw array bytes at
  alloc-rounded offsets (:data:`ALIGN`), nothing else. Segments are
  immutable once renamed into place; a commit only ever *adds* a file.
* ``manifest_<seq>.json`` — one manifest per commit: epoch, scalar meta,
  and for every logical array its dtype, shape and **part list** — each
  part naming a segment file, byte offset, length and crc32. A full
  commit's arrays are single parts in the commit's own segment; a delta
  commit's arrays reference the prior chain (``reuse``), add a head/tail
  part around it (``prefix``/``suffix``), or carry a replacement part
  (``full``), per :func:`repro_torch.core.streaming.array_delta`.
* ``latest`` — pointer to the newest manifest, rewritten last. Purely an
  optimization: recovery never trusts it, it walks manifests newest-first
  and serves the first one that validates.

Commit order is segment → fsync → rename, manifest → fsync → rename,
pointer. The *manifest rename is the commit point*: a crash anywhere
earlier leaves only ignorable temp files or an orphaned (unreferenced)
segment, and a crash between manifest and pointer still exposes the new
commit to the recovery walk. Loading mmaps each referenced segment and
slices parts out of it — single-part arrays are zero-copy views; the rare
multi-part array (a suffix chain) is concatenated, paying one copy of
that array only.

Single writer per key directory is assumed (the registry serializes
builds per key and runs epoch mutations on one FIFO worker); concurrent
writers from separate processes cannot corrupt a commit (every rename is
atomic) but may waste segments.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time

import numpy as np

from repro_torch.core.streaming import array_delta

from .blobio import atomic_write, crc32

MANIFEST_FORMAT = 1

#: allocation granularity for array offsets inside a segment file: keeps
#: every part naturally aligned for any dtype the index planes use and
#: cache-line aligned for the mmap read path
ALIGN = 64

_SEG_RE = re.compile(r"^seg_(\d{8})\.bin$")
_MAN_RE = re.compile(r"^manifest_(\d{8})\.json$")


class StoreCorruption(IOError):
    """A manifest or segment failed validation (bad json, missing or
    short segment file, crc mismatch). Recovery catches this and walks
    back to the previous commit."""


def _align(off: int) -> int:
    return (off + ALIGN - 1) // ALIGN * ALIGN


def next_seq(dirpath: str) -> int:
    """1 + the largest sequence number any file in the directory carries —
    including orphaned segments from interrupted commits, so a recovered
    writer never reuses (and silently overwrites) a crashed commit's
    names."""
    seq = 0
    for name in os.listdir(dirpath):
        m = _SEG_RE.match(name) or _MAN_RE.match(name)
        if m:
            seq = max(seq, int(m.group(1)))
    return seq + 1


def list_manifests(dirpath: str) -> list[tuple[int, str]]:
    """(seq, filename) of every manifest, newest first."""
    out = []
    for name in os.listdir(dirpath):
        m = _MAN_RE.match(name)
        if m:
            out.append((int(m.group(1)), name))
    out.sort(reverse=True)
    return out


# ----------------------------------------------------------------------
# commit
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    """A part whose bytes go into the commit's own segment; the offset is
    assigned at layout time."""
    raw: np.ndarray   # flat uint8 view of the bytes to write


def write_commit(dirpath: str, meta: dict, arrays: dict,
                 prev: tuple[dict, dict] | None = None, *,
                 max_chain: int = 4, keep_manifests: int = 2) -> dict:
    """Commit ``arrays`` (name -> ndarray) + scalar ``meta`` as the key's
    next epoch. ``prev = (prev_manifest, prev_arrays)`` enables the delta
    path: arrays unchanged since ``prev`` reuse its parts,
    prefix/suffix-grown arrays write only their changed bytes. Falls back
    to a full commit when the delta would not pay — the referenced chain
    would exceed ``max_chain`` distinct segments, or the delta writes no
    fewer bytes than a full rewrite. Returns
    ``{"mode", "seq", "epoch", "bytes_written", "segments"}``."""
    seq = next_seq(dirpath)
    seg_name = f"seg_{seq:08d}.bin"
    entries = mode = None
    if prev is not None:
        prev_man, prev_arrays = prev
        entries, delta_bytes, chain = _delta_entries(
            prev_man, prev_arrays, arrays, seg_name)
        full_bytes = sum(int(np.asarray(a).nbytes) for a in arrays.values())
        # take the delta whenever it writes strictly less than a full
        # rewrite AND keeps the referenced chain short (chain length bounds
        # both open-time validation work and the blast radius of one lost
        # segment); otherwise compact to a fresh full commit
        if len(chain) > max_chain or delta_bytes >= full_bytes:
            entries = None
        else:
            mode = "delta"
    if entries is None:
        mode = "full"
        entries = {
            name: {"dtype": str(np.asarray(a).dtype),
                   "shape": list(np.asarray(a).shape),
                   "parts": [_Pending(_flat_bytes(a))]}
            for name, a in arrays.items()
        }
    written = _write_segment(dirpath, seg_name, entries)
    segments = sorted({p["segment"] for e in entries.values()
                       for p in e["parts"]})
    man = {
        "format": MANIFEST_FORMAT,
        "seq": seq,
        "mode": mode,
        "epoch": int(meta.get("epoch", 0)),
        "meta": meta,
        "arrays": entries,
        "segments": segments,
        "written_at": time.time(),
    }
    man_name = f"manifest_{seq:08d}.json"
    atomic_write(os.path.join(dirpath, man_name),
                 json.dumps(man, sort_keys=True).encode())
    atomic_write(os.path.join(dirpath, "latest"), man_name.encode(),
                 fsync=False)
    _gc(dirpath, keep_manifests)
    return {"mode": mode, "seq": seq, "epoch": man["epoch"],
            "bytes_written": written, "segments": segments}


def _flat_bytes(a) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _delta_entries(prev_man: dict, prev_arrays: dict, arrays: dict,
                   seg_name: str):
    """Per-array delta classification against the previous commit. The
    new name set may gain arrays (a suffix epoch can raise the graph's
    k-max, adding fresh per-k blocks — those write in full while the
    existing blocks still delta); *losing* arrays degrades to a full
    commit by inflating the chain."""
    if not set(prev_man["arrays"]) <= set(arrays):
        return {}, 0, set(range(10_000))  # force the full path
    entries: dict = {}
    delta_bytes = 0
    chain = {seg_name}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        p_ent = prev_man["arrays"].get(name)
        d = (array_delta(prev_arrays.get(name), arr)
             if p_ent is not None else "full")
        if p_ent is None:
            raw = _flat_bytes(arr)
            delta_bytes += raw.nbytes
            parts = [_Pending(raw)]
        elif d == "reuse":
            parts = [dict(p) for p in p_ent["parts"]]
        elif d == "suffix":
            prev_n = sum(p["nbytes"] for p in p_ent["parts"])
            tail = _flat_bytes(arr)[prev_n:]
            delta_bytes += tail.nbytes
            parts = [dict(p) for p in p_ent["parts"]] + [_Pending(tail)]
        elif d == "prefix":
            prev_n = sum(p["nbytes"] for p in p_ent["parts"])
            head = _flat_bytes(arr)[:arr.nbytes - prev_n]
            delta_bytes += head.nbytes
            parts = [_Pending(head)] + [dict(p) for p in p_ent["parts"]]
        else:
            raw = _flat_bytes(arr)
            delta_bytes += raw.nbytes
            parts = [_Pending(raw)]
        for p in parts:
            if not isinstance(p, _Pending):
                chain.add(p["segment"])
        entries[name] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                         "parts": parts}
    return entries, delta_bytes, chain


def _write_segment(dirpath: str, seg_name: str, entries: dict) -> int:
    """Lay pending parts out at alloc-rounded offsets, write the segment
    atomically, and replace each ``_Pending`` with its concrete part
    descriptor. Returns bytes written. When nothing is pending (a pure
    reuse delta) no segment file is created at all."""
    pending: list[tuple[dict, int, _Pending]] = []
    off = 0
    for ent in entries.values():
        for i, p in enumerate(ent["parts"]):
            if isinstance(p, _Pending):
                off = _align(off)
                pending.append((ent, i, p, off))
                off += p.raw.nbytes
    if not pending:
        return 0
    buf = bytearray(off)
    for ent, i, p, at in pending:
        buf[at:at + p.raw.nbytes] = p.raw.tobytes()
        ent["parts"][i] = {"segment": seg_name, "offset": at,
                           "nbytes": p.raw.nbytes, "crc": crc32(p.raw)}
    atomic_write(os.path.join(dirpath, seg_name), bytes(buf))
    return len(buf)


def _gc(dirpath: str, keep_manifests: int) -> None:
    """Drop manifests beyond the ``keep_manifests`` newest, then every
    segment no kept manifest references (orphans from interrupted commits
    included). Failures are ignored — GC is advisory, correctness rests
    on the commit protocol alone."""
    manifests = list_manifests(dirpath)
    keep, drop = manifests[:keep_manifests], manifests[keep_manifests:]
    referenced: set[str] = set()
    for _, name in keep:
        try:
            with open(os.path.join(dirpath, name)) as f:
                referenced.update(json.load(f).get("segments", ()))
        except (OSError, ValueError):
            pass
    for _, name in drop:
        try:
            os.remove(os.path.join(dirpath, name))
        except OSError:
            pass
    for name in os.listdir(dirpath):
        if _SEG_RE.match(name) and name not in referenced:
            try:
                os.remove(os.path.join(dirpath, name))
            except OSError:
                pass


# ----------------------------------------------------------------------
# open / recover
# ----------------------------------------------------------------------

def read_manifest(dirpath: str, name: str) -> dict:
    """Parse + structurally validate one manifest; :class:`StoreCorruption`
    on any defect (truncated json, missing segment, short segment)."""
    path = os.path.join(dirpath, name)
    try:
        with open(path, "rb") as f:
            man = json.loads(f.read().decode())
    except (OSError, ValueError) as exc:
        raise StoreCorruption(f"unreadable manifest {path}: {exc}") from exc
    if not isinstance(man, dict) or man.get("format") != MANIFEST_FORMAT:
        raise StoreCorruption(f"manifest {path}: bad format marker")
    sizes = {}
    for seg in man.get("segments", ()):
        sp = os.path.join(dirpath, seg)
        if not os.path.exists(sp):
            raise StoreCorruption(f"manifest {path}: missing segment {seg}")
        sizes[seg] = os.path.getsize(sp)
    try:
        for aname, ent in man["arrays"].items():
            need = int(np.prod(ent["shape"], dtype=np.int64)
                       ) * np.dtype(ent["dtype"]).itemsize
            have = 0
            for p in ent["parts"]:
                if p["offset"] + p["nbytes"] > sizes[p["segment"]]:
                    raise StoreCorruption(
                        f"manifest {path}: part of {aname!r} overruns "
                        f"segment {p['segment']}")
                have += p["nbytes"]
            if have != need:
                raise StoreCorruption(
                    f"manifest {path}: {aname!r} parts sum to {have} bytes, "
                    f"shape needs {need}")
    except (KeyError, TypeError, ValueError) as exc:
        raise StoreCorruption(f"manifest {path}: malformed: {exc}") from exc
    return man


def load_arrays(dirpath: str, man: dict, names=None, *,
                verify: bool = True) -> dict:
    """mmap the manifest's segments and materialize its arrays (or just
    ``names``). Single-part arrays are zero-copy views into the mapping;
    ``verify`` checks every part's crc32 (paging the bytes in — still far
    cheaper than a rebuild)."""
    maps: dict[str, np.ndarray] = {}
    out: dict[str, np.ndarray] = {}
    for aname, ent in man["arrays"].items():
        if names is not None and aname not in names:
            continue
        views = []
        for p in ent["parts"]:
            seg = p["segment"]
            if seg not in maps:
                maps[seg] = np.memmap(os.path.join(dirpath, seg),
                                      dtype=np.uint8, mode="r")
            view = maps[seg][p["offset"]:p["offset"] + p["nbytes"]]
            if verify and crc32(view) != p["crc"]:
                raise StoreCorruption(
                    f"segment {seg} failed crc32 verification for "
                    f"{aname!r} (epoch {man.get('epoch')})")
            views.append(view)
        flat = views[0] if len(views) == 1 else np.concatenate(views)
        out[aname] = flat.view(np.dtype(ent["dtype"])).reshape(ent["shape"])
    return out


def open_latest(dirpath: str, *, verify: bool = True,
                load: bool = True):
    """Newest valid commit: ``(manifest, arrays, recovered)`` — or ``None``
    when the directory holds no loadable commit at all. ``recovered``
    counts newer manifests that failed validation and were skipped (the
    crash-recovery walk). ``load=False`` validates structure only and
    returns ``(manifest, None, recovered)`` (cheap epoch probes)."""
    if not os.path.isdir(dirpath):
        return None
    recovered = 0
    for _, name in list_manifests(dirpath):
        try:
            man = read_manifest(dirpath, name)
            if not load:
                return man, None, recovered
            return man, load_arrays(dirpath, man, verify=verify), recovered
        except StoreCorruption:
            recovered += 1
            continue
    return None
