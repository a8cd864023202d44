"""IndexStore: the registry's disk tier (DESIGN.md §13.3, §14.5). PyTorch
port of ``repro.store.index_store``, writing and reading the reference's
files: a store either package wrote loads through the other.

Maps one *workload* registry key to one segment directory (see
:mod:`repro_torch.store.segment`) and speaks the registry's language on
both sides: ``put_handle`` flattens a built
:class:`~repro_torch.serving.registry.IndexHandle` — graph arrays, every
stratum's 14 packed PECB arrays, the stratified core-time table — into
the segment format (as a *delta* against the previous epoch's handle
when one is supplied), and ``load`` mmaps the newest committed epoch
back into host index objects, so a warm restart or an LRU promotion
pays a device upload instead of a multi-second |K|-stratum rebuild.

Stratified block layout: arrays are stored *per stratum* under
``pecb.k{k}.*`` / ``tab.k{k}.*`` names rather than as the handle's
concatenated globals. That choice is what keeps suffix-epoch deltas
working — appending edges grows every stratum's arrays at its own tail,
so per-k blocks classify as suffix writes, while the concatenated form
would shift every block past the first and force a full commit each
epoch. A k_max raise (new stratum) changes the name set, which the
segment layer answers with one full commit — correct and rare. Two
derived pieces are *not* stored: the dense per-k vertex matrices (the
RLE runs in ``tab.k{k}.vptr``/``v_*`` are the authoritative form) and
the version-store endpoint arrays (recomputed on load as
``g.src[edge_id]`` — cheaper to gather than to persist).

Locking: ``self._lock`` (hierarchy level ``"store"``) guards the
counters behind :meth:`stats` and nothing else — every byte of file I/O
runs outside it (the static lock pass bars blocking calls under any
hierarchy lock). Write serialization per key is inherited from the
registry: one key's commits only ever originate from its single cold
build or the single FIFO epoch worker, never both concurrently.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
import zlib

import numpy as np

from repro_torch.core.core_time import StratifiedCoreTable
from repro_torch.core.pecb_index import PECBIndex, StratifiedPECB
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.obs.locks import named_lock
from repro_torch.obs.trace import NULL_SPAN

from .segment import load_arrays, open_latest, write_commit

#: the 14 packed arrays of a PECBIndex, in constructor order
PECB_ARRAYS = (
    "node_u", "node_v", "node_ct", "node_edge",
    "node_live_from", "node_live_to",
    "row_ptr", "ent_ts", "ent_left", "ent_right", "ent_parent",
    "vrow_ptr", "vent_ts", "vent_node",
)
#: per-stratum core-time blocks: version records + localized vertex-run CSR
TAB_ARRAYS = ("edge_id", "ts_from", "ts_to", "ct",
              "vptr", "v_ts_from", "v_ts_to", "v_ct")


@dataclasses.dataclass
class StoredIndex:
    """One stored epoch, rehydrated: everything the registry needs to
    re-mint an :class:`~repro_torch.serving.registry.IndexHandle` minus
    the device mirror (the promoter uploads). Record arrays are read-only
    views into the mmap'd segments wherever the layout allows
    (single-part, single-stratum); the stratified globals are assembled
    by one concatenation pass."""

    key: str
    epoch: int
    build_seconds: float
    graph: TemporalGraph
    pecb: StratifiedPECB
    tab: StratifiedCoreTable | None
    manifest: dict
    recovered: int = 0     # newer, invalid commits skipped on the way here
    # seconds of load's steps: "open" (open_latest: manifests, mmap, crc
    # verification) and "assemble" (the per-k blocks into the stratified
    # table and index, from_parts)
    load_stages: dict = dataclasses.field(default_factory=dict,
                                          compare=False)

    @property
    def nbytes(self) -> int:
        return self.pecb.nbytes()


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", name)


def key_dirname(key: str) -> str:
    """Directory name for one workload key: a sanitized readable stem plus
    a crc32 of the exact name (collision-proofing the sanitizer). The
    authoritative key lives in the manifest meta. No k component — the k
    axis collapsed into the stored strata (DESIGN.md §14)."""
    name = str(key)
    return f"{_safe(name)}__{zlib.crc32(name.encode()):08x}"


class IndexStore:
    def __init__(self, root: str, metrics=None, tracer=None, *,
                 max_chain: int = 4, keep_manifests: int = 2,
                 verify: bool = True):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._metrics = metrics
        self.tracer = tracer
        self._max_chain = int(max_chain)
        self._keep = int(keep_manifests)
        self._verify = bool(verify)
        self._lock = named_lock("store")
        self._counters = {
            "commits": 0, "commits_full": 0, "commits_delta": 0,
            "commits_noop": 0, "bytes_written": 0,
            "loads": 0, "load_bytes": 0, "recovered_commits": 0,
        }

    def _span(self, name: str, **attrs):
        if self.tracer is None:
            return NULL_SPAN
        return self.tracer.start_span(name, cat="store", **attrs)

    def _dir(self, key: str) -> str:
        return os.path.join(self.root, key_dirname(key))

    # -- write path ------------------------------------------------------
    def put_handle(self, key: str, handle, prev=None) -> dict:
        """Persist ``handle`` as key's next committed epoch. ``prev`` (the
        handle the epoch lifecycle grew/shrunk ``handle`` from) enables a
        delta commit when it matches the epoch already on disk. Returns
        ``{"mode", "epoch", "bytes_written"}``; ``mode="current"`` means
        the store already holds this epoch and nothing was written (the
        demote-after-write-through case)."""
        dirpath = self._dir(key)
        span = self._span("store_commit", workload=str(key),
                          epoch=handle.epoch)
        try:
            os.makedirs(dirpath, exist_ok=True)
            probe = open_latest(dirpath, load=False)
            on_disk = probe[0] if probe is not None else None
            if on_disk is not None and on_disk["epoch"] == handle.epoch:
                span.set("mode", "current").end()
                self._count(commits_noop=1)
                return {"mode": "current", "epoch": handle.epoch,
                        "bytes_written": 0}
            prev_pair = None
            if (prev is not None and on_disk is not None
                    and on_disk["epoch"] == prev.epoch):
                prev_pair = (on_disk, self._handle_arrays(prev))
            res = write_commit(
                dirpath, self._handle_meta(key, handle),
                self._handle_arrays(handle), prev_pair,
                max_chain=self._max_chain, keep_manifests=self._keep)
        except BaseException as exc:
            span.set("error", repr(exc)).end()
            raise
        span.set("mode", res["mode"]).set("bytes", res["bytes_written"]).end()
        self._count(commits=1, bytes_written=res["bytes_written"],
                    **{f"commits_{res['mode']}": 1})
        if self._metrics is not None:
            self._metrics.count("store_commits")
            self._metrics.count("store_commit_bytes", res["bytes_written"])
        return {"mode": res["mode"], "epoch": handle.epoch,
                "bytes_written": res["bytes_written"]}

    @staticmethod
    def _handle_meta(key: str, handle) -> dict:
        g = handle.graph
        sx = handle.pecb
        return {
            "workload": str(key),
            "epoch": int(handle.epoch),
            "n": int(g.n), "m": int(g.m), "t_max": int(g.t_max),
            "build_seconds": float(handle.build_seconds),
            "ks": [int(k) for k in sx.ks],
            "k_max_graph": int(sx.k_max_graph),
            "has_tab": handle.tab is not None,
        }

    @staticmethod
    def _handle_arrays(handle) -> dict:
        g = handle.graph
        sx: StratifiedPECB = handle.pecb
        out = {"graph.src": g.src, "graph.dst": g.dst, "graph.t": g.t}
        for k in sx.ks:
            view = sx.slice_k(k)
            for f in PECB_ARRAYS:
                out[f"pecb.k{k}.{f}"] = getattr(view, f)
        tab: StratifiedCoreTable | None = handle.tab
        if tab is not None:
            n = tab.n
            for ki, k in enumerate(tab.ks):
                lo, hi = int(tab.kptr[ki]), int(tab.kptr[ki + 1])
                vlo, vhi = ki * n, (ki + 1) * n
                rlo, rhi = int(tab.vptr[vlo]), int(tab.vptr[vhi])
                out[f"tab.k{k}.edge_id"] = tab.edge_id[lo:hi]
                out[f"tab.k{k}.ts_from"] = tab.ts_from[lo:hi]
                out[f"tab.k{k}.ts_to"] = tab.ts_to[lo:hi]
                out[f"tab.k{k}.ct"] = tab.ct[lo:hi]
                # CSR localized to the stratum (subtracting the base makes
                # it epoch-stable under *other* strata growing)
                out[f"tab.k{k}.vptr"] = tab.vptr[vlo:vhi + 1] - tab.vptr[vlo]
                out[f"tab.k{k}.v_ts_from"] = tab.v_ts_from[rlo:rhi]
                out[f"tab.k{k}.v_ts_to"] = tab.v_ts_to[rlo:rhi]
                out[f"tab.k{k}.v_ct"] = tab.v_ct[rlo:rhi]
        return out

    # -- read path -------------------------------------------------------
    def current_epoch(self, key: str) -> int | None:
        """Epoch of the newest structurally valid commit, or ``None`` —
        without loading (or crc-verifying) any array bytes."""
        probe = open_latest(self._dir(key), load=False)
        return None if probe is None else int(probe[0]["epoch"])

    def load(self, key: str) -> StoredIndex | None:
        """mmap the newest valid commit back into host index objects;
        ``None`` when the key has no loadable commit (including a legacy
        per-k directory — those carry no strata and simply miss here)."""
        dirpath = self._dir(key)
        span = self._span("store_open", workload=str(key))
        try:
            t0 = time.perf_counter()
            got = open_latest(dirpath, verify=self._verify)
            t1 = time.perf_counter()
            if got is None:
                span.set("outcome", "miss").end()
                return None
            man, arrays, recovered = got
            meta = man["meta"]
            if "ks" not in meta:
                span.set("outcome", "legacy").end()
                return None
            n, m, t_max = meta["n"], meta["m"], meta["t_max"]
            ks = tuple(int(k) for k in meta["ks"])
            g = TemporalGraph(n, arrays["graph.src"], arrays["graph.dst"],
                              arrays["graph.t"])
            tab = None
            if meta.get("has_tab"):
                tab = self._assemble_tab(n, m, t_max, ks, arrays)
            idx = self._assemble_pecb(
                g, m, t_max, ks, int(meta["k_max_graph"]), arrays, tab)
            stages = {"open": t1 - t0, "assemble": time.perf_counter() - t1}
        except BaseException as exc:
            span.set("error", repr(exc)).end()
            raise
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        span.set("epoch", meta["epoch"]).set("bytes", nbytes)
        span.set("recovered", recovered).end()
        self._count(loads=1, load_bytes=nbytes, recovered_commits=recovered)
        if self._metrics is not None:
            self._metrics.count("store_loads")
            self._metrics.count("store_load_bytes", nbytes)
            if recovered:
                self._metrics.count("store_recovered_commits", recovered)
        return StoredIndex(
            key=str(meta["workload"]), epoch=int(meta["epoch"]),
            build_seconds=float(meta.get("build_seconds", 0.0)),
            graph=g, pecb=idx, tab=tab, manifest=man, recovered=recovered,
            load_stages=stages)

    @staticmethod
    def _assemble_tab(n: int, m: int, t_max: int, ks: tuple,
                      arrays: dict) -> StratifiedCoreTable:
        """Stratified core-time table from the per-k blocks: record
        globals are one concatenation, the vertex-run CSR re-bases each
        stratum's localized ``vptr`` onto the running offset."""
        K = len(ks)
        blocks = {f: [arrays[f"tab.k{k}.{f}"] for k in ks]
                  for f in TAB_ARRAYS}
        i32 = lambda parts: (np.concatenate(parts).astype(np.int32,
                                                          copy=False)
                             if parts else np.zeros(0, np.int32))
        kptr = np.zeros(K + 1, np.int64)
        for ki in range(K):
            kptr[ki + 1] = kptr[ki] + blocks["edge_id"][ki].shape[0]
        vptr = np.zeros(K * n + 1, np.int64)
        off = 0
        for ki in range(K):
            local = blocks["vptr"][ki]
            vptr[ki * n:(ki + 1) * n + 1] = local.astype(np.int64) + off
            off += int(local[-1]) if local.shape[0] else 0
        return StratifiedCoreTable(
            n, m, t_max, ks, kptr,
            i32(blocks["edge_id"]), i32(blocks["ts_from"]),
            i32(blocks["ts_to"]), i32(blocks["ct"]),
            vptr, i32(blocks["v_ts_from"]), i32(blocks["v_ts_to"]),
            i32(blocks["v_ct"]))

    @staticmethod
    def _assemble_pecb(g: TemporalGraph, m: int, t_max: int, ks: tuple,
                       k_max_graph: int, arrays: dict,
                       tab: StratifiedCoreTable | None) -> StratifiedPECB:
        """Stratified index from the per-k blocks: each stratum's mmap'd
        arrays become a per-k :class:`PECBIndex` view and
        ``StratifiedPECB.from_parts`` re-packs them — bit-identical to
        the handle that was persisted (the per-k blocks ARE the packed
        layout's blocks). Version-store endpoints are recomputed by one
        gather over the graph arrays instead of being stored."""
        if tab is None:
            raise ValueError(
                "stratified commit lacks its core-time table; cannot "
                "rebuild the version store")
        indices = [
            PECBIndex(g.n, m, t_max, k,
                      *(arrays[f"pecb.k{k}.{f}"] for f in PECB_ARRAYS),
                      versions=None)
            for k in ks]
        eid = tab.edge_id
        return StratifiedPECB.from_parts(
            tab, indices, k_max_graph,
            ver_src=np.asarray(g.src)[eid].astype(np.int32),
            ver_dst=np.asarray(g.dst)[eid].astype(np.int32),
            ver_t=np.asarray(g.t)[eid].astype(np.int32))

    def keys(self) -> list[str]:
        """Every workload key with at least one valid *stratified* commit
        on disk (legacy per-k directories are skipped)."""
        out = []
        for entry in sorted(os.listdir(self.root)):
            probe = open_latest(os.path.join(self.root, entry), load=False)
            if probe is not None and "ks" in probe[0]["meta"]:
                out.append(str(probe[0]["meta"]["workload"]))
        return out

    def load_graph(self, name: str):
        """``(graph, epoch)`` of workload ``name``'s newest stored epoch —
        the warm path for ``resolve_graph`` on an unregistered name — or
        ``None``. Graph arrays are *copied* out of the mapping: the
        adopted graph outlives any one commit's files. Legacy per-k
        directories still qualify here (their graph arrays are identical),
        so adoption survives a store written before the k collapse."""
        best = None
        for entry in sorted(os.listdir(self.root)):
            dirpath = os.path.join(self.root, entry)
            probe = open_latest(dirpath, load=False)
            if probe is None or probe[0]["meta"]["workload"] != name:
                continue
            if best is None or probe[0]["epoch"] > best[0]["epoch"]:
                best = (probe[0], dirpath)
        if best is None:
            return None
        man, dirpath = best
        arrays = load_arrays(dirpath, man,
                             names={"graph.src", "graph.dst", "graph.t"},
                             verify=self._verify)
        g = TemporalGraph(man["meta"]["n"],
                          arrays["graph.src"].copy(),
                          arrays["graph.dst"].copy(),
                          arrays["graph.t"].copy())
        return g, int(man["epoch"])

    # -- accounting ------------------------------------------------------
    def _count(self, **deltas) -> None:
        with self._lock:
            for name, d in deltas.items():
                self._counters[name] += int(d)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
        out["root"] = self.root
        return out
