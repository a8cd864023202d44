"""Index registry: build, memoize, evict (StratifiedPECB, Device) index
pairs (DESIGN.md §7.4, §14). PyTorch port of ``repro.serving.registry``.

One engine serves many workloads concurrently — a contact tracer asks k=2
and k=3 over the same graph, a dashboard watches five graphs. Index
construction is the offline plane (seconds); queries are the online plane
(microseconds). The registry keeps that split honest: the first request
for a workload pays ONE k-stratified build (`build_stratified_index` —
one fused core-time sweep plus one forest per stratum), and everyone
after gets the memoized handle, which answers *every* supported k;
capacity-bounded LRU eviction drops cold workloads.

Keys are workload names. The pre-stratified registry keyed residency by
``(workload, k)`` and built |K| independent indexes per graph; that key
space is collapsed — the k axis now lives inside the handle
(``handle.supported_ks``), and the legacy two-argument lookups remain as
``DeprecationWarning`` shims that ignore the k.

Which strata a workload gets is the registry's ``ks`` policy: the
default (``None``) covers the graph's full useful range
``default_ks(g)`` = 2..k_max(g); a global tuple or a per-workload
``set_ks`` override bounds |K| for graphs whose degeneracy makes the
full range wasteful. Queries for a k above ``k_max`` are exactly empty
and need no stratum; an in-range k outside the policy raises
``InvalidQueryError`` at answer time.

Builds run on a small background pool and are exposed three ways:

* ``get_async`` — returns a ``Future[IndexHandle]`` immediately; a
  thundering herd on a cold workload coalesces onto one pending future,
  while distinct workloads build in parallel (bounded by
  ``build_workers``).
* ``get_nowait`` — non-blocking probe; on a miss it (optionally) kicks off
  the background build and returns ``None`` so the caller's thread never
  blocks behind a multi-second build (the engine's submit path uses this).
* ``get`` — the blocking convenience wrapper (``get_async().result()``).

Each build records per-stage wall times (stratified core times, forests,
device upload) on the handle and into the metrics sink
(``index_build_<stage>``).

Graphs resolve by name: either registered explicitly (``register_graph``)
or one of the named bench workloads (``BENCH_WORKLOADS``).

Streaming epochs (DESIGN.md §9): ``extend_graph(name, edges)`` appends a
timestamp suffix to a registered graph and *refreshes* the resident
handle incrementally on a dedicated background worker
(``extend_stratified_core_times`` + ``extend_stratified_index`` +
``refresh_device`` — bit-identical to a cold rebuild for every stratum,
at a fraction of the cost; strata the appended edges add, e.g. a raised
k_max under the default policy, are built cold inside the same swap).
Handles are immutable and **epoch-versioned**: the swap into the
registry is atomic under the registry lock, so queries keep being
answered against the old epoch's handle until the refresh lands, and
in-flight batches holding the old handle stay consistent (its graph,
index and device mirror describe one snapshot). Refresh listeners
(``add_refresh_listener``) let the engine retire the old handle's
batcher and run the *targeted* result-cache purge.

Devices: the registry serves a list of shards (``devices=``, the
executor's list: by default every visible card, each once, or ``"cuda"``
when none is visible; ``device=`` is the one-device spelling). Every
build, refresh and trim runs on the first, ``device``: the core times
through the port's stratified sweep on that device (one ``stratum_sweep``
kernel launch per t_uv block on CUDA, the host sweep on the CPU), the
forests on the host, the mirror uploaded to it. Each further shard gets
its own replica of the mirror (``IndexHandle.replicas``), a card-to-card
copy, or for a refresh or trim the same upload of what changed where
that moves fewer bytes (``batch_query.refresh_replicas``). Every replica
is made before the handle is swapped in, so no batch mixes two epochs
across shards. With no card the default registry raises on its first
build; it never carries on on the CPU.

Disk tier (DESIGN.md §13): with a :class:`~repro_torch.store.IndexStore`
attached, the registry is durable — cold builds first try *promotion*
(mmap the stored epoch + upload to the registry's devices, no rebuild),
landed builds and epoch swaps are written through (suffix epochs as
per-stratum deltas), LRU eviction *demotes* instead of discarding, and
unregistered workload names resolve from the store's persisted graphs, so
a restarted process warm-opens without a build. A store failure costs
durability, not serving (the build proceeds as if no store were
attached), and is counted (``store_load_failures``,
``store_commit_failures``); a failed upload of a promoted index to the
device raises like a failed build's upload.

Retention (DESIGN.md §10): ``retain(name, t_cut)`` is the epoch
lifecycle's second leg — prefix expiry. It expires edges below ``t_cut``,
rebinds the name to the shifted epoch immediately, and *shrinks* the
resident handle on the same FIFO refresh worker
(``shrink_stratified_core_times`` + ``shrink_stratified_index`` +
``refresh_device`` — bit-identical to a cold build of the trimmed edge
list, at slicing cost; strata above the trimmed graph's k_max drop), so
a long-running ingest+trim loop holds index, table and device-mirror
memory bounded. Retention listeners (``add_retention_listener``) receive
``(key, old, new, t_cut)`` so the engine can purge expired cache windows
and rehome the survivors into the shifted timeline.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from repro_torch.obs.locks import named_lock
from repro_torch.obs.trace import NULL_SPAN
from repro_torch.core.temporal_graph import (BENCH_WORKLOADS, TemporalGraph,
                                             bench_graph)
from repro_torch.core.core_time import (StratifiedCoreTable, _validate_ks,
                                        default_ks,
                                        extend_stratified_core_times,
                                        kcore_device,
                                        shrink_stratified_core_times,
                                        stratified_core_times)
from repro_torch.core.pecb_index import StratifiedPECB, build_stratified_index
from repro_torch.core.streaming import (extend_stratified_index,
                                        shrink_stratified_index)
from repro_torch.core.batch_query import (DeviceIndex, refresh_replicas,
                                          replicas_of, stratum_device,
                                          to_device)

from .executor import shard_devices

_K_KEY_DEPRECATION = (
    "per-k registry keys are deprecated: one k-stratified index serves "
    "every k — pass the workload name alone (the k argument is ignored; "
    "check handle.supported_ks)")


def _coerce_key(key) -> str:
    """Workload key from either the modern string or the legacy
    ``(workload, k)`` tuple (DeprecationWarning — the k axis lives inside
    the handle now)."""
    if isinstance(key, tuple):
        warnings.warn(_K_KEY_DEPRECATION, DeprecationWarning, stacklevel=3)
        return str(key[0])
    return str(key)


@dataclasses.dataclass(frozen=True)
class IndexHandle:
    """One workload's built k-stratified index: host arrays + device mirror.

    ``pecb`` answers every k in :attr:`supported_ks` (and every
    ``k > k_max(graph)`` exactly empty); ``device`` is the fused mixed-k
    mirror on the registry's first device, every k in one device batch,
    and ``replicas`` holds one such mirror per shard of the registry
    (``replicas[0] is device``; one epoch on all of them).
    ``epoch`` counts epoch mutations of the workload's graph; ``tab`` is the
    epoch's stratified core-time table, retained so the next refresh can
    extend every stratum in place."""

    key: str                      # workload name
    graph: TemporalGraph
    pecb: StratifiedPECB
    device: DeviceIndex
    build_seconds: float
    build_stages: dict = dataclasses.field(default_factory=dict, compare=False)
    epoch: int = 0
    tab: StratifiedCoreTable | None = dataclasses.field(default=None,
                                                        compare=False)
    # how the host arrays got here: "build" (cold construction or epoch
    # refresh) vs "disk" (promoted from the persistent store — mmap + device
    # upload, no rebuild). The planner stamps this onto result provenance.
    source: str = dataclasses.field(default="build", compare=False)
    # one mirror per shard, ``device`` first; empty means ``(device,)``
    replicas: tuple = dataclasses.field(default=(), compare=False,
                                        repr=False)
    # lazy per-k slices of the fused mirrors for single-k launches (the
    # window sweep) — see :meth:`stratum_device`
    _stratum_dev: dict = dataclasses.field(default_factory=dict,
                                           compare=False, repr=False)

    def __post_init__(self):
        if not self.replicas:
            object.__setattr__(self, "replicas", (self.device,))
        elif self.replicas[0] is not self.device:
            raise ValueError("replicas[0] must be the handle's device "
                             "mirror")

    @property
    def supported_ks(self) -> tuple:
        return self.pecb.supported_ks

    def stratum_device(self, k: int, shard: int = 0) -> DeviceIndex:
        """Stratum ``k``'s block of replica ``shard`` as a standalone per-k
        mirror (``batch_query.stratum_device``), so single-k launches pay
        propagation on one stratum's nodes instead of all |K|. Memoized
        per (k, shard) for the handle's lifetime — handles are immutable
        and swapped whole per epoch, so the memo can never go stale; the
        unlocked dict is a benign race (two threads may slice the same
        block, one result wins). Raises ``KeyError`` for an unsupported
        k."""
        key = (int(k), int(shard))
        dev = self._stratum_dev.get(key)
        if dev is None:
            dev = stratum_device(self.replicas[shard], self.pecb, key[0])
            self._stratum_dev[key] = dev
        return dev

    def stratum_replicas(self, k: int) -> tuple[DeviceIndex, ...]:
        """:meth:`stratum_device` of every shard, in shard order."""
        return tuple(self.stratum_device(k, i)
                     for i in range(len(self.replicas)))

    @property
    def nbytes(self) -> int:
        return self.pecb.nbytes()

    @property
    def device_nbytes(self) -> int:
        """Device bytes of the mirrors, summed over the replicas."""
        return sum(r.nbytes() for r in self.replicas)

    @property
    def tab_nbytes(self) -> int:
        """Bytes retained for the refresh path: the stratified core-time
        table — per-k record blocks plus the run-length-encoded vertex
        core times. This replaces what used to be |K| per-handle dense
        ``(t_max+1, n)`` matrices and |K| version stores; the RLE strata
        are the memory lever behind the one-build-serves-every-k claim
        (asserted by the construction bench). Kept out of :attr:`nbytes`
        so the paper's index-size comparison stays undistorted, but
        surfaced in the registry's ``resident_tab_bytes`` stat because it
        is real, per-handle resident memory."""
        if self.tab is None:
            return 0
        return self.tab.nbytes()


class IndexRegistry:
    def __init__(self, capacity: int = 8, metrics=None, on_evict=None,
                 build_workers: int = 2, tracer=None, store=None, *,
                 ks=None, devices=None, device=None):
        if capacity < 1:
            raise ValueError(f"registry capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        # the shards a handle holds a replica for; builds run on the first
        self.devices = shard_devices(devices, device)
        self.device = self.devices[0]
        self._metrics = metrics
        # optional repro_torch.store.IndexStore: the disk tier (DESIGN.md
        # §13.4). All store I/O runs on the background build/refresh
        # workers, never under the registry lock.
        self._store = store
        # optional repro_torch.obs.trace.Tracer: background builds / refreshes /
        # retention trims record spans (the engine passes its tracer when
        # it owns the registry). Epoch mutations accept an explicit parent
        # SpanContext so refresh spans nest under the ingest/retain span
        # that scheduled them — across the FIFO worker thread boundary
        # (DESIGN.md §11.2).
        self.tracer = tracer
        # strata policy: which ks each workload's one stratified build
        # covers. None = the full useful range default_ks(g) (2..k_max);
        # a tuple bounds |K| globally; set_ks() overrides per workload.
        self._default_ks = None if ks is None else _validate_ks(ks)
        self._ks_policy: dict[str, tuple] = {}
        # evict listeners: called as cb(key, handle) after an entry leaves
        # the registry (outside the registry lock). A list, not a slot:
        # several engines may share one registry (the bench does), and each
        # needs to retire its own batcher on eviction.
        self._evict_listeners: list = []
        if on_evict is not None:
            self._evict_listeners.append(on_evict)
        # refresh listeners: called as cb(key, old_handle, new_handle) after
        # an epoch refresh atomically swapped the resident handle
        self._refresh_listeners: list = []
        # retention listeners: called as cb(key, old_handle, new_handle,
        # t_cut) after a retention trim atomically swapped the resident
        # handle (the engine runs the shifted cache purge/rehome here)
        self._retention_listeners: list = []
        self._graphs: dict[str, TemporalGraph] = {}
        self._epochs: dict[str, int] = {}
        self._entries: "OrderedDict[str, IndexHandle]" = OrderedDict()
        self._lock = named_lock("registry")
        self._pending: dict[str, Future] = {}
        self._build_workers = max(1, int(build_workers))
        self._pool: ThreadPoolExecutor | None = None
        # refreshes run on their own single worker: FIFO, so chained
        # extend_graph calls refresh each workload in epoch order
        self._refresh_pool: ThreadPoolExecutor | None = None
        self.builds = 0
        self.evictions = 0
        self.refreshes = 0
        self.retentions = 0
        self.promotions = 0      # cold builds answered from the disk tier
        self.demotions = 0       # evictions preserved into the disk tier
        # store failures degraded to a cold build / a skipped commit
        self.store_load_failures = 0
        self.store_commit_failures = 0

    def add_evict_listener(self, cb) -> None:
        with self._lock:
            self._evict_listeners.append(cb)

    def remove_evict_listener(self, cb) -> None:
        with self._lock:
            if cb in self._evict_listeners:
                self._evict_listeners.remove(cb)

    def add_refresh_listener(self, cb) -> None:
        with self._lock:
            self._refresh_listeners.append(cb)

    def remove_refresh_listener(self, cb) -> None:
        with self._lock:
            if cb in self._refresh_listeners:
                self._refresh_listeners.remove(cb)

    def add_retention_listener(self, cb) -> None:
        with self._lock:
            self._retention_listeners.append(cb)

    def remove_retention_listener(self, cb) -> None:
        with self._lock:
            if cb in self._retention_listeners:
                self._retention_listeners.remove(cb)

    def _span(self, name: str, parent=None, **attrs):
        """Background-plane span, or the inert NULL_SPAN when untraced."""
        if self.tracer is None:
            return NULL_SPAN
        return self.tracer.start_span(name, parent=parent, cat="index",
                                      **attrs)

    # -- strata policy ----------------------------------------------------
    def set_ks(self, workload: str, ks) -> None:
        """Pin the strata the next (re)build of ``workload`` covers.
        ``None`` reverts to the registry default. Raises while the
        workload is resident or building — the policy must not fork from
        what the resident handle actually serves."""
        with self._lock:
            if workload in self._entries or workload in self._pending:
                raise RuntimeError(
                    f"cannot change ks policy for resident workload "
                    f"{workload!r}; evict or close first")
            if ks is None:
                self._ks_policy.pop(workload, None)
            else:
                self._ks_policy[workload] = _validate_ks(ks)

    def _ks_for(self, workload: str, g: TemporalGraph) -> tuple:
        with self._lock:
            explicit = self._ks_policy.get(workload, self._default_ks)
        if explicit is not None:
            return explicit
        return default_ks(g, kcore_device("auto", self.device))

    # -- graph sources --------------------------------------------------
    def register_graph(self, name: str, g: TemporalGraph) -> None:
        """Bind ``name`` to a graph, immutably: indexes, cached results and
        batchers are all keyed by name, so silently rebinding a name would
        keep serving answers for the old graph. Re-registering the *same*
        object is a no-op; a different one raises — publish new snapshots
        under new names (e.g. ``"contacts@2026-07-31"``), or grow the bound
        graph with suffix edges through :meth:`extend_graph` (the epoch
        plane keeps every derived artifact consistent)."""
        with self._lock:
            prev = self._graphs.get(name)
            if prev is not None and prev is not g:
                raise ValueError(
                    f"graph name {name!r} is already bound; names are "
                    "immutable — register the new snapshot under a new name")
            self._graphs[name] = g

    def resolve_graph(self, name: str) -> TemporalGraph:
        with self._lock:
            if name in self._graphs:
                return self._graphs[name]
        # warm-restart adoption: a store holding this workload's persisted
        # epochs rebinds the name (and its epoch counter) from disk, so a
        # restarted process can keep serving — and keep ingesting — a graph
        # the previous process registered, without re-registration
        if self._store is not None:
            try:
                got = self._store.load_graph(name)
            except Exception:
                got = None   # adoption is best-effort; fall through
            if got is not None:
                g, epoch = got
                with self._lock:
                    if name not in self._graphs:
                        self._graphs[name] = g
                        self._epochs[name] = epoch
                    return self._graphs[name]
        if name in BENCH_WORKLOADS:
            g = bench_graph(name)
            # concurrent cold builds of different workloads race to generate
            # the same bench graph: first registration wins, losers adopt it
            # (bench_graph is deterministic, so either copy is identical)
            with self._lock:
                return self._graphs.setdefault(name, g)
        raise KeyError(
            f"unknown workload {name!r}: register_graph() it or use one of "
            f"{sorted(BENCH_WORKLOADS)}"
        )

    # -- streaming epochs -------------------------------------------------
    def extend_graph(self, name: str, edges,
                     parent=None) -> dict[str, "Future[IndexHandle]"]:
        """Append suffix ``edges`` to workload ``name`` and refresh its
        resident stratified index incrementally in the background.

        The graph rebind and epoch bump happen immediately (new cold builds
        see the new epoch); the resident handle keeps serving until its
        refreshed replacement is atomically swapped in. Returns a
        ``{workload: Future}`` dict (at most one entry), resolving with the
        refreshed handle. Suffix violations (historical timestamps, unknown
        vertices) raise here, before anything is mutated. ``parent`` (a
        span or SpanContext) parents the background ``index_refresh`` span
        under the caller's trace (DESIGN.md §11.2).
        """
        with self._lock:
            g = self._graphs.get(name)
        if g is None:
            g = self.resolve_graph(name)
        g2 = g.extend(edges)                 # raises on non-suffix input
        futures: dict = {}
        with self._lock:
            if self._graphs.get(name) is not g:
                raise RuntimeError(
                    f"concurrent extend_graph({name!r}); serialize ingests")
            if g2 is g:                      # empty append: nothing to do
                return {}
            self._graphs[name] = g2
            epoch = self._epochs.get(name, 0) + 1
            self._epochs[name] = epoch
            handle = self._entries.get(name)
            if handle is not None and self._refresh_pool is None:
                self._refresh_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="registry-refresh")
            if handle is not None:
                fut: Future = Future()
                futures[name] = fut
                self._refresh_pool.submit(
                    self._run_refresh, name, handle, g2, epoch, fut, parent)
        return futures

    def _run_refresh(self, key: str, old: IndexHandle, g2: TemporalGraph,
                     epoch: int, fut: Future, parent=None) -> None:
        span = self._span("index_refresh", parent=parent,
                          workload=key, epoch=epoch)
        try:
            # re-read the resident handle: the FIFO worker guarantees every
            # previously scheduled epoch mutation has landed, so a chain
            # like retain -> extend must grow from the *trimmed* handle the
            # shrink just swapped in, not the pre-trim handle captured at
            # schedule time (whose graph g2 no longer suffix-extends).
            # Chained suffix ingests also benefit: each refresh grows from
            # the latest epoch instead of re-deriving from the oldest.
            with self._lock:
                cur = self._entries.get(key)
            if cur is not None and cur.epoch >= epoch:
                span.set("outcome", "superseded").end()
                fut.set_result(cur)      # a newer epoch already landed
                return
            if cur is not None and cur.epoch > old.epoch:
                old = cur
            stages = {}
            t0 = time.perf_counter()
            if old.tab is None:
                raise RuntimeError(
                    f"handle {key!r} carries no stratified core-time table; "
                    "cannot refresh incrementally")
            ks = self._ks_for(key, g2)
            t1 = time.perf_counter()
            tab2 = extend_stratified_core_times(g2, old.tab, ks,
                                                device=self.device)
            stages["core_times"] = time.perf_counter() - t1
            span.child("core_times", t0=t1).end()
            t1 = time.perf_counter()
            idx2 = extend_stratified_index(g2, old.pecb, ks, strata=tab2,
                                           device=self.device)
            stages["forest"] = time.perf_counter() - t1
            span.child("forest", t0=t1).end()
            t1 = time.perf_counter()
            reps, upload = refresh_replicas(old.pecb, old.replicas, idx2)
            stages["device"] = time.perf_counter() - t1
            span.child("device", t0=t1).end()
            total = time.perf_counter() - t0
            handle = IndexHandle(key, g2, idx2, reps[0], total, stages,
                                 epoch=epoch, tab=tab2, replicas=reps)
        except BaseException as exc:
            # failures must be observable even when nobody holds the future
            # (the build-race catch-up path): a failed refresh otherwise
            # leaves the registry silently serving the pre-ingest epoch
            if self._metrics is not None:
                self._metrics.count("index_refresh_failures")
            span.set("error", repr(exc)).end()
            fut.set_exception(exc)
            return
        swapped, replaced, listeners = self._swap_epoch_handle(
            key, old, handle, epoch, kind="refresh")
        if self._metrics is not None:
            self._metrics.count("index_refreshes")
            self._metrics.observe("index_refresh", total)
            for stage, seconds in stages.items():
                self._metrics.observe(f"index_refresh_{stage}", seconds)
            self._metrics.count("refresh_upload_bytes",
                                upload["uploaded_bytes"])
            self._metrics.count("refresh_reused_bytes",
                                upload["reused_bytes"])
            if upload["replicated_bytes"]:
                self._metrics.count("refresh_replicated_bytes",
                                    upload["replicated_bytes"])
        span.set("swapped", swapped).end()
        if swapped:
            # delta commit against the epoch the store already holds (the
            # replaced handle was written through when it landed); runs on
            # this FIFO worker, so per-key commits stay strictly ordered
            self._persist(key, handle, prev=replaced)
            for cb in listeners:
                cb(key, replaced, handle)
        fut.set_result(handle)

    def _swap_epoch_handle(self, key: str, grown_from: IndexHandle,
                           handle: IndexHandle, epoch: int, kind: str):
        """Atomic epoch-handle swap shared by refresh and shrink workers.

        Replaces the handle the worker grew from, or — chained epoch
        mutations: a prior worker may have already swapped a lower-epoch
        handle in — any resident handle of an older epoch. An eviction
        race (no resident entry) drops the new handle; the next cold
        build sees the new graph. Returns ``(swapped, replaced handle,
        listener snapshot)``; listeners are dispatched by the caller,
        outside the lock."""
        with self._lock:
            cur = self._entries.get(key)
            swapped = (cur is grown_from
                       or (cur is not None and cur.epoch < epoch))
            if swapped:
                self._entries[key] = handle
                self._entries.move_to_end(key)
            if kind == "refresh":
                self.refreshes += 1
                listeners = list(self._refresh_listeners)
            else:
                self.retentions += 1
                listeners = list(self._retention_listeners)
        return swapped, cur, listeners

    # -- retention (prefix expiry) ----------------------------------------
    def retain(self, name: str, t_cut: int,
               parent=None) -> dict[str, "Future[IndexHandle]"]:
        """Expire every edge of workload ``name`` with timestamp
        ``< t_cut`` and shrink the resident stratified index to the
        shifted retained epoch in the background (DESIGN.md §10).

        Mirrors :meth:`extend_graph`: the graph rebind and epoch bump are
        immediate (new cold builds see the trimmed epoch), the resident
        handle keeps serving until its shrunk replacement is atomically
        swapped in, and the returned ``{workload: Future}`` resolves with
        the swapped handle (``None`` if the workload was evicted before
        its trim ran). Trims share the single FIFO refresh worker with
        suffix refreshes, so an ``extend_graph`` + ``retain`` chain lands
        in order: the shrink always runs against the fully caught-up
        resident handle. ``t_cut <= 1`` trims nothing and returns ``{}``.
        """
        with self._lock:
            g = self._graphs.get(name)
        if g is None:
            g = self.resolve_graph(name)
        g2 = g.expire_before(t_cut)
        futures: dict = {}
        with self._lock:
            if self._graphs.get(name) is not g:
                raise RuntimeError(
                    f"concurrent extend/retain on {name!r}; serialize "
                    "epoch mutations")
            if g2 is g:                      # nothing expires: no-op
                return {}
            self._graphs[name] = g2
            epoch = self._epochs.get(name, 0) + 1
            self._epochs[name] = epoch
            if name in self._entries and self._refresh_pool is None:
                self._refresh_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="registry-refresh")
            if name in self._entries:
                fut: Future = Future()
                futures[name] = fut
                self._refresh_pool.submit(
                    self._run_shrink, name, g, g2, int(t_cut), epoch, fut,
                    parent)
        return futures

    def _run_shrink(self, key: str, g_old: TemporalGraph, g2: TemporalGraph,
                    t_cut: int, epoch: int, fut: Future,
                    parent=None) -> None:
        """FIFO-worker body of one (workload, trim). Unlike ``_run_refresh``
        (which grows from the handle captured at schedule time — valid
        because extending from *any* older suffix epoch works), the shrink
        re-reads the resident handle here: the FIFO worker guarantees
        every previously scheduled refresh has landed, so the resident
        handle describes exactly the pre-cut binding ``g_old``."""
        span = self._span("index_retention", parent=parent,
                          workload=key, epoch=epoch, t_cut=t_cut)
        try:
            with self._lock:
                cur = self._entries.get(key)
            if cur is None:
                span.set("outcome", "evicted").end()
                fut.set_result(None)     # evicted mid-queue: next cold
                return                   # build sees the trimmed epoch
            if cur.epoch >= epoch or cur.graph is g2:
                span.set("outcome", "superseded").end()
                fut.set_result(cur)      # a cold build already caught up
                return
            stages = {}
            t0 = time.perf_counter()
            # expiry can only lower coreness, so the target strata are a
            # subset of the resident ones under the default policy; an
            # explicit policy intersects with what is actually resident
            # (strata that were never built cannot be shrunk — and expiry
            # cannot create the need for one)
            ks = tuple(k for k in self._ks_for(key, g2)
                       if k in cur.pecb.supported_ks)
            if cur.graph is g_old and cur.tab is not None:
                t1 = time.perf_counter()
                tab2 = shrink_stratified_core_times(g2, cur.tab, ks)
                stages["core_times"] = time.perf_counter() - t1
                span.child("core_times", t0=t1).end()
                t1 = time.perf_counter()
                idx2 = shrink_stratified_index(g2, cur.pecb, ks,
                                               strata=tab2,
                                               device=self.device)
                stages["forest"] = time.perf_counter() - t1
                span.child("forest", t0=t1).end()
            else:
                # resident handle does not describe the pre-cut epoch (a
                # cold-build race stored an intermediate snapshot): fall
                # back to an exact cold build of the trimmed graph
                ks = self._ks_for(key, g2)
                t1 = time.perf_counter()
                tab2 = stratified_core_times(g2, ks, device=self.device)
                stages["core_times"] = time.perf_counter() - t1
                span.child("core_times", t0=t1, cold=True).end()
                t1 = time.perf_counter()
                idx2 = build_stratified_index(g2, ks, strata=tab2,
                                              device=self.device)
                stages["forest"] = time.perf_counter() - t1
                span.child("forest", t0=t1, cold=True).end()
            t1 = time.perf_counter()
            reps, upload = refresh_replicas(cur.pecb, cur.replicas, idx2)
            stages["device"] = time.perf_counter() - t1
            span.child("device", t0=t1).end()
            total = time.perf_counter() - t0
            handle = IndexHandle(key, g2, idx2, reps[0], total, stages,
                                 epoch=epoch, tab=tab2, replicas=reps)
        except BaseException as exc:
            if self._metrics is not None:
                self._metrics.count("index_retention_failures")
            span.set("error", repr(exc)).end()
            fut.set_exception(exc)
            return
        swapped, replaced, listeners = self._swap_epoch_handle(
            key, cur, handle, epoch, kind="retention")
        if self._metrics is not None:
            self._metrics.count("index_retentions")
            self._metrics.observe("index_retention", total)
            for stage, seconds in stages.items():
                self._metrics.observe(f"index_retention_{stage}", seconds)
            self._metrics.count("retention_freed_bytes",
                                upload["freed_bytes"])
        span.set("swapped", swapped).end()
        if swapped:
            # prefix-expiry epochs rarely delta (arrays shrink and shift),
            # but put_handle still avoids a rewrite when nothing changed
            self._persist(key, handle, prev=replaced)
            for cb in listeners:
                cb(key, replaced, handle, t_cut)
        fut.set_result(handle)

    # -- handle lookup ---------------------------------------------------
    def get(self, workload: str, k: int | None = None,
            timeout: float | None = None) -> IndexHandle:
        """Blocking lookup: memoized handle, or wait for the build. The
        handle answers every supported k; passing ``k`` is deprecated."""
        if k is not None:
            warnings.warn(_K_KEY_DEPRECATION, DeprecationWarning,
                          stacklevel=2)
        return self.get_async(workload).result(timeout=timeout)

    def get_nowait(self, workload: str, k: int | None = None, *,
                   start_build: bool = True) -> IndexHandle | None:
        """Non-blocking probe. On a miss, optionally schedule the
        background build (so a later probe hits) and return ``None``."""
        if k is not None:
            warnings.warn(_K_KEY_DEPRECATION, DeprecationWarning,
                          stacklevel=2)
        key = str(workload)
        with self._lock:
            h = self._entries.get(key)
            if h is not None:
                self._entries.move_to_end(key)
                return h
        if start_build:
            self.get_async(key)
        return None

    def get_async(self, workload: str,
                  k: int | None = None) -> "Future[IndexHandle]":
        """Future resolving to the built handle; build failures (including
        unknown workloads) surface as the future's exception. Concurrent
        callers of one cold workload share a single pending future."""
        if k is not None:
            warnings.warn(_K_KEY_DEPRECATION, DeprecationWarning,
                          stacklevel=2)
        key = str(workload)
        with self._lock:
            h = self._entries.get(key)
            if h is not None:
                self._entries.move_to_end(key)
                fut: Future = Future()
                fut.set_result(h)
                return fut
            fut = self._pending.get(key)
            if fut is not None:
                return fut
            fut = Future()
            self._pending[key] = fut
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._build_workers,
                    thread_name_prefix="build-pool")
            # submit under the lock: close() also takes it, so the pool
            # cannot shut down between registering the pending future and
            # scheduling its build
            try:
                self._pool.submit(self._run_build, key, fut)
            except RuntimeError as exc:   # pool raced to shutdown anyway
                self._pending.pop(key, None)
                fut.set_exception(exc)
        return fut

    def _run_build(self, key: str, fut: Future) -> None:
        try:
            handle = self._build(key)
        except BaseException as exc:
            with self._lock:
                self._pending.pop(key, None)
            fut.set_exception(exc)
            return
        # write-through *before* the future resolves: once any caller has
        # seen the handle, a crash (even kill -9) must find this epoch on
        # disk
        self._persist(key, handle)
        evicted = []
        catchup = None
        with self._lock:
            self._pending.pop(key, None)
            self._entries[key] = handle
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                evicted.append(self._entries.popitem(last=False))
                self.evictions += 1
                if self._metrics is not None:
                    self._metrics.count("index_evictions")
            listeners = list(self._evict_listeners)
            # an extend_graph that ran while this build was in flight found
            # no resident entry to refresh; catch the stored handle up to
            # the current epoch now, or it would serve pre-ingest data
            # until the next ingest
            cur_g = self._graphs.get(key)
            if (cur_g is not None and cur_g is not handle.graph
                    and self._entries.get(key) is handle):
                if self._refresh_pool is None:
                    self._refresh_pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="registry-refresh")
                # capture the pool under the lock: close() nulls the
                # attribute, and the build future must resolve regardless
                catchup = (self._refresh_pool, handle, cur_g,
                           self._epochs.get(key, 0))
        for (k2, h2) in evicted:
            self._demote(k2, h2)
            for cb in listeners:
                cb(k2, h2)
        fut.set_result(handle)
        if catchup is not None:
            pool, stale, cur_g, epoch = catchup
            try:
                pool.submit(self._run_refresh, key, stale, cur_g, epoch,
                            Future())
            except RuntimeError:
                pass   # registry closing: stale data is moot

    def _build(self, key: str) -> IndexHandle:
        workload = key
        g = self.resolve_graph(workload)
        with self._lock:
            # re-read graph and epoch together: an extend_graph between the
            # resolve and here must not yield a new epoch number stamped on
            # an old graph (or vice versa)
            g = self._graphs.get(workload, g)
            epoch = self._epochs.get(workload, 0)
        ks = self._ks_for(workload, g)
        if self._store is not None:
            promoted = self._promote(key, g, epoch, ks)
            if promoted is not None:
                return promoted
        span = self._span("index_build", workload=workload,
                          num_strata=len(ks), epoch=epoch)
        stages = {}
        try:
            t0 = time.perf_counter()
            tab = stratified_core_times(g, ks, device=self.device)
            stages["core_times"] = time.perf_counter() - t0
            span.child("core_times", t0=t0).end()
            t1 = time.perf_counter()
            idx = build_stratified_index(g, ks, strata=tab,
                                         device=self.device)
            stages["forest"] = time.perf_counter() - t1
            span.child("forest", t0=t1).end()
            t1 = time.perf_counter()
            reps = replicas_of(to_device(idx, self.device), self.devices)
            stages["device"] = time.perf_counter() - t1
            span.child("device", t0=t1).end()
            total = time.perf_counter() - t0
        except BaseException as exc:
            span.set("error", repr(exc)).end()
            raise
        span.end()
        handle = IndexHandle(key, g, idx, reps[0], total, stages,
                             epoch=epoch, tab=tab, replicas=reps)
        with self._lock:
            # under the lock: concurrent builds of *different* workloads
            # would otherwise lose increments (read-modify-write race)
            self.builds += 1
        if self._metrics is not None:
            self._metrics.count("index_builds")
            self._metrics.observe("index_build", total)
            for stage, seconds in stages.items():
                self._metrics.observe(f"index_build_{stage}", seconds)
        return handle

    # -- disk tier (DESIGN.md §13.4) --------------------------------------
    def _count_store_failure(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)
        if self._metrics is not None:
            self._metrics.count(name)

    def _promote(self, key: str, g: TemporalGraph, epoch: int,
                 ks: tuple) -> IndexHandle | None:
        """Try to answer a cold build from the store: mmap the stored
        epoch, check it describes exactly the graph the build would target
        (same edge arrays — epoch counters reset across processes, so the
        arrays are authoritative) AND the strata the current policy asks
        for, upload it to the registry's first device and replicate it to
        the others, and mint a ``source="disk"`` handle. ``None`` on a miss, a mismatch or a
        failed load (counted as ``store_load_failures``) — the caller falls
        through to the cold build. A failed upload raises: it is the
        device failing, not the store, and a rebuild would upload again.

        Stages: ``open`` (``open_latest`` with crc verification),
        ``assemble`` (``from_parts``: the per-k blocks into the stratified
        index and table) and ``device`` (the upload); ``build_seconds`` is
        their sum."""
        span = self._span("index_promote", workload=key, epoch=epoch)
        try:
            stored = self._store.load(key)
        except Exception as exc:
            self._count_store_failure("store_load_failures")
            span.set("error", repr(exc)).end()
            return None
        if stored is None:
            span.set("outcome", "miss").end()
            return None
        sg = stored.graph
        if not (sg.n == g.n and sg.m == g.m
                and np.array_equal(sg.src, g.src)
                and np.array_equal(sg.dst, g.dst)
                and np.array_equal(sg.t, g.t)):
            span.set("outcome", "stale").end()
            return None
        if tuple(stored.pecb.supported_ks) != tuple(ks):
            span.set("outcome", "ks-mismatch").end()
            return None
        stages = dict(stored.load_stages)
        t0 = time.perf_counter()
        try:
            reps = replicas_of(to_device(stored.pecb, self.device),
                               self.devices)
        except BaseException as exc:
            span.set("error", repr(exc)).end()
            raise
        stages["device"] = time.perf_counter() - t0
        total = sum(stages.values())
        span.child("device", t0=t0).end()
        span.set("outcome", "promoted").end()
        with self._lock:
            self.promotions += 1
        if self._metrics is not None:
            self._metrics.count("promotions")
            self._metrics.observe("index_promote", total)
            for stage, seconds in stages.items():
                self._metrics.observe(f"index_promote_{stage}", seconds)
        # the handle binds the *registry's* graph object (identity matters
        # to the epoch lifecycle), the store's mmap-backed index arrays,
        # and the fresh device mirror
        return IndexHandle(key, g, stored.pecb, reps[0], total, stages,
                           epoch=epoch, tab=stored.tab, source="disk",
                           replicas=reps)

    def _persist(self, key: str, handle: IndexHandle,
                 prev: IndexHandle | None = None) -> dict | None:
        """Write ``handle`` through to the store (delta against ``prev``
        when given). Best-effort: a failure is counted
        (``store_commit_failures``) and returns ``None`` — durability
        degrades, serving does not."""
        if self._store is None:
            return None
        if handle.source == "disk" and prev is None:
            return None     # just promoted from this store: already current
        try:
            return self._store.put_handle(key, handle, prev=prev)
        except Exception as exc:
            self._count_store_failure("store_commit_failures")
            if self.tracer is not None:
                self._span("store_commit_failed", workload=key,
                           error=repr(exc)).end()
            return None

    def _demote(self, key: str, handle: IndexHandle) -> None:
        """Eviction hook: preserve the evicted handle's epoch in the store
        (write-through usually already has it — then this is a cheap
        manifest probe, not a rewrite) instead of discarding built work."""
        if self._store is None:
            return
        res = self._persist(key, handle, prev=None)
        if res is None and handle.source != "disk":
            return          # commit failed: nothing preserved
        with self._lock:
            self.demotions += 1
        if self._metrics is not None:
            self._metrics.count("evictions_demoted")
            if res is not None and res["mode"] != "current":
                self._metrics.count("demote_bytes", res["bytes_written"])

    def close(self, wait: bool = True) -> None:
        """Stop the build and refresh pools. Pending futures still resolve
        when ``wait=True`` (builds run to completion)."""
        with self._lock:
            pool, self._pool = self._pool, None
            rpool, self._refresh_pool = self._refresh_pool, None
        if pool is not None:
            pool.shutdown(wait=wait)
        if rpool is not None:
            rpool.shutdown(wait=wait)

    def __contains__(self, key) -> bool:
        key = _coerce_key(key)
        with self._lock:
            return key in self._entries

    def stats(self) -> dict:
        with self._lock:
            return {
                "resident": list(self._entries),
                "capacity": self.capacity,
                "builds": self.builds,
                "evictions": self.evictions,
                "refreshes": self.refreshes,
                "retentions": self.retentions,
                "promotions": self.promotions,
                "demotions": self.demotions,
                "store_load_failures": self.store_load_failures,
                "store_commit_failures": self.store_commit_failures,
                "epochs": dict(self._epochs),
                "pending": list(self._pending),
                "supported_ks": {w: list(h.supported_ks)
                                 for w, h in self._entries.items()},
                "resident_bytes": sum(h.nbytes for h in self._entries.values()),
                "resident_tab_bytes": sum(h.tab_nbytes
                                          for h in self._entries.values()),
                "resident_device_bytes": sum(
                    h.device_nbytes for h in self._entries.values()),
                "devices": len(self.devices),
            }
