"""TCCS serving engine: the user-facing facade (DESIGN.md §7, §8). PyTorch
port of ``repro.serving.engine``, on one device (``device=``, default
``"cuda"``; the tests pass ``"cpu"``).

Wires the subsystem together::

    submit_spec(workload, TCCSQuery(u, ts, te, k, mode))
        -> validate + canonicalize            (InvalidQueryError at the
                                               boundary; clamped windows
                                               share one cache key; empty
                                               windows resolve instantly)
        -> registry.get_nowait(workload)      (memoized k-stratified handle
                                               serving EVERY supported k, or
                                               kick off the background
                                               build; a cold workload never
                                               blocks the caller)
        -> result cache probe                 (hit: resolve immediately,
                                               re-stamped route="cache")
        -> per-handle micro-batcher           (shape-bucketed batching;
                                               cold workloads enqueue when
                                               the build future resolves)
        -> planner                            (host typed answer | device
                                               batch; per-query k rides as
                                               the entry slot — a mixed-k
                                               batch is ONE device batch,
                                               one B1 launch per round)
        -> future resolves with a TCCSResult

The index plane is k-agnostic (DESIGN.md §14): one workload maps to one
:class:`StratifiedPECB` handle whose strata cover ``handle.supported_ks``,
so a batch mixing k=2 and k=5 queries shares a handle, a batcher, a
device mirror and one device batch. Queries for a k above the graph's
k-max are answered exactly empty host-side; an in-range k outside the
registry's strata policy raises :class:`InvalidQueryError` onto the
query's future.

``sweep(workload, WindowSweep(u, k, windows))`` answers one vertex over
many sliding windows in a single device batch (the contact-tracing
trajectory query); cache-hot windows are skipped, misses share one
``window_sweep`` batch run against the k stratum's own device block
(``IndexHandle.stratum_device``) so a single-k sweep never pays
propagation over the other |K|-1 strata.

``ingest(workload, edges)`` is the streaming entry point (DESIGN.md §9):
suffix edges extend the graph epoch, resident indexes refresh
incrementally in the background (bit-identical to a cold rebuild), and
queries keep being answered — against the *old* epoch's handle, with its
own window canonicalization — until the refreshed handle is atomically
swapped in. Result-cache invalidation is *targeted*
(``ResultCache.purge_window``): only entries whose window intersects the
appended timestamp range are dropped, which for suffix appends is none.

``retain(workload, t_cut)`` / ``set_retention(workload, RetentionPolicy)``
are the bounded-memory leg (DESIGN.md §10): prefix expiry shrinks resident
indexes to the retained window in the background (auto-trimmed on ingest
under a policy), cached windows touching the expired prefix are purged and
the survivors rehomed into the shifted timeline, and cache fills from
pre-trim handles are gated by a per-key epoch floor so the shifted key
space never aliases stale coordinates.

Results are always identical to ``PECBIndex.answer`` (Algorithm 1 plus the
version-store edge derivation) — the engine only changes *where and when*
the answer is computed, never *what*; tests assert exact equality across
every route. The positional ``submit``/``submit_many``/``query`` signatures
remain as thin shims whose futures resolve with the component vertex
frozenset, exactly as before v2; each emits ``DeprecationWarning`` at the
call site.

Thread-safety: ``submit*`` may be called from any number of caller threads;
each index handle owns one batcher worker thread; the registry serializes
builds per key and refreshes on one FIFO worker. ``close()`` (or the
context manager) drains and stops all workers.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from concurrent.futures import Future
from typing import Iterable, Sequence

import torch

from repro_torch.core.query_api import (Provenance, TCCSQuery, TCCSResult,
                                        WindowSweep, empty_result)
from repro_torch.obs.export import write_chrome_trace
from repro_torch.obs.locks import named_lock
from repro_torch.obs.trace import SlowQueryLog, Tracer

from .batcher import MicroBatcher, Request
from .cache import ResultCache
from .executor import ShardedExecutor
from .metrics import EngineMetrics
from .planner import QueryPlanner, assemble_device_results
from .registry import IndexHandle, IndexRegistry


def _vertices_future(inner: Future) -> Future:
    """Legacy-shim adapter: a future resolving with ``result.vertices``."""
    outer: Future = Future()

    def _done(f: Future) -> None:
        exc = f.exception()
        if exc is not None:
            outer.set_exception(exc)
        else:
            outer.set_result(f.result().vertices)

    inner.add_done_callback(_done)
    return outer


@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    """Sliding-window retention for one workload (DESIGN.md §10.4).

    ``window`` is the number of trailing timestamps to keep. ``slack`` is
    trim hysteresis: the auto-trim fires only once ``t_max`` exceeds
    ``window + slack``, then cuts back to exactly ``window`` — every trim
    is a full (cheap, but not free) shrink refresh plus a cache rehome, so
    slack amortizes one trim over several ingests instead of shaving one
    timestamp per day. ``every`` evaluates the policy only on every N-th
    ingest of the workload (a second, coarser period knob)."""

    window: int
    slack: int = 0
    every: int = 1

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"retention window must be >= 1, got {self.window}")
        if self.slack < 0:
            raise ValueError(f"retention slack must be >= 0, got {self.slack}")
        if self.every < 1:
            raise ValueError(f"retention every must be >= 1, got {self.every}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 256         # micro-batch flush size == largest bucket
    flush_ms: float = 2.0        # max time a request waits for batchmates
    min_bucket: int = 8          # smallest padded batch shape
    host_threshold: int = 8      # batches below this run host Algorithm 1
    cache_capacity: int = 4096   # LRU result-cache entries (<=0 disables)
    registry_capacity: int = 8   # resident workload indexes (all-k each)
    trace: bool = True           # record query-lifecycle spans (§11)
    trace_buffer: int = 16384    # finished-span ring capacity
    slow_query_ms: float | None = None  # slow-query log threshold (off=None)
    store_dir: str | None = None  # persistent index store root (§13): A6


class ServingEngine:
    def __init__(self, config: EngineConfig | None = None, *,
                 registry: IndexRegistry | None = None, device="cuda"):
        self.config = config or EngineConfig()
        cfg = self.config
        if not 1 <= cfg.min_bucket <= cfg.max_batch:
            raise ValueError(
                f"need 1 <= min_bucket <= max_batch, got min_bucket="
                f"{cfg.min_bucket} max_batch={cfg.max_batch}")
        if cfg.store_dir is not None:
            raise NotImplementedError(
                "EngineConfig.store_dir: the persistent index store (disk "
                "tier) is not ported yet: ROADMAP A6")
        device = torch.device(device)
        if registry is not None and registry.device != device:
            raise ValueError(f"the registry builds on {registry.device}, "
                             f"the engine serves on {device}")
        self.metrics = EngineMetrics()
        # one tracer per engine (DESIGN.md §11.1): queries, background
        # builds/refreshes and kernel builds all record into this ring
        self.tracer = Tracer(cfg.trace_buffer, enabled=cfg.trace)
        self.slow_queries = SlowQueryLog(cfg.slow_query_ms,
                                         tracer=self.tracer)
        self.cache = ResultCache(cfg.cache_capacity)
        self._owns_registry = registry is None
        self.registry = registry if registry is not None else IndexRegistry(
            cfg.registry_capacity, metrics=self.metrics,
            tracer=self.tracer, device=device)
        self.executor = ShardedExecutor(device, metrics=self.metrics,
                                        tracer=self.tracer)
        self.planner = QueryPlanner(
            self.executor, self.cache, self.metrics,
            host_threshold=cfg.host_threshold, min_bucket=cfg.min_bucket,
            max_batch=cfg.max_batch)
        # workload -> (handle the batcher's execute_fn is bound to, batcher)
        self._batchers: dict[str, tuple[IndexHandle, MicroBatcher]] = {}
        self._lock = named_lock("engine")
        self._closed = False
        # retention state: per-workload policy + ingest tick. The epoch
        # floor gating cache fills (a handle older than the last retention
        # trim must not fill the cache: its canonical windows are in the
        # pre-shift timeline and would collide with the shifted epoch's
        # keys — unlike suffix epochs, where stale writes stay exact and
        # are welcome) lives in the cache itself (ResultCache.raise_floor)
        # so the drop is atomic with put/purge under the cache lock.
        self._retention: dict[str, RetentionPolicy] = {}
        self._ingest_ticks: dict[str, int] = {}
        self.registry.add_evict_listener(self._on_index_evicted)
        self.registry.add_refresh_listener(self._on_index_refreshed)
        self.registry.add_retention_listener(self._on_index_retained)
        # unified metrics surface (DESIGN.md §11.4): one snapshot covers
        # the engine's counters/latency plus the cache and registry stat
        # planes, exportable as JSON via repro_torch.obs.export
        self.metrics.register_source("cache", self.cache.stats)
        self.metrics.register_source("registry", self.registry.stats)

    # -- graph/index management -----------------------------------------
    def register_graph(self, name: str, g) -> None:
        self.registry.register_graph(name, g)

    def warmup(self, workload: str, k: int | None = None, *,
               sweep: bool = False, full: bool = False,
               sweep_ks=None) -> IndexHandle:
        """Build the workload's k-stratified index and run every bucket
        shape of the vertex-mask batch once, so no live request pays a
        build or the first use of B1 (its library's build and load, counted
        as ``kernel_builds``; an inert batch still runs one propagation
        round) — for *any* k the handle supports (k rides as the entry
        slot, so one warmup covers every k mix). ``sweep=True`` /
        ``full=True`` additionally run the window-sweep / mixed-k full-mode
        (EDGES) batches for callers that will use those paths; the sweep
        runs against per-stratum mirrors, so with ``sweep=True`` pass
        ``sweep_ks`` to bound the warm to the ks you will actually sweep
        (default: every supported k, and each one's mirror is carved out
        here). The ``k`` argument is deprecated and ignored."""
        if k is not None:
            warnings.warn(
                "ServingEngine.warmup(workload, k) is deprecated: one "
                "stratified index serves every k — warmup(workload) warms "
                "all of them", DeprecationWarning, stacklevel=2)
        handle = self.registry.get(workload)
        if handle.pecb.num_nodes == 0:
            return handle  # host-only route, nothing to warm
        cfg = self.config
        b = cfg.min_bucket
        while True:
            bucket = self.executor.final_bucket(
                min(b, cfg.max_batch), cfg.min_bucket, cfg.max_batch)
            self.executor.run(handle.device, [0], [1], [0], bucket)
            if sweep:
                for sk in (handle.supported_ks if sweep_ks is None
                           else sweep_ks):
                    self.executor.run_sweep(handle.stratum_device(sk), 0,
                                            [1], [0], bucket)
            if full:
                self.executor.run_full_mixed(handle.device, [0], [1], [0],
                                             [0], bucket)
            if b >= cfg.max_batch:
                break
            b *= 2
        return handle

    def prefetch(self, workload: str, k: int | None = None) -> Future:
        """Kick off (or join) the background index build; never blocks.
        The ``k`` argument is deprecated and ignored (the build covers
        every supported k)."""
        if k is not None:
            warnings.warn(
                "ServingEngine.prefetch(workload, k) is deprecated: one "
                "stratified build serves every k — prefetch(workload)",
                DeprecationWarning, stacklevel=2)
        return self.registry.get_async(workload)

    # -- streaming ingest -------------------------------------------------
    def ingest(self, workload: str, edges,
               wait: bool = False, timeout: float | None = 120.0) -> dict:
        """Append suffix ``edges`` to ``workload``'s graph and refresh its
        resident stratified index incrementally in the background.

        Non-blocking by default: returns ``{workload: Future}`` for the
        resident index being refreshed (empty when none is resident
        — the next cold build simply sees the new epoch). Queries keep
        resolving throughout a refresh, pinned to the old epoch's handle;
        the swap is atomic and the refresh listener retires the old
        batcher and runs the targeted cache purge. ``wait=True`` blocks
        until every refresh has landed."""
        if self._closed:
            raise RuntimeError("engine is closed")
        self.metrics.count("ingests")
        # the ingest span parents every background index_refresh (and any
        # auto-trim's index_retention) scheduled here: the span *context*
        # crosses into the FIFO worker explicitly (DESIGN.md §11.2)
        span = self.tracer.start_span("ingest", parent=None, cat="epoch",
                                      workload=workload)
        try:
            futures = self.registry.extend_graph(workload, edges,
                                                 parent=span.ctx)
            trims = self._auto_trim(workload, parent=span.ctx)
            # a trim future supersedes the same key's refresh future: the
            # FIFO refresh worker runs the suffix refresh first, so the trim
            # future resolving implies both steps landed
            futures = {**futures, **trims}
            span.set("refreshes", len(futures))
            if wait:
                for f in futures.values():
                    f.result(timeout=timeout)
            return futures
        except BaseException as exc:
            span.set("error", repr(exc))
            raise
        finally:
            span.end()

    # -- sliding-window retention -----------------------------------------
    def set_retention(self, workload: str,
                      policy: RetentionPolicy | int | None) -> dict:
        """Install (or, with ``None``, remove) a sliding-window
        :class:`RetentionPolicy` for ``workload``; a bare int is shorthand
        for ``RetentionPolicy(window=policy)``. Every subsequent
        :meth:`ingest` of the workload re-evaluates the policy (subject to
        ``policy.every``) and auto-trims the expired prefix in the
        background — and the policy is evaluated once right here, so a
        workload already over its window starts trimming immediately;
        the returned ``{workload: Future}`` dict (usually empty) lets
        callers wait for that first trim to land."""
        if isinstance(policy, int):
            policy = RetentionPolicy(window=policy)
        with self._lock:
            if policy is None:
                self._retention.pop(workload, None)
                return {}
            self._retention[workload] = policy
        return self._auto_trim(workload, tick=False)

    def retention_policy(self, workload: str) -> RetentionPolicy | None:
        with self._lock:
            return self._retention.get(workload)

    def retain(self, workload: str, t_cut: int, wait: bool = False,
               timeout: float | None = 120.0) -> dict:
        """Manually expire the prefix below ``t_cut`` (see
        :meth:`IndexRegistry.retain`): the resident index shrinks in the
        background, queries keep resolving against the old epoch until the
        atomic swap, expired cache windows are purged and surviving ones
        rehomed into the shifted timeline. Returns ``{workload: Future}``
        like :meth:`ingest`."""
        if self._closed:
            raise RuntimeError("engine is closed")
        self.metrics.count("retentions")
        span = self.tracer.start_span("retain", parent=None, cat="epoch",
                                      workload=workload, t_cut=int(t_cut))
        try:
            futures = self._begin_trim(workload, t_cut, parent=span.ctx)
            span.set("trims", len(futures))
            if wait:
                for f in futures.values():
                    f.result(timeout=timeout)
            return futures
        except BaseException as exc:
            span.set("error", repr(exc))
            raise
        finally:
            span.end()

    def _begin_trim(self, workload: str, t_cut: int, parent=None) -> dict:
        """Schedule a registry trim and raise the cache floor for every
        affected key *at initiation* (to the epoch the trim just bumped
        to), not only at swap time: if the trim never swaps — the key is
        evicted mid-queue, or a racing cold build catches up first — the
        retention listener never fires, yet pre-trim handles must still
        be barred from filling the cache with pre-shift windows."""
        futures = self.registry.retain(workload, t_cut, parent=parent)
        if futures:
            epoch = self.registry.stats()["epochs"].get(workload, 0)
            for key in futures:
                self.cache.raise_floor(key, epoch)
        return futures

    def _auto_trim(self, workload: str, tick: bool = True,
                   parent=None) -> dict:
        """Evaluate the workload's retention policy; trim when ``t_max``
        overflows ``window + slack`` (cutting back to exactly ``window``)."""
        with self._lock:
            pol = self._retention.get(workload)
            if pol is None:
                return {}
            if tick:
                self._ingest_ticks[workload] = n = \
                    self._ingest_ticks.get(workload, 0) + 1
                if n % pol.every:
                    return {}
        try:
            g = self.registry.resolve_graph(workload)
        except KeyError:
            return {}
        if g.t_max <= pol.window + pol.slack:
            return {}
        self.metrics.count("auto_trims")
        return self._begin_trim(workload, g.t_max - pol.window + 1,
                                parent=parent)

    # -- query paths: v2 typed surface -----------------------------------
    def submit_spec(self, workload: str, spec: TCCSQuery) -> Future:
        """Future resolving with a :class:`TCCSResult`. Malformed specs
        (``ts > te``, out-of-range ``u``, ``k < 2``) raise
        :class:`InvalidQueryError` here, at the boundary."""
        return self.submit_specs(workload, [spec])[0]

    def submit_specs(self, workload: str,
                     specs: Iterable[TCCSQuery]) -> list[Future]:
        """One TCCSResult future per spec, in input order; specs may mix k
        values *and* result modes freely — every k shares the workload's
        one stratified index, one batcher and one device batch (k rides as
        the entry slot), so a mixed-k batch is still a single batch. A
        batch runs the full-mode batch iff any of its members wants
        EDGES/SUBGRAPH."""
        return self._submit_specs(workload, list(specs), lenient=False)

    def answer(self, workload: str, spec: TCCSQuery,
               timeout: float | None = 60.0) -> TCCSResult:
        """Synchronous v2 convenience wrapper."""
        return self.submit_spec(workload, spec).result(timeout=timeout)

    # -- query paths: legacy positional shims ----------------------------
    def submit(self, workload: str, k: int, u: int, ts: int, te: int) -> Future:
        """Deprecated shim over :meth:`submit_spec`; resolves with the
        vertex frozenset and keeps the lenient pre-v2 semantics (malformed
        windows answer the empty set instead of raising). Emits
        :class:`DeprecationWarning`."""
        warnings.warn(
            "ServingEngine.submit(workload, k, u, ts, te) is deprecated; "
            "use submit_spec(workload, TCCSQuery(u, ts, te, k))",
            DeprecationWarning, stacklevel=2)
        return self._submit_legacy(workload, k, [(u, ts, te)])[0]

    def submit_many(self, workload: str, k: int,
                    queries: Iterable[Sequence[int]]) -> list[Future]:
        """Deprecated shim: one vertex-frozenset future per (u, ts, te), in
        input order, lenient validation. Cache hits resolve before this
        returns; misses resolve when their batch flushes. Emits
        :class:`DeprecationWarning`."""
        warnings.warn(
            "ServingEngine.submit_many(workload, k, queries) is deprecated; "
            "use submit_specs(workload, [TCCSQuery(...), ...])",
            DeprecationWarning, stacklevel=2)
        return self._submit_legacy(workload, k, queries)

    def _submit_legacy(self, workload: str, k: int,
                       queries: Iterable[Sequence[int]]) -> list[Future]:
        specs = [TCCSQuery(int(u), int(ts), int(te), int(k))
                 for (u, ts, te) in queries]
        inner = self._submit_specs(workload, specs, lenient=True)
        return [_vertices_future(f) for f in inner]

    # -- the shared submit core ------------------------------------------
    def _submit_specs(self, workload: str, specs: list[TCCSQuery],
                      *, lenient: bool) -> list[Future]:
        """Validate/canonicalize, short-circuit trivial queries and cache
        hits, batch the misses (all ks together — one handle serves them).
        A cold workload never blocks the caller: the index builds on the
        registry's background pool and the misses are enqueued when the
        handle future resolves."""
        if self._closed:
            raise RuntimeError("engine is closed")
        key = str(workload)
        # probe only: don't schedule a build until a cache miss proves one
        # is needed (a fully-cached stream must not rebuild an evicted index)
        handle = self.registry.get_nowait(workload, start_build=False)
        g = None
        if handle is not None:
            # epoch pinning: canonicalize against the graph the resident
            # index was built for. During a streaming refresh the registry
            # may already hold a newer graph epoch; clamping to the
            # handle's t_max keeps window semantics and answers consistent
            # with the index that will serve them (and those answers stay
            # exact in every later epoch — their windows predate the
            # appended suffix).
            g = handle.graph
        else:
            try:
                g = self.registry.resolve_graph(workload)
            except KeyError:
                pass  # unknown workload: surface as the build future's error
        # validate every spec before creating any future (all-or-nothing:
        # a boundary error must not leave earlier futures dangling)
        prepared: list[tuple[TCCSQuery, bool]] = []
        for spec in specs:
            if g is not None:
                if not lenient:
                    spec.validate(n=g.n)
                cq = spec.canonical(g.t_max)
                trivial = cq.is_empty_window or not 0 <= cq.u < g.n
            else:
                if not lenient:
                    spec.validate()
                cq, trivial = spec, False
            prepared.append((cq, trivial))
        t0 = time.perf_counter()
        futures: list[Future] = []
        misses: list[Request] = []
        for (cq, trivial) in prepared:
            fut: Future = Future()
            futures.append(fut)
            self.metrics.count("queries")
            # one root span per query (DESIGN.md §11.2): trivial and cache
            # paths close it here; misses carry the *open* span across the
            # batcher thread boundary and close it from the future's done
            # callback (covering error resolutions too)
            span = self.tracer.start_span(
                "query", parent=None, cat="query", t0=t0,
                workload=workload, k=int(cq.k), u=cq.u, ts=cq.ts, te=cq.te)
            tr, sp = span.ids
            if trivial:
                # an empty window (or lenient out-of-range vertex) needs no
                # index at all — not even a cache slot
                self.metrics.count("trivial_queries")
                span.set("route", "trivial").end()
                fut.set_result(empty_result(
                    cq, g.n, Provenance(route="trivial", index_key=key,
                                        trace_id=tr, span_id=sp)))
                self.metrics.observe("e2e", time.perf_counter() - t0)
                continue
            hit = self.cache.get((key, cq.cache_key()))
            if hit is not None:
                self.metrics.count("cache_hits")
                span.child("cache", t0=t0).end()
                span.set("route", "cache").end()
                fut.set_result(self._stamp_cache_hit(hit, span))
                self.metrics.observe("e2e", time.perf_counter() - t0)
            else:
                self.metrics.count("cache_misses")
                fut.add_done_callback(self._finish_root_span(span, cq))
                misses.append(Request(cq.u, cq.ts, cq.te, fut, t_submit=t0,
                                      spec=cq, span=span))
        if misses:
            if handle is not None:
                self._dispatch_misses(workload, handle, misses)
            else:
                self.metrics.count("cold_submits")
                self._submit_when_built(workload, misses)
        return futures

    def _dispatch_misses(self, workload: str, handle: IndexHandle,
                         misses: list[Request]) -> None:
        """Hand misses to the handle's batcher, riding out retirement
        races: a refresh/eviction listener may close the batcher between
        our probe and the enqueue. On that RuntimeError, re-probe the
        registry — a refreshed key yields the new epoch's handle (the
        already-canonicalized windows stay exact there: they predate the
        appended suffix), an evicted key chains on the rebuild. A swap
        landing between probe and enqueue can also make ``_batcher_for``
        *resurrect* a batcher bound to the retired handle (its retirement
        already ran); the post-enqueue check retires it again so a dead
        epoch never stays pinned — ``MicroBatcher.close`` drains pending
        work first, so the just-enqueued misses still resolve.

        Misses whose k falls outside the handle's strata never reach the
        batcher: they are answered host-side right here (exactly empty
        above the graph's k-max; ``InvalidQueryError`` onto the future for
        an in-range k the strata policy excludes). The partition re-runs
        per retry because an epoch swap can change ``supported_ks`` (a
        retention trim drops strata above the trimmed graph's k-max)."""
        key = str(workload)
        for _ in range(8):   # bounded: each retry needs another swap race
            cur = self.registry.get_nowait(workload, start_build=False)
            if cur is None:
                self.metrics.count("cold_submits")
                self._submit_when_built(workload, misses)
                return
            handle = cur
            supported = set(handle.pecb.supported_ks)
            batchable = []
            for req in misses:
                kq = req.spec.k if req.spec is not None else None
                if kq is None or kq in supported:
                    batchable.append(req)
                elif not req.future.done():
                    self._answer_unsupported_k(key, handle, req)
            if not batchable:
                return
            misses = batchable
            try:
                self._batcher_for(handle).submit_many(batchable)
            except RuntimeError:
                if self._closed:
                    raise
                continue
            latest = self.registry.get_nowait(workload, start_build=False)
            if latest is not None and latest is not handle:
                self._retire_batcher(key, handle)
            return
        raise RuntimeError(
            f"batcher for {key!r} kept closing under submit")

    def _answer_unsupported_k(self, key: str, handle: IndexHandle,
                              req: Request) -> None:
        """Resolve one miss whose k has no stratum in the handle.
        ``StratifiedPECB.answer`` owns the semantics: k above the graph's
        k-max is exactly empty (computed host-side, no index needed), any
        other unsupported k raises ``InvalidQueryError`` — which lands on
        the future, like every other per-query failure."""
        try:
            res = handle.pecb.answer(req.spec)
        except BaseException as exc:
            req.future.set_exception(exc)
            return
        tr, sp = req.span.ids if req.span is not None else (None, None)
        res = dataclasses.replace(res, provenance=dataclasses.replace(
            res.provenance, index_key=key, trace_id=tr, span_id=sp))
        self.cache.put((key, req.spec.cache_key()), res,
                       epoch=handle.epoch)
        self.metrics.count("unsupported_k_queries")
        req.future.set_result(res)

    def _finish_root_span(self, span, cq: TCCSQuery):
        """Done callback closing a miss's root query span. Attached at
        Request creation so *every* resolution path — planner result, batch
        execute_fn failure, build failure, engine close — ends the span and
        feeds the slow-query log exactly once (``Span.end`` is idempotent
        anyway)."""
        def _done(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                span.set("error", repr(exc))
            span.end()
            self.slow_queries.observe(span, cq)
        return _done

    @staticmethod
    def _stamp_cache_hit(res: TCCSResult, span=None) -> TCCSResult:
        """Re-stamp a cached result with ``route="cache"`` (and, when a
        root query span is passed, that span's trace identity) — on a
        *copy*.

        ``dataclasses.replace`` shallow-copies, which would share the
        mutable ``timings`` dict between the stored result and every hit
        handed to callers (threads mutating one would corrupt the other,
        and the stored provenance itself); the dict is copied explicitly so
        the cached original stays pristine."""
        tr, sp = span.ids if span is not None else (None, None)
        if res.provenance is None:
            return dataclasses.replace(res, provenance=Provenance(
                route="cache", trace_id=tr, span_id=sp))
        prov = dataclasses.replace(res.provenance, route="cache",
                                   trace_id=tr, span_id=sp,
                                   timings=dict(res.provenance.timings))
        return dataclasses.replace(res, provenance=prov)

    # -- window sweeps ----------------------------------------------------
    def sweep(self, workload: str, ws: WindowSweep,
              timeout: float | None = 120.0) -> list[TCCSResult]:
        """Answer one vertex over many windows — cache-hot windows are
        served from the LRU, the remaining windows share device
        ``window_sweep`` launches (or a host loop for straggler sweeps and
        empty forests). Blocking: the sweep is a throughput API; a cold
        index is built first (use :meth:`prefetch` to hide that)."""
        if self._closed:
            raise RuntimeError("engine is closed")
        handle = self.registry.get(workload, timeout=timeout)
        g, key = handle.graph, handle.key
        specs = ws.specs()
        for s in specs:
            s.validate(n=g.n)
        self.metrics.count("queries", len(specs))
        t0 = time.perf_counter()
        # one root span for the whole sweep (it is a single logical query);
        # each device launch / host loop is a child, and every non-cached
        # window's provenance links back to this root
        span = self.tracer.start_span(
            "sweep", parent=None, cat="query", t0=t0,
            workload=workload, k=int(ws.k), u=int(ws.u), windows=len(specs))
        tr, sp = span.ids
        results: list = [None] * len(specs)
        misses: list[tuple[int, TCCSQuery]] = []
        for i, s in enumerate(specs):
            cq = s.canonical(g.t_max)
            if cq.is_empty_window:
                self.metrics.count("trivial_queries")
                results[i] = empty_result(
                    cq, g.n, Provenance(route="trivial", index_key=key,
                                        trace_id=tr, span_id=sp))
                continue
            hit = self.cache.get((key, cq.cache_key()))
            if hit is not None:
                self.metrics.count("cache_hits")
                results[i] = self._stamp_cache_hit(hit, span)
            else:
                self.metrics.count("cache_misses")
                misses.append((i, cq))
        cfg = self.config
        # an unsupported k routes host: above the graph's k-max every
        # window is exactly empty (answered without an index); an in-range
        # k outside the strata policy raises InvalidQueryError — the sweep
        # is synchronous, so it surfaces to the caller directly
        k_on_device = ws.k in handle.pecb.supported_ks
        if misses and (handle.pecb.num_nodes == 0 or not k_on_device
                       or len(misses) < cfg.host_threshold):
            es = span.child("execute", route="host")
            for i, cq in misses:
                res = handle.pecb.answer(cq)
                res = dataclasses.replace(res, provenance=dataclasses.replace(
                    res.provenance, index_key=key, trace_id=tr, span_id=sp))
                results[i] = res
                self.cache.put((key, cq.cache_key()), res,
                               epoch=handle.epoch)
            es.end()
            self.metrics.count("host_batches")
            self.metrics.count("host_queries", len(misses))
        elif misses:
            store = handle.pecb.versions
            # single-k launch: carve the stratum's block out of the fused
            # mixed-k mirror (lazy per-handle memo) so sweep propagation
            # pays for one stratum's nodes, not all |K|; ``u`` is a plain
            # row of the sliced per-vertex CSR
            sdix = handle.stratum_device(int(ws.k))
            for c0 in range(0, len(misses), cfg.max_batch):
                chunk = misses[c0:c0 + cfg.max_batch]
                bucket = self.executor.final_bucket(
                    len(chunk), cfg.min_bucket, cfg.max_batch)
                ts = [cq.ts for _, cq in chunk]
                te = [cq.te for _, cq in chunk]
                t1 = time.perf_counter()
                vmask = self.executor.run_sweep(sdix, int(ws.u), ts, te,
                                                bucket)
                dt = time.perf_counter() - t1
                span.child("execute", route="sweep", bucket=bucket,
                           t0=t1).end()
                prov = Provenance(route="sweep", backend="pecb-device-sweep",
                                  index_key=key, batch_size=len(chunk),
                                  bucket=bucket, timings={"exec_s": dt},
                                  trace_id=tr, span_id=sp)
                chunk_res = assemble_device_results(
                    store, [cq for _, cq in chunk], vmask, None, prov)
                for (i, cq), res in zip(chunk, chunk_res):
                    results[i] = res
                    self.cache.put((key, cq.cache_key()), res,
                                   epoch=handle.epoch)
                self.metrics.count("sweep_launches")
                self.metrics.count("sweep_windows", len(chunk))
                self.metrics.count("sweep_padded_slots", bucket - len(chunk))
                self.metrics.observe("sweep_exec", dt)
        span.end()
        self.metrics.observe("sweep_e2e", time.perf_counter() - t0)
        return results

    def _submit_when_built(self, workload: str,
                           misses: list[Request]) -> None:
        """Chain a batch of misses onto the pending index build."""
        def on_built(handle_fut: Future) -> None:
            try:
                handle = handle_fut.result()
                self._dispatch_misses(workload, handle, misses)
            except BaseException as exc:  # build failed or engine closed
                for req in misses:
                    if not req.future.done():
                        req.future.set_exception(exc)
        self.registry.get_async(workload).add_done_callback(on_built)

    def query(self, workload: str, k: int, u: int, ts: int, te: int,
              timeout: float | None = 60.0) -> frozenset:
        """Deprecated synchronous shim (one-request batch); prefer
        :meth:`answer`. Emits :class:`DeprecationWarning`."""
        warnings.warn(
            "ServingEngine.query(workload, k, u, ts, te) is deprecated; "
            "use answer(workload, TCCSQuery(u, ts, te, k))",
            DeprecationWarning, stacklevel=2)
        return self._submit_legacy(
            workload, k, [(u, ts, te)])[0].result(timeout=timeout)

    # -- lifecycle -------------------------------------------------------
    def _batcher_for(self, handle: IndexHandle) -> MicroBatcher:
        """Batcher bound to exactly this handle. If the registry evicted and
        rebuilt the key, the old batcher (bound to the dead handle) is
        closed and replaced, so closures never pin evicted indexes."""
        stale = None
        with self._lock:
            if self._closed:          # close() may have raced past submit's check
                raise RuntimeError("engine is closed")
            entry = self._batchers.get(handle.key)
            if entry is not None and entry[0] is handle:
                return entry[1]
            if entry is not None:
                stale = entry[1]
            cfg = self.config
            b = MicroBatcher(
                self.planner.bind(handle),
                max_batch=cfg.max_batch, flush_ms=cfg.flush_ms,
                name=f"batcher-dispatch-{handle.key}",
                metrics=self.metrics)
            self._batchers[handle.key] = (handle, b)
        if stale is not None:
            stale.close()
        return b

    def _on_index_evicted(self, key: str, handle: IndexHandle) -> None:
        """Registry eviction hook: retire the batcher (and its worker
        thread) bound to the evicted handle, and purge the dead handle's
        result-cache entries — ONE workload-level purge clears every k
        stratum's results, because the cache key is (workload, spec key)
        and k lives inside the spec key."""
        purged = self.cache.purge_index(key)
        if purged:
            self.metrics.count("cache_purged", purged)
        self._retire_batcher(key, handle)

    def _on_index_retained(self, key: str, old: IndexHandle,
                           new: IndexHandle, t_cut: int) -> None:
        """Registry retention hook (prefix-expiry trim landed). Ordering:
        (1) raise the cache's epoch floor (idempotent with the raise at
        trim initiation; atomic with puts under the cache lock, so a
        still-running batch or sweep bound to a pre-trim handle either
        writes before the purge — and is rehomed/dropped by it like any
        resident entry — or is gated); (2) retire the old batcher so new
        submissions bind the trimmed handle; (3) purge cached windows
        that touch the expired prefix and rehome the survivors into the
        shifted timeline (``shift = t_cut - 1``)."""
        self.cache.raise_floor(key, new.epoch)
        self._retire_batcher(key, old)
        purged = self.cache.purge_window(key, 1, t_cut - 1, shift=t_cut - 1)
        if purged:
            self.metrics.count("cache_purged_retention", purged)

    def _on_index_refreshed(self, key: str, old: IndexHandle,
                            new: IndexHandle) -> None:
        """Registry refresh hook (streaming epoch landed): run the
        *targeted* cache purge — only results whose canonical window
        intersects the appended range ``(old.t_max, new.t_max]`` — and
        retire the old epoch's batcher so new submissions bind the
        refreshed handle. For suffix appends every cached canonical window
        satisfies ``te <= old.t_max``, so the expected purge count is zero:
        the whole warm working set survives the epoch."""
        purged = self.cache.purge_window(
            key, old.graph.t_max + 1, new.graph.t_max)
        if purged:
            self.metrics.count("cache_purged_targeted", purged)
        self._retire_batcher(key, old)

    def _retire_batcher(self, key: str, handle: IndexHandle) -> None:
        with self._lock:
            entry = self._batchers.get(key)
            if entry is None or entry[0] is not handle:
                return
            del self._batchers[key]
        entry[1].close()

    def flush(self) -> None:
        with self._lock:
            batchers = [b for (_, b) in self._batchers.values()]
        for b in batchers:
            b.flush()

    def drain(self, timeout: float | None = 60.0) -> None:
        with self._lock:
            batchers = [b for (_, b) in self._batchers.values()]
        for b in batchers:
            b.drain(timeout=timeout)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            batchers = [b for (_, b) in self._batchers.values()]
        self.registry.remove_evict_listener(self._on_index_evicted)
        self.registry.remove_refresh_listener(self._on_index_refreshed)
        self.registry.remove_retention_listener(self._on_index_retained)
        for b in batchers:
            b.close()
        if self._owns_registry:
            self.registry.close(wait=True)

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability ---------------------------------------------------
    def export_trace(self, path: str, extra: dict | None = None) -> dict:
        """Write the tracer's finished-span ring as Chrome trace-event JSON
        (loadable in Perfetto / ``chrome://tracing``); returns the
        validated document. Works on a live engine — the export is a
        snapshot of whatever has finished so far."""
        return write_chrome_trace(path, self.tracer, extra=extra)

    def stats(self) -> dict:
        return {
            "engine": self.metrics.snapshot(include_sources=False),
            "cache": self.cache.stats(),
            "registry": self.registry.stats(),
            "devices": self.executor.num_devices,
            "kernel_libraries": self.executor.compile_count(),
            "trace": self.tracer.stats(),
            "slow_queries": len(self.slow_queries),
        }

    def format_stats(self) -> str:
        s = self.stats()
        lines = [self.metrics.format()]
        lines.append(f"  cache                    {s['cache']}")
        lines.append(f"  registry                 resident={s['registry']['resident']} "
                     f"builds={s['registry']['builds']} evictions={s['registry']['evictions']}")
        lines.append(f"  devices={s['devices']} "
                     f"kernel_libraries={s['kernel_libraries']}")
        return "\n".join(lines)
