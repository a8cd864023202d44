"""Query planner: route batches to the host or device plane, build typed
results, fill the cache (DESIGN.md §7.2, §8). PyTorch port of
``repro.serving.planner``.

The two query planes have opposite cost shapes. Algorithm 1 on the host is
O(answer size) per query with zero launch overhead — unbeatable for a
straggler batch of three. The device plane pays fixed costs (the upload,
one B1 launch and one flag read per propagation round, the download) but
amortizes to microseconds per query at depth. The planner
picks per flushed batch:

* ``B < host_threshold``  -> host loop over the backend's typed ``answer``;
* otherwise               -> pad to the power-of-two bucket (aligned to
  the shard count) and run the device engine on the handle's replicas,
  the bucket split over the executor's shards — the vertex-mask batch for
  VERTICES/COUNT-only batches, the full-mode batch (vertex + version-
  membership masks) when any request in the batch wants EDGES/SUBGRAPH.

An empty forest (k above the graph's k-max) always routes host: every
answer is the empty set and a device batch would compute nothing.

Every result is a :class:`repro_torch.core.query_api.TCCSResult` carrying the
canonical spec it answered and :class:`Provenance` (route, index key,
batch/bucket shape, stage timings). After execution the planner writes
every (index key, canonical spec key) -> result into the LRU cache, so
repeats are resolved on the submit path without ever reaching a batcher.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.batch_query import mixed_slots
from repro_torch.core.pecb_index import StratifiedPECB
from repro_torch.core.query_api import (Provenance, ResultMode, TCCSQuery,
                                  build_result)

from .batcher import Request
from .executor import ShardedExecutor

_EDGE_MODES = (ResultMode.EDGES, ResultMode.SUBGRAPH)


def assemble_device_results(store, specs, vmask, vermask,
                            prov: Provenance) -> list:
    """Typed results from device masks — the single owner of mask-to-result
    assembly, shared by the planner's device branch and the engine's window
    sweeps. ``vermask`` may be None (no full-mode launch): edge modes then
    derive their payload host-side from the version store."""
    results = []
    for i, s in enumerate(specs):
        # repro: ignore[hot-path-transfer] — vmask is host numpy already
        vertices = frozenset(np.nonzero(vmask[i])[0].tolist())
        edge_set = (store.select(np.nonzero(vermask[i])[0])
                    if vermask is not None and s.mode in _EDGE_MODES
                    else None)
        results.append(build_result(s, vertices, store, prov,
                                    edge_set=edge_set))
    return results


class QueryPlanner:
    def __init__(self, executor: ShardedExecutor, cache, metrics,
                 *, host_threshold: int = 8, min_bucket: int = 8,
                 max_batch: int = 256):
        self.executor = executor
        self.cache = cache
        self.metrics = metrics
        self.host_threshold = host_threshold
        self.min_bucket = min_bucket
        self.max_batch = max_batch

    def route(self, handle, batch_size: int) -> str:
        if handle.pecb.num_nodes == 0:
            return "host"
        if batch_size < self.host_threshold:
            return "host"
        return "device"

    def bind(self, handle):
        """The ``execute_fn`` a batcher calls for this index handle."""
        return lambda batch: self.execute(handle, batch)

    @staticmethod
    def _spec_of(r: Request, k: int) -> TCCSQuery:
        # bare requests (tests, legacy callers) carry no spec: VERTICES mode
        return r.spec if r.spec is not None else TCCSQuery(r.u, r.ts, r.te, k)

    @staticmethod
    def _trace_pre_exec(batch: list[Request], route: str,
                        t_exec: float) -> None:
        """Hang the retrospective ``queue`` span and the ``route`` decision
        span off each request's root span (the engine attached it on the
        caller thread; bare legacy requests carry none). The queue span is
        backdated to the batcher enqueue — by the time the worker runs a
        batch, the wait is already history."""
        for r in batch:
            if r.span is None:
                continue
            t_enq = r.t_enqueue or r.t_submit
            r.span.child("queue", t0=t_enq).end(t_exec)
            r.span.child("route", t0=t_exec, route=route).end(t_exec)
            r.span.set("route", route)

    def execute(self, handle, batch: list[Request]) -> list:
        b = len(batch)
        # bare requests carry no spec and need a default k: the smallest
        # supported stratum (a per-k PECBIndex handle keeps its own k)
        k = getattr(handle.pecb, "k", None)
        if k is None:
            ks = handle.pecb.supported_ks
            k = min(ks) if ks else 2
        specs = [self._spec_of(r, k) for r in batch]
        store = handle.pecb.versions
        route = self.route(handle, b)
        # a promoted handle (mmap'd from the persistent store, never
        # rebuilt) stamps route="disk" on its answers' provenance; the
        # execution plane still follows `route` — provenance records where
        # the *index* came from, `backend` keeps the execution detail
        src_disk = getattr(handle, "source", "build") == "disk"
        t0 = time.perf_counter()
        self._trace_pre_exec(batch, route, t0)
        if route == "host":
            results = []
            for r, s in zip(batch, specs):
                es = (r.span.child("execute", route="host")
                      if r.span is not None else None)
                res = handle.pecb.answer(s)
                if es is not None:
                    es.end()
                # provenance links to the ROOT query span: the whole tree
                # is recoverable from the trace id
                tr, sp = r.span.ids if r.span is not None else (None, None)
                prov = dataclasses.replace(
                    res.provenance, index_key=handle.key, batch_size=b,
                    trace_id=tr, span_id=sp)
                if src_disk:
                    prov = dataclasses.replace(prov, route="disk")
                results.append(dataclasses.replace(res, provenance=prov))
            self.metrics.observe("host_exec", time.perf_counter() - t0)
            self.metrics.count("host_batches")
            self.metrics.count("host_queries", b)
        else:
            bucket = self.executor.final_bucket(b, self.min_bucket,
                                                self.max_batch)
            # on a stratified index the per-query k enters as the entry
            # *slot* k_index(k) * n + u — batch_query's vertex-CSR lookup
            # is the only place u appears, so a mixed-k batch is one batch
            # (unsupported ks were answered host-side before batching;
            # k_index raising here is a bug)
            pecb = handle.pecb
            mixed = isinstance(pecb, StratifiedPECB)
            if mixed:
                u = mixed_slots(pecb, [(s.u, s.k) for s in specs])
            else:
                u = [s.u for s in specs]
            ts = [s.ts for s in specs]
            te = [s.te for s in specs]
            need_edges = (store is not None
                          and any(s.mode in _EDGE_MODES for s in specs))
            t_exec = time.perf_counter()
            exec_spans = [r.span.child("execute", route="device",
                                       bucket=bucket, t0=t_exec)
                          if r.span is not None else None for r in batch]
            if need_edges and mixed:
                # the version arrays are the one index space shared across
                # strata — the kq operand scopes the edge payload per query
                vmask, vermask = self.executor.run_full_mixed(
                    handle.replicas, u, ts, te, [s.k for s in specs],
                    bucket)
            elif need_edges:
                vmask, vermask = self.executor.run_full(
                    handle.replicas, u, ts, te, bucket)
            else:
                vmask = self.executor.run(handle.replicas, u, ts, te,
                                          bucket)
                vermask = None
            dt = time.perf_counter() - t0
            t_end = time.perf_counter()
            for es in exec_spans:
                if es is not None:
                    es.end(t_end)
            prov = Provenance(route="disk" if src_disk else "device",
                              backend="pecb-device" + ("-full" if need_edges else ""),
                              index_key=handle.key, batch_size=b,
                              bucket=bucket, timings={"exec_s": dt})
            results = assemble_device_results(store, specs, vmask, vermask,
                                              prov)
            # per-result provenance copies link each answer to its root
            # query span (one launch, many traces)
            results = [
                dataclasses.replace(res, provenance=dataclasses.replace(
                    res.provenance, trace_id=r.span.ids[0],
                    span_id=r.span.ids[1]))
                if r.span is not None else res
                for r, res in zip(batch, results)]
            self.metrics.observe("device_exec", dt)
            self.metrics.count("device_batches")
            self.metrics.count("device_queries", b)
            self.metrics.count("device_padded_slots", bucket - b)
        # the handle's epoch rides along so the cache's retention-epoch
        # floor can drop fills from pre-trim handles atomically with the
        # trim's purge+rehome (DESIGN.md §10.3)
        epoch = getattr(handle, "epoch", None)
        for s, res in zip(specs, results):
            self.cache.put((handle.key, s.cache_key()), res, epoch=epoch)
        return results
