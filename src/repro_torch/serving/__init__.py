"""TCCS serving engine (DESIGN.md §7, §8): shape-bucketed micro-batching,
host/device query planning, per-query LRU result caching, a memoizing
per-workload registry of k-stratified indexes (one build serves every k),
and device execution on one GPU through the hand-written B1 kernel, all
behind the typed Query API v2 surface. PyTorch port of ``repro.serving``.

Quick start::

    from repro_torch.core.query_api import ResultMode, TCCSQuery, WindowSweep
    from repro_torch.serving import EngineConfig, ServingEngine

    with ServingEngine(EngineConfig(max_batch=256, flush_ms=2.0)) as eng:
        res = eng.answer("cm_like", TCCSQuery(u=17, ts=4, te=90, k=3))
        print(sorted(res.vertices), res.provenance.route)
        cohort = eng.answer("cm_like", TCCSQuery(17, 4, 90, 3,
                                                 ResultMode.SUBGRAPH))
        print(cohort.subgraph.m, "member edges")
        traj = eng.sweep("cm_like", WindowSweep(u=17, k=3,
                                                windows=[(d, d + 6)
                                                         for d in range(1, 80)]))

Streaming graphs ingest through the same engine (DESIGN.md §9)::

        eng.ingest("cm_like", [(u, v, t), ...])   # suffix edges, t > t_max

refreshing resident indexes incrementally in the background while queries
keep resolving against the old epoch until the atomic handle swap. The
retention plane (DESIGN.md §10) bounds a long-running deployment's
memory::

        eng.set_retention("cm_like", RetentionPolicy(window=90, slack=7))

auto-trimming the expired prefix on ingest (or explicitly via
``eng.retain(name, t_cut)``): resident indexes *shrink* to the retained
window — bit-identical to a cold build of the trimmed edge list — and
cached answers for surviving windows are rehomed into the shifted
timeline.

The positional ``submit``/``submit_many``/``query`` signatures remain as
shims resolving with the vertex frozenset; each now emits
``DeprecationWarning`` at the call site.
"""

from repro_torch.core.query_api import (EdgeSet, InvalidQueryError,
                                        Provenance, ResultMode, TCCSBackend,
                                        TCCSQuery, TCCSResult, WindowSweep)

from .batcher import MicroBatcher, Request
from .cache import ResultCache
from .engine import EngineConfig, RetentionPolicy, ServingEngine
from .executor import PAD_QUERY, ShardedExecutor, bucket_size, pad_queries
from .metrics import EngineMetrics, LatencyHistogram
from .planner import QueryPlanner
from .registry import IndexHandle, IndexRegistry

__all__ = [
    "EngineConfig", "RetentionPolicy", "ServingEngine",
    "MicroBatcher", "Request",
    "QueryPlanner", "ShardedExecutor", "bucket_size", "pad_queries",
    "PAD_QUERY", "ResultCache", "IndexHandle", "IndexRegistry",
    "EngineMetrics", "LatencyHistogram",
    # query API v2 (re-exported from repro_torch.core.query_api)
    "TCCSQuery", "TCCSResult", "ResultMode", "WindowSweep",
    "InvalidQueryError", "Provenance", "EdgeSet", "TCCSBackend",
]
