"""TCCS Query API v2: the typed query surface every backend speaks
(DESIGN.md §8).

The paper's motivating applications (contact tracing, fault diagnosis,
financial forensics — §1) need more than the vertex set Algorithm 1
returns: they want the *induced temporal subgraph* of the k-core component.
One spec/result pair is shared by the index, the device plane, the serving
entry point and the tests:

* :class:`TCCSQuery` — a frozen, hashable spec ``(u, ts, te, k, mode)``
  with explicit validation (:meth:`TCCSQuery.validate` raises
  :class:`InvalidQueryError`) and canonicalization
  (:meth:`TCCSQuery.canonical` clamps the window to ``[1, t_max]`` and
  folds every empty window onto one marker, so equivalent queries share a
  single cache key).
* :class:`ResultMode` — VERTICES (the classic answer), EDGES (the member
  temporal edges of the component, as version records ``u/v/t/ct/edge_id``),
  SUBGRAPH (an induced :class:`TemporalGraph` snapshot), COUNT (sizes only).
* :class:`TCCSResult` — vertices plus the mode-dependent payload and
  per-query :class:`Provenance` (route, batch/bucket, stage timings).
* :class:`ComponentBackend` — the mixin that turns an index's native
  component routine (``_component_vertices``) plus its
  :class:`VersionStore` into the full typed surface.

* :class:`WindowSweep` — one vertex over many windows (the trajectory
  query the serving engine answers in one device batch).
* :class:`TCCSBackend` — the protocol every index speaks (``k`` and
  ``answer``).

PyTorch port of ``repro.core.query_api`` (host code, copied so the port
stands alone). The legacy positional ``query(u, ts, te)`` shims are not
carried over.

Edge membership is exact, not approximate: version ``j`` of edge
``edge_id[j]`` is in the temporal k-core of ``[ts, te]`` iff
``ts_from[j] <= ts <= ts_to[j] and ct[j] <= te`` (the core-time
characterization the property suite asserts), and an edge of the core
belongs to u's component iff either endpoint does. The brute-force oracle
for this is :func:`kcore.tccs_oracle_edges`.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Iterable, Protocol, Sequence, runtime_checkable

import numpy as np

from .temporal_graph import TemporalGraph


class InvalidQueryError(ValueError):
    """A query spec violates the API contract (``ts > te``, out-of-range
    ``u``, ``k < 2``, wrong k for the index, bad mode). Raised eagerly at
    the API boundary instead of silently answering the empty set."""


class ResultMode(enum.Enum):
    VERTICES = "vertices"
    EDGES = "edges"
    SUBGRAPH = "subgraph"
    COUNT = "count"


#: Canonical empty window: every window that can match nothing folds onto
#: this one (ts, te) pair so all such queries share one cache key.
EMPTY_WINDOW = (1, 0)


@dataclasses.dataclass(frozen=True)
class TCCSQuery:
    """One TCCS query: the temporal k-core component of ``u`` in ``[ts, te]``.

    Plain data — construction never raises. :meth:`validate` is the
    boundary check; :meth:`canonical` the cache-key normalizer.
    """

    u: int
    ts: int
    te: int
    k: int
    mode: ResultMode = ResultMode.VERTICES

    def __post_init__(self):
        object.__setattr__(self, "u", int(self.u))
        object.__setattr__(self, "ts", int(self.ts))
        object.__setattr__(self, "te", int(self.te))
        object.__setattr__(self, "k", int(self.k))
        if isinstance(self.mode, str):
            object.__setattr__(self, "mode", ResultMode(self.mode))

    @property
    def is_empty_window(self) -> bool:
        return self.ts > self.te

    def validate(self, n: int | None = None,
                 t_max: int | None = None) -> "TCCSQuery":
        """Raise :class:`InvalidQueryError` on a malformed spec.

        ``n`` enables the vertex-range check (skipped when the graph is not
        yet resolvable, e.g. a cold registry key — the backend re-validates
        at answer time). A window beyond ``t_max`` is *valid but empty*
        (canonicalization folds it), only ``ts > te`` is a caller error.
        """
        if not isinstance(self.mode, ResultMode):
            raise InvalidQueryError(f"mode must be a ResultMode, got {self.mode!r}")
        if self.k < 2:
            raise InvalidQueryError(f"k must be >= 2, got k={self.k}")
        if self.ts > self.te and (self.ts, self.te) != EMPTY_WINDOW:
            raise InvalidQueryError(
                f"window [{self.ts}, {self.te}] has ts > te")
        if n is not None and not 0 <= self.u < n:
            raise InvalidQueryError(
                f"vertex u={self.u} out of range [0, {n})")
        return self

    def canonical(self, t_max: int) -> "TCCSQuery":
        """Clamp the window to ``[1, t_max]``; fold empty windows onto
        :data:`EMPTY_WINDOW`. Equivalent queries canonicalize identically,
        so they share one cache key and one device-batch lane.

        An empty graph (``t_max == 0``) clamps every window to ``ts > te``
        and therefore folds it onto the marker too — the result is always
        either a valid non-empty window or :data:`EMPTY_WINDOW`, never an
        un-marked invalid clamp like a raw ``[1, 0]``."""
        ts, te = max(self.ts, 1), min(self.te, t_max)
        if ts > te:
            ts, te = EMPTY_WINDOW
        if (ts, te) == (self.ts, self.te):
            return self
        return dataclasses.replace(self, ts=ts, te=te)

    def cache_key(self) -> tuple:
        return (self.u, self.ts, self.te, self.k, self.mode.value)


@dataclasses.dataclass(frozen=True)
class WindowSweep:
    """One vertex, many windows: the trajectory form of TCCS.

    The device plane answers all ``windows`` in one batch
    (``batch_query.window_sweep``), sharing the per-vertex entry-segment
    resolution across windows — this is the contact-tracing incubation
    sweep served at device batch rates.
    """

    u: int
    k: int
    windows: tuple
    mode: ResultMode = ResultMode.VERTICES

    def __post_init__(self):
        object.__setattr__(self, "u", int(self.u))
        object.__setattr__(self, "k", int(self.k))
        object.__setattr__(
            self, "windows",
            tuple((int(a), int(b)) for (a, b) in self.windows))
        if isinstance(self.mode, str):
            object.__setattr__(self, "mode", ResultMode(self.mode))

    @property
    def num_windows(self) -> int:
        return len(self.windows)

    def specs(self) -> list[TCCSQuery]:
        return [TCCSQuery(self.u, ts, te, self.k, self.mode)
                for (ts, te) in self.windows]


# ----------------------------------------------------------------------
# Results
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class EdgeSet:
    """Member temporal edges of one component, SoA (``u/v/t/ct/edge_id``).

    ``ct`` is the per-version core time at the query's start time — the
    ``node_ct`` flavour of the forest tables, but over *all* member edges
    of the component, not only the spanning subset.
    """

    u: np.ndarray         # int32[M]
    v: np.ndarray         # int32[M]
    t: np.ndarray         # int32[M]  original edge timestamps
    ct: np.ndarray        # int32[M]  core time at the query's ts
    edge_id: np.ndarray   # int32[M]  ids into the source TemporalGraph

    @classmethod
    def empty(cls) -> "EdgeSet":
        z = np.zeros(0, np.int32)
        return cls(z, z.copy(), z.copy(), z.copy(), z.copy())

    @property
    def m(self) -> int:
        return int(self.edge_id.shape[0])

    def edge_ids(self) -> frozenset:
        return frozenset(self.edge_id.tolist())

    def vertex_projection(self) -> frozenset:
        return frozenset(np.union1d(self.u, self.v).tolist())


@dataclasses.dataclass(frozen=True)
class Provenance:
    """Where and how a result was computed (per-query observability).

    ``trace_id``/``span_id`` link the result back to its query-lifecycle
    span tree (the serving engine's tracer). Excluded from equality — two runs of the same query are the *same
    answer* with different traces."""

    route: str                       # host | device | sweep | cache | trivial
                                     # | disk (index promoted from the store)
    backend: str = ""                # pecb | ef | ctmsf | pecb-device | ...
    index_key: str | tuple | None = None  # workload key when engine-served
    batch_size: int = 1
    bucket: int | None = None        # padded device batch shape, if any
    timings: dict = dataclasses.field(default_factory=dict, compare=False)
    trace_id: str | None = dataclasses.field(default=None, compare=False)
    span_id: str | None = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True, eq=False)
class TCCSResult:
    """A typed TCCS answer. ``vertices`` is always the component vertex set
    except in COUNT mode (sizes only); ``edges``/``subgraph`` are filled by
    mode. Results are immutable and cacheable; a cache hit is re-stamped
    with ``route="cache"`` provenance by the engine."""

    query: TCCSQuery                 # the canonical spec answered
    vertices: frozenset
    num_vertices: int
    num_edges: int | None = None
    edges: EdgeSet | None = None
    subgraph: TemporalGraph | None = None
    provenance: Provenance | None = None

    def __len__(self) -> int:
        return self.num_vertices


# ----------------------------------------------------------------------
# Version store: the shared edge-membership metadata
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class VersionStore:
    """Per-version membership metadata shared by all backends.

    Version ``j`` (edge ``edge_id[j]``) is in the temporal k-core of
    ``[ts, te]`` iff ``ts_from[j] <= ts <= ts_to[j]`` and ``ct[j] <= te``
    (the core-time characterization, asserted by the property suite), and
    it belongs to u's component iff its ``src`` endpoint does. This is what
    lets every backend — and the device plane — answer EDGES/SUBGRAPH
    modes exactly, not just the spanning-forest subset.

    Not charged to any index's ``nbytes()``: it is the core-time table the
    construction already produced, carried through for the query surface;
    the paper's index-size comparison (Fig 4) stays undistorted.
    """

    n: int
    t_max: int
    k: int
    edge_id: np.ndarray   # int32[V]
    ts_from: np.ndarray   # int32[V]
    ts_to: np.ndarray     # int32[V]
    ct: np.ndarray        # int32[V]
    src: np.ndarray       # int32[V]  = g.src[edge_id]
    dst: np.ndarray       # int32[V]  = g.dst[edge_id]
    t: np.ndarray         # int32[V]  = g.t[edge_id]

    @classmethod
    def from_table(cls, g: TemporalGraph, k: int, tab) -> "VersionStore":
        eid = np.asarray(tab.edge_id, np.int32)
        return cls(
            n=g.n, t_max=g.t_max, k=int(k),
            edge_id=eid,
            ts_from=np.asarray(tab.ts_from, np.int32),
            ts_to=np.asarray(tab.ts_to, np.int32),
            ct=np.asarray(tab.ct, np.int32),
            src=g.src[eid].astype(np.int32),
            dst=g.dst[eid].astype(np.int32),
            t=g.t[eid].astype(np.int32),
        )

    @property
    def num_versions(self) -> int:
        return int(self.edge_id.shape[0])

    def __eq__(self, other) -> bool:
        """Structural equality over every array (the builder-purity tests
        compare whole indexes field by field)."""
        if not isinstance(other, VersionStore):
            return NotImplemented
        if (self.n, self.t_max, self.k) != (other.n, other.t_max, other.k):
            return False
        return all(np.array_equal(getattr(self, f), getattr(other, f))
                   for f in ("edge_id", "ts_from", "ts_to", "ct",
                             "src", "dst", "t"))

    def select(self, version_ids: np.ndarray) -> EdgeSet:
        """EdgeSet for explicit version indices (device-plane membership
        masks land here)."""
        ids = np.asarray(version_ids, np.int64)
        return EdgeSet(self.src[ids], self.dst[ids], self.t[ids],
                       self.ct[ids], self.edge_id[ids])

    def member_edges(self, vertices: Iterable[int] | np.ndarray,
                     ts: int, te: int) -> EdgeSet:
        """All member edges of the component given its vertex set (host
        route). ``vertices`` may be a set/iterable or a bool[n] mask."""
        if isinstance(vertices, np.ndarray) and vertices.dtype == bool:
            in_comp = vertices
        else:
            in_comp = np.zeros(self.n, bool)
            vs = np.fromiter((int(v) for v in vertices), np.int64,
                             count=len(vertices) if hasattr(vertices, "__len__") else -1)
            in_comp[vs] = True
        if self.num_versions == 0 or not in_comp.any():
            return EdgeSet.empty()
        m = ((self.ts_from <= ts) & (ts <= self.ts_to)
             & (self.ct <= te) & in_comp[self.src])
        return self.select(np.nonzero(m)[0])


# ----------------------------------------------------------------------
# Result assembly (shared by host backends and the serving planner)
# ----------------------------------------------------------------------

def build_result(cq: TCCSQuery, vertices: frozenset,
                 store: VersionStore | None,
                 provenance: Provenance | None = None, *,
                 edge_set: EdgeSet | None = None) -> TCCSResult:
    """Assemble a :class:`TCCSResult` for a canonical spec from the
    component vertex set, deriving the mode payload from ``store`` (or an
    explicit ``edge_set``, e.g. the device plane's membership mask)."""
    mode = cq.mode
    if mode is ResultMode.VERTICES:
        return TCCSResult(cq, vertices, len(vertices), provenance=provenance)
    if mode in (ResultMode.EDGES, ResultMode.SUBGRAPH):
        if edge_set is None:
            if store is None:
                raise InvalidQueryError(
                    f"{mode.value} mode needs a VersionStore-backed index")
            edge_set = (EdgeSet.empty() if not vertices else
                        store.member_edges(vertices, cq.ts, cq.te))
        if mode is ResultMode.EDGES:
            return TCCSResult(cq, vertices, len(vertices), edge_set.m,
                              edges=edge_set, provenance=provenance)
        n = store.n if store is not None else (max(vertices) + 1 if vertices else 0)
        sub = TemporalGraph.from_edges(
            n, zip(edge_set.u.tolist(), edge_set.v.tolist(),
                   edge_set.t.tolist()))
        return TCCSResult(cq, vertices, len(vertices), edge_set.m,
                          edges=edge_set, subgraph=sub, provenance=provenance)
    if mode is ResultMode.COUNT:
        return TCCSResult(cq, frozenset(), len(vertices),
                          provenance=provenance)
    raise InvalidQueryError(f"unknown mode {mode!r}")


def empty_result(cq: TCCSQuery, n: int,
                 provenance: Provenance | None = None) -> TCCSResult:
    """The empty answer in the requested mode (trivial/short-circuit path:
    empty windows, lenient out-of-range vertices, cold empty forests)."""
    if cq.mode in (ResultMode.EDGES, ResultMode.SUBGRAPH):
        es = EdgeSet.empty()
        sub = (TemporalGraph.from_edges(n, [])
               if cq.mode is ResultMode.SUBGRAPH else None)
        return TCCSResult(cq, frozenset(), 0, 0, edges=es, subgraph=sub,
                          provenance=provenance)
    # VERTICES/COUNT carry no edge payload on any route: num_edges stays
    # None (COUNT is the *vertex* count; computing edges would cost the
    # EDGES path)
    return TCCSResult(cq, frozenset(), 0, provenance=provenance)


@runtime_checkable
class TCCSBackend(Protocol):
    """What every TCCS index speaks: one typed query surface. Implemented
    by PECBIndex (via :class:`ComponentBackend`), so tests and benchmarks
    compare backends through one interface."""

    k: int

    def answer(self, q: TCCSQuery) -> TCCSResult: ...


class ComponentBackend:
    """Mixin: native component routine + VersionStore -> full v2 surface.

    Subclasses provide ``k``, ``versions`` (a :class:`VersionStore`),
    ``backend_name`` and ``_component_vertices(u, ts, te) -> set[int]``
    (their Algorithm-1-equivalent, assuming a validated canonical window).
    """

    backend_name: str = "backend"
    versions: VersionStore | None = None

    def _component_vertices(self, u: int, ts: int, te: int) -> set:
        raise NotImplementedError

    def answer(self, q: TCCSQuery) -> TCCSResult:
        store = self.versions
        if store is None:
            raise InvalidQueryError(
                f"{self.backend_name} index was built without a version "
                "store; rebuild it to use the v2 query surface")
        q.validate(n=store.n)
        if q.k != self.k:
            raise InvalidQueryError(
                f"query k={q.k} does not match this index (k={self.k})")
        cq = q.canonical(store.t_max)
        t0 = time.perf_counter()
        vertices = (frozenset() if cq.is_empty_window else
                    frozenset(self._component_vertices(cq.u, cq.ts, cq.te)))
        t1 = time.perf_counter()
        prov = Provenance(route="host", backend=self.backend_name,
                          timings={"component_s": t1 - t0})
        res = build_result(cq, vertices, store, prov)
        prov.timings["total_s"] = time.perf_counter() - t0
        return res

    def answer_many(self, specs: Sequence[TCCSQuery]) -> list[TCCSResult]:
        return [self.answer(q) for q in specs]
