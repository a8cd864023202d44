"""PECB-Index (paper §4.1 Table 2, §4.2 Algorithm 1).

The incremental builder's per-node entry lists are packed into flat CSR
arrays so that (a) host queries are cache-friendly, (b) the same arrays ship
unchanged to the device for the batched query engine (``batch_query.py``),
and (c) index size accounting is exact (``nbytes``).

Entry resolution for a node at start time ``ts`` is the paper's binary
search: the entry with the smallest recorded start time >= ts (entries are
recorded while ts descends, only on change). Nodes/vertices whose earliest
recorded entry is below ``ts`` are not in the forest at ``ts``.

Query surface: the typed API (``answer(TCCSQuery) -> TCCSResult``, via
:class:`query_api.ComponentBackend`) over Algorithm 1
(``_component_vertices``). The attached :class:`VersionStore` (the
core-time table carried through construction) powers the EDGES/SUBGRAPH
modes; it is deliberately excluded from ``nbytes()`` so the paper's index-size comparison stays undistorted.

PyTorch port of ``repro.core.pecb_index`` (host code, copied so the port
stands alone): the per-k index, the k-stratified index and their packing
are the reference's, bit for bit (tests assert array equality), and so
is the streaming resume path (``build_pecb_index(..., resume_from=)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core_time import (CoreTimeTable, StratifiedCoreTable, edge_core_times,
                        stratified_core_times)
from .ecb_forest import (NONE, FastIncrementalBuilder, ForestInvariantError,
                        IncrementalBuilder)
from .query_api import (ComponentBackend, InvalidQueryError, Provenance,
                        TCCSQuery, TCCSResult, VersionStore, empty_result)
from .temporal_graph import TemporalGraph


@dataclasses.dataclass
class PECBIndex(ComponentBackend):
    n: int
    m: int
    t_max: int
    k: int
    # node (= edge version) table
    node_u: np.ndarray        # int32[N]
    node_v: np.ndarray        # int32[N]
    node_ct: np.ndarray       # int32[N]
    node_edge: np.ndarray     # int32[N]
    node_live_from: np.ndarray  # int32[N]  (first ts with node in forest)
    node_live_to: np.ndarray    # int32[N]  (last ts with node in forest)
    # node entries, CSR, per-node ascending ts
    row_ptr: np.ndarray       # int32[N+1]
    ent_ts: np.ndarray        # int32[E]
    ent_left: np.ndarray      # int32[E]
    ent_right: np.ndarray     # int32[E]
    ent_parent: np.ndarray    # int32[E]
    # per-vertex entry points, CSR, per-vertex ascending ts
    vrow_ptr: np.ndarray      # int32[n+1]
    vent_ts: np.ndarray       # int32[VE]
    vent_node: np.ndarray     # int32[VE]
    # v2 query surface: per-version membership metadata (EDGES/SUBGRAPH
    # modes); not index payload, excluded from nbytes()
    versions: VersionStore | None = None

    backend_name = "pecb"

    @property
    def num_nodes(self) -> int:
        return int(self.node_u.shape[0])

    def nbytes(self) -> int:
        return sum(
            a.nbytes
            for a in (
                self.node_u, self.node_v, self.node_ct, self.node_edge,
                self.node_live_from, self.node_live_to,
                self.row_ptr, self.ent_ts, self.ent_left, self.ent_right,
                self.ent_parent, self.vrow_ptr, self.vent_ts, self.vent_node,
            )
        )

    # -- entry resolution (the paper's per-node binary search) ----------
    def resolve(self, node: int, ts: int):
        lo, hi = self.row_ptr[node], self.row_ptr[node + 1]
        i = lo + np.searchsorted(self.ent_ts[lo:hi], ts, side="left")
        if i == hi:
            return None  # version not in the forest at this start time
        return int(self.ent_left[i]), int(self.ent_right[i]), int(self.ent_parent[i])

    def entry_node(self, vert: int, ts: int) -> int:
        lo, hi = self.vrow_ptr[vert], self.vrow_ptr[vert + 1]
        i = lo + np.searchsorted(self.vent_ts[lo:hi], ts, side="left")
        if i == hi:
            return NONE
        return int(self.vent_node[i])

    # -- Algorithm 1 -----------------------------------------------------
    def _component_vertices(self, u: int, ts: int, te: int) -> set[int]:
        e0 = self.entry_node(u, ts)
        if e0 == NONE or self.node_ct[e0] > te:
            return set()
        result: set[int] = set()
        seen: set[int] = set()
        stack = [e0]
        while stack:
            e = stack.pop()
            if e in seen:
                continue
            seen.add(e)
            result.add(int(self.node_u[e]))
            result.add(int(self.node_v[e]))
            links = self.resolve(e, ts)
            if links is None:
                # A reachable node must be in the ts-forest; a bare assert
                # here would vanish under `python -O` and silently return a
                # truncated component.
                raise ForestInvariantError(
                    f"query ({u}, {ts}, {te}) reached node {e} outside the "
                    "ts-forest: corrupt index")
            for nb in links:
                if nb != NONE and nb not in seen and self.node_ct[nb] <= te:
                    stack.append(nb)
        return result


def _csr_sorted(ids, ts, cols, num_rows):
    """(row_ptr, sorted column arrays) for flat (id, ts, *cols) records,
    per-id ascending ts — one lexsort replaces the per-row Python loop."""
    ids = np.asarray(ids, np.int64)
    ts = np.asarray(ts, np.int32)
    order = np.lexsort((ts, ids))
    row_ptr = np.zeros(num_rows + 1, np.int32)
    np.cumsum(np.bincount(ids, minlength=num_rows), out=row_ptr[1:])
    return row_ptr, ts[order], [np.asarray(c, np.int32)[order] for c in cols]


def pack_index(g: TemporalGraph, k: int, b: IncrementalBuilder) -> PECBIndex:
    N = b.num_nodes
    row_ptr, ent_ts, (ent_l, ent_r, ent_p) = _csr_sorted(
        b.ent_node, b.ent_ts, (b.ent_l, b.ent_r, b.ent_p), N)
    vrow_ptr, vent_ts, (vent_node,) = _csr_sorted(
        b.vent_vert, b.vent_ts, (b.vent_node,), g.n)
    i32 = lambda a: np.ascontiguousarray(a[:N], np.int32)
    return PECBIndex(
        g.n, g.m, g.t_max, k,
        i32(b.n_u), i32(b.n_v), i32(b.n_ct), i32(b.n_edge),
        i32(b.n_live_from), i32(b.n_live_to),
        row_ptr, ent_ts, ent_l, ent_r, ent_p,
        vrow_ptr, vent_ts, vent_node,
        versions=VersionStore.from_table(g, k, b.tab),
    )


def build_pecb_index(g: TemporalGraph, k: int,
                     tab: CoreTimeTable | None = None, *,
                     engine: str = "auto", device="cuda",
                     resume_from: PECBIndex | None = None) -> PECBIndex:
    """End-to-end PECB construction (Alg 3) for one k: core times (``tab``,
    or built on ``device`` by ``engine``, see
    :func:`core_time.edge_core_times`) -> incremental forest maintenance
    -> packed index.

    ``resume_from`` is the streaming plane's epoch-resume path: pass the
    previous epoch's index (built for a graph that ``g`` suffix-extends via
    ``TemporalGraph.extend``) together with the extended table ``tab``
    (``extend_core_times``), and the index is *grown* from the previous
    epoch's packed arrays instead of replaying every version
    (``streaming.extend_pecb_index``). The result is bit-identical to a
    cold ``build_pecb_index(g, k)`` (test-asserted)."""
    if resume_from is not None:
        if tab is None:
            raise ValueError(
                "resume_from needs the extended table: pass "
                "tab=extend_core_times(g, k, prev_tab)")
        from .streaming import extend_pecb_index
        return extend_pecb_index(g, k, tab, resume_from)
    if tab is None:
        tab = edge_core_times(g, k, engine=engine, device=device)
    return pack_index(g, k, IncrementalBuilder(g, tab).run())


# ----------------------------------------------------------------------
# K-stratified index plane: one packed structure serves every k
# ----------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class StratifiedPECB:
    """All k strata of one workload in a single packed structure.

    Layout: the per-k PECB arrays are concatenated stratum-by-stratum,
    node/entry ids staying *local* to their stratum, with int64 pointer
    tables (``knode_ptr``/``kent_ptr``/``kvent_ptr`` and
    ``strata.kptr``) delimiting the blocks. ``slice_k(k)`` therefore
    returns a :class:`PECBIndex` of pure zero-copy views that is
    bit-identical to a standalone per-k build (test-asserted) — every
    existing host query routine, the device packer and the store
    serializer run unchanged on a slice.

    Version membership (EDGES/SUBGRAPH modes, streaming resume) rides on
    the :class:`StratifiedCoreTable` the construction already produced:
    its record blocks are exactly the per-k :class:`VersionStore`
    payloads, so the only extra per-version state is the endpoint
    columns ``ver_src/ver_dst/ver_t``.

    Query dispatch: ``answer`` routes ``k in supported_ks`` to the
    stratum slice, answers ``k > k_max_graph`` exactly empty (every
    window's k-core is a subgraph of the full-window k-core, which is
    empty beyond the graph's degeneracy), and rejects an in-range but
    unsupported k with :class:`InvalidQueryError` — silence would be a
    wrong answer, not a trivial one.
    """

    n: int
    m: int
    t_max: int
    k_max_graph: int
    ks: tuple
    # per-k node blocks (ids local to each block)
    knode_ptr: np.ndarray       # int64[|K|+1]
    node_u: np.ndarray          # int32[Ntot]
    node_v: np.ndarray
    node_ct: np.ndarray
    node_edge: np.ndarray
    node_live_from: np.ndarray
    node_live_to: np.ndarray
    # node entries: per-k CSR; block for stratum ki spans
    # row_ptr[knode_ptr[ki]+ki : knode_ptr[ki+1]+ki+1] (one extra slot each)
    row_ptr: np.ndarray         # int32[Ntot+|K|]
    kent_ptr: np.ndarray        # int64[|K|+1]
    ent_ts: np.ndarray          # int32[Etot]
    ent_left: np.ndarray
    ent_right: np.ndarray
    ent_parent: np.ndarray
    # vertex entry points: per-k CSR, one (n+1)-slot row_ptr block per k
    vrow_ptr: np.ndarray        # int32[|K|*(n+1)]
    kvent_ptr: np.ndarray       # int64[|K|+1]
    vent_ts: np.ndarray         # int32[VEtot]
    vent_node: np.ndarray
    # version membership: stratified core-time records + endpoint columns
    strata: StratifiedCoreTable | None = None
    ver_src: np.ndarray | None = None
    ver_dst: np.ndarray | None = None
    ver_t: np.ndarray | None = None

    backend_name = "pecb-stratified"

    def __post_init__(self):
        self.ks = tuple(int(k) for k in self.ks)
        self._kset = frozenset(self.ks)
        self._slices: dict[int, PECBIndex] = {}
        self._versions_all: VersionStore | None = None

    @property
    def supported_ks(self) -> tuple:
        return self.ks

    @property
    def versions(self) -> VersionStore | None:
        """One :class:`VersionStore` over ALL strata (``k=0`` marks the
        mixed view — no single k describes it). The device plane's
        version-membership masks index this global space (with the
        ``ver_k`` filter selecting each query's stratum), and
        ``select``/``member_edges`` never consult ``k``, so the serving
        planner can assemble EDGES/SUBGRAPH payloads for mixed-k batches
        through the same store interface as a per-k index."""
        if self.strata is None:
            return None
        if self._versions_all is None:
            self._versions_all = VersionStore(
                n=self.n, t_max=self.t_max, k=0,
                edge_id=self.strata.edge_id,
                ts_from=self.strata.ts_from,
                ts_to=self.strata.ts_to,
                ct=self.strata.ct,
                src=self.ver_src, dst=self.ver_dst, t=self.ver_t)
        return self._versions_all

    @property
    def num_nodes(self) -> int:
        return int(self.node_u.shape[0])

    def nbytes(self) -> int:
        """Index payload: packed arrays + stratum pointer tables. The
        version store (``strata``/``ver_*``) is excluded, mirroring
        :meth:`PECBIndex.nbytes`."""
        return sum(
            a.nbytes
            for a in (
                self.knode_ptr, self.node_u, self.node_v, self.node_ct,
                self.node_edge, self.node_live_from, self.node_live_to,
                self.row_ptr, self.kent_ptr, self.ent_ts, self.ent_left,
                self.ent_right, self.ent_parent, self.vrow_ptr,
                self.kvent_ptr, self.vent_ts, self.vent_node,
            )
        )

    def k_index(self, k: int) -> int:
        try:
            return self.ks.index(int(k))
        except ValueError:
            raise KeyError(f"k={k} not in supported_ks={self.ks}") from None

    def slice_k(self, k: int) -> PECBIndex:
        """The per-k :class:`PECBIndex` view of stratum ``k`` (cached;
        zero-copy; bit-identical to a standalone build)."""
        k = int(k)
        hit = self._slices.get(k)
        if hit is not None:
            return hit
        ki = self.k_index(k)
        s, e = int(self.knode_ptr[ki]), int(self.knode_ptr[ki + 1])
        es, ee = int(self.kent_ptr[ki]), int(self.kent_ptr[ki + 1])
        vs, ve = int(self.kvent_ptr[ki]), int(self.kvent_ptr[ki + 1])
        rs = s + ki
        vr = ki * (self.n + 1)
        versions = None
        if self.strata is not None:
            ss, se = int(self.strata.kptr[ki]), int(self.strata.kptr[ki + 1])
            versions = VersionStore(
                n=self.n, t_max=self.t_max, k=k,
                edge_id=self.strata.edge_id[ss:se],
                ts_from=self.strata.ts_from[ss:se],
                ts_to=self.strata.ts_to[ss:se],
                ct=self.strata.ct[ss:se],
                src=self.ver_src[ss:se], dst=self.ver_dst[ss:se],
                t=self.ver_t[ss:se])
        idx = PECBIndex(
            self.n, self.m, self.t_max, k,
            self.node_u[s:e], self.node_v[s:e], self.node_ct[s:e],
            self.node_edge[s:e], self.node_live_from[s:e],
            self.node_live_to[s:e],
            self.row_ptr[rs:rs + (e - s) + 1],
            self.ent_ts[es:ee], self.ent_left[es:ee],
            self.ent_right[es:ee], self.ent_parent[es:ee],
            self.vrow_ptr[vr:vr + self.n + 1],
            self.vent_ts[vs:ve], self.vent_node[vs:ve],
            versions=versions)
        self._slices[k] = idx
        return idx

    def answer(self, q: TCCSQuery) -> TCCSResult:
        q.validate(n=self.n)
        if q.k in self._kset:
            return self.slice_k(q.k).answer(q)
        if q.k > self.k_max_graph:
            cq = q.canonical(self.t_max)
            prov = Provenance(route="trivial", backend=self.backend_name)
            return empty_result(cq, self.n, prov)
        raise InvalidQueryError(
            f"k={q.k} is not served by this index "
            f"(supported_ks={self.ks}, k_max={self.k_max_graph})")

    def answer_many(self, specs) -> list:
        return [self.answer(q) for q in specs]

    @classmethod
    def from_parts(cls, strata: StratifiedCoreTable,
                   indices: list, k_max_graph: int,
                   ver_src: np.ndarray, ver_dst: np.ndarray,
                   ver_t: np.ndarray) -> "StratifiedPECB":
        ks = strata.ks
        if len(indices) != len(ks):
            raise ValueError("one PECBIndex per stratum required")
        z32 = np.zeros(0, np.int32)

        def ptr(sizes):
            p = np.zeros(len(sizes) + 1, np.int64)
            np.cumsum(np.asarray(sizes, np.int64), out=p[1:])
            return p

        def cat(field):
            arrs = [getattr(ix, field) for ix in indices]
            return np.concatenate(arrs) if arrs else z32.copy()

        return cls(
            n=strata.n, m=strata.m, t_max=strata.t_max,
            k_max_graph=int(k_max_graph), ks=ks,
            knode_ptr=ptr([ix.num_nodes for ix in indices]),
            node_u=cat("node_u"), node_v=cat("node_v"),
            node_ct=cat("node_ct"), node_edge=cat("node_edge"),
            node_live_from=cat("node_live_from"),
            node_live_to=cat("node_live_to"),
            row_ptr=cat("row_ptr"),
            kent_ptr=ptr([ix.ent_ts.shape[0] for ix in indices]),
            ent_ts=cat("ent_ts"), ent_left=cat("ent_left"),
            ent_right=cat("ent_right"), ent_parent=cat("ent_parent"),
            vrow_ptr=cat("vrow_ptr"),
            kvent_ptr=ptr([ix.vent_ts.shape[0] for ix in indices]),
            vent_ts=cat("vent_ts"), vent_node=cat("vent_node"),
            strata=strata, ver_src=ver_src, ver_dst=ver_dst, ver_t=ver_t)


def _assemble_stratified(g: TemporalGraph, stab: StratifiedCoreTable,
                         indices: list, k_max_graph: int) -> StratifiedPECB:
    """Pack per-stratum indices + the stratified table into one
    :class:`StratifiedPECB` (shared by cold build and streaming)."""
    eid = stab.edge_id
    return StratifiedPECB.from_parts(
        stab, indices, k_max_graph,
        ver_src=g.src[eid].astype(np.int32),
        ver_dst=g.dst[eid].astype(np.int32),
        ver_t=g.t[eid].astype(np.int32))


def _forest_builder(g: TemporalGraph, tab: CoreTimeTable):
    """Fastest available forest engine: native C when compilable (the
    stratified plane's |K|-fold build makes this the dominant cost),
    else the list-based Python fast path. Both pack bit-identically to
    the base builder (test-asserted)."""
    from . import ecb_native
    if ecb_native.available():
        return ecb_native.NativeForestBuilder(g, tab).run()
    return FastIncrementalBuilder(g, tab).run()


def build_stratified_index(g: TemporalGraph, ks=None, *,
                           strata: StratifiedCoreTable | None = None,
                           engine: str = "auto",
                           device="cuda") -> StratifiedPECB:
    """One build serving every k: fused stratified core-time sweep (on
    ``device`` by ``engine``, see :func:`core_time.stratified_core_times`),
    then one forest per stratum through the fastest available host
    engine, packed into a single :class:`StratifiedPECB`.

    ``ks=None`` covers the graph's full coreness range
    (:func:`core_time.default_ks`); pass ``strata`` to reuse a table
    already built.
    """
    from .kcore import k_max as _graph_k_max
    stab = strata if strata is not None else stratified_core_times(
        g, ks, engine=engine, device=device)
    indices = []
    for k in stab.ks:
        b = _forest_builder(g, stab.table_for(int(k)))
        indices.append(pack_index(g, int(k), b))
    return _assemble_stratified(g, stab, indices, _graph_k_max(g))
