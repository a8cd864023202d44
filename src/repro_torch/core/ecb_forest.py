"""ECB-Forest (paper §4.1, Def 4.9) and its incremental maintenance (§5).

Forest nodes are *versions*: (graph edge, core time) pairs — the paper treats
an edge whose core time changes as a new parallel edge (Table 2: e10/e11).
Rank is the paper's total order: ``(CT, edge_id)`` ascending (edge ids are
assigned in ``(t, u, v)`` order by :class:`TemporalGraph`, matching the
paper's tie-break and its Table 2 numbering). Internally ranks are packed as
``ct * (m + 1) + edge_id`` in int64 so one scalar compare replaces the tuple
compare.

:class:`IncrementalBuilder` is the paper's Algorithm 2/3. For each new node
we locate ``l, r, eu, ev`` (findInsertion: incidence lookup + parent-chain
climb, O(h)) and then run the WE-operator cascade. We implement the cascade
as an explicit *sorted zipper merge* of the two ancestor chains: each loop
iteration re-hangs the lowest-ranked pending attachment (one WE
application); when the chains meet, the meeting node is the LCA of
Lemma 5.7 — the expired edge — and is deleted, its parent adopting the
merged chain.

:func:`build_forest_at` is the from-scratch construction per start time,
directly from Def 4.9: Kruskal over ranks, then a union-find sweep in
ascending rank where each component tracks its maximum-rank node; a new
node's left/right children are the component maxima of its endpoints. It
is the oracle the builder is tested against (uniqueness of the ECB forest
follows from the total order), and :func:`active_versions` feeds the
baselines (``ef_index``, ``ctmsf``).

PyTorch port of ``repro.core.ecb_forest`` (host code, copied so the port
stands alone). The builder's hot structures are numpy-backed stores:

* the node table is a set of preallocated flat arrays (one slot per version
  record — an upper bound on inserts), not per-node Python lists;
* per-vertex incidence is a pair of parallel sorted lists of *packed int
  ranks* + node ids (C bisect/insort; no tuple allocation, and for the tiny
  lists a live forest produces, cheaper than numpy's per-scalar
  searchsorted overhead);
* delta entries go to flat append buffers deduplicated against a packed
  ``last recorded (l, r, p)`` array; ``pack_index`` turns them into the CSR
  arrays with one lexsort instead of a per-node Python loop;
* a bulk *MSF prefilter* (Def 4.9: the forest at any start time is the
  unique rank-MSF of the active versions) rejects the ~95+% of candidate versions that join no MSF before they ever
  reach the Python insert path. ``insert`` keeps its own cycle check, so the
  prefilter is a pure accelerator: a false *accept* costs one wasted insert
  attempt; false rejects cannot occur (the MSF is exact). Small inputs run
  a direct Kruskal (the fixed sparse-matrix cost dominates there); large
  ones use scipy's C MSF, or Kruskal again when scipy is unavailable.

Invariant violations raise :class:`ForestInvariantError` instead of bare
``assert`` (which vanishes under ``python -O`` and would corrupt the index
silently).
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from .core_time import CoreTimeTable

NONE = -1

try:  # the prefilter's MSF runs in C; optional (see module docstring)
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    _HAVE_SCIPY = True
except ImportError:  # pragma: no cover - scipy is bundled in CI/dev images
    _HAVE_SCIPY = False


class ForestInvariantError(RuntimeError):
    """A structural invariant of the ECB forest was violated (corrupt
    builder state); raised eagerly so a broken index is never served."""


# ----------------------------------------------------------------------
# From-scratch reference construction (Def 4.9)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ForestSnapshot:
    """ECB forest for one start time. Arrays indexed by *version id* into the
    version table of the CoreTimeTable ordering used to build it."""

    version_key: dict  # (edge_id, ct) -> local node index
    u: np.ndarray
    v: np.ndarray
    ct: np.ndarray
    edge_id: np.ndarray
    left: np.ndarray
    right: np.ndarray
    parent: np.ndarray
    in_forest: np.ndarray  # bool; False = version active at ts but not in MSF


def active_versions(tab: CoreTimeTable, ts: int):
    """(edge_id, ct) of versions valid at start time ts, rank-sorted."""
    sel = (tab.ts_from <= ts) & (ts <= tab.ts_to)
    e, c = tab.edge_id[sel], tab.ct[sel]
    order = np.lexsort((e, c))
    return e[order], c[order]


def build_forest_at(g, tab: CoreTimeTable, ts: int) -> ForestSnapshot:
    e_ids, cts = active_versions(tab, ts)
    nn = e_ids.shape[0]
    u = g.src[e_ids].astype(np.int64)
    v = g.dst[e_ids].astype(np.int64)
    left = np.full(nn, NONE, np.int64)
    right = np.full(nn, NONE, np.int64)
    parent = np.full(nn, NONE, np.int64)
    in_forest = np.zeros(nn, bool)

    # union-find over graph vertices; each root remembers the max-rank node
    uf = {}
    comp_max = {}

    def find(x):
        root = x
        while uf.get(root, root) != root:
            root = uf[root]
        while uf.get(x, x) != x:
            uf[x], x = root, uf[x]
        return root

    for i in range(nn):
        a, b = int(u[i]), int(v[i])
        ra, rb = find(a), find(b)
        if ra == rb:
            continue  # not in MSF (cycle)
        in_forest[i] = True
        la = comp_max.get(ra, NONE)
        lb = comp_max.get(rb, NONE)
        left[i], right[i] = la, lb
        if la != NONE:
            parent[la] = i
        if lb != NONE:
            parent[lb] = i
        uf[ra] = rb
        comp_max[rb] = i
        comp_max.pop(ra, None)

    key = {(int(e_ids[i]), int(cts[i])): i for i in range(nn)}
    return ForestSnapshot(key, u, v, cts.astype(np.int64), e_ids.astype(np.int64),
                          left, right, parent, in_forest)


# ----------------------------------------------------------------------
# Incremental builder (Algorithms 2 and 3)
# ----------------------------------------------------------------------

class IncrementalBuilder:
    """Maintains the ECB forest while the start time descends, recording
    delta-compressed PECB entries (paper §4.1) plus per-vertex entry-point
    versions for Algorithm 1 line 3. See the module docstring for the
    numpy-backed store layout and the MSF candidate prefilter."""

    def __init__(self, g, tab: CoreTimeTable, *, prefilter: bool = True):
        self.g = g
        self.tab = tab
        self.prefilter = prefilter
        R = tab.num_versions
        self._cap = R
        self._stride = np.int64(g.m + 1)       # rank = ct * stride + edge
        # scipy MSF carries weights as float64: only exact while every
        # packed rank fits the 53-bit mantissa (else Kruskal, always exact)
        self._scipy_exact = (tab.t_max + 1) * (g.m + 1) < 2 ** 53
        # node store: preallocated flat arrays (<= one insert per record)
        self.n_edge = np.zeros(R, np.int32)
        self.n_ct = np.zeros(R, np.int32)
        self.n_u = np.zeros(R, np.int32)
        self.n_v = np.zeros(R, np.int32)
        self.n_child = np.full((R, 2), NONE, np.int32)  # aligned to (u, v)
        self.n_parent = np.full(R, NONE, np.int32)
        self.n_in = np.zeros(R, bool)
        self.n_rank = np.zeros(R, np.int64)
        self.num_nodes = 0
        # forest-membership lifetime per node: [live_from, live_to] inclusive.
        # live_to = the start time whose processing inserted the node;
        # live_from = (deletion start time + 1), or 1 if never deleted.
        # The device query plane (batch_query.py) needs these to mask the
        # stale links of dead nodes; the host DFS never reaches them.
        self.n_live_from = np.ones(R, np.int32)
        self.n_live_to = np.zeros(R, np.int32)
        # per-vertex sorted incidence: parallel lists of packed int ranks +
        # node ids. Plain ints (no tuples: tuple allocation is the hotspot)
        # with C bisect/insort — for the tiny per-vertex lists a live forest
        # produces, this beats numpy's per-scalar searchsorted overhead.
        self._inc_key: list[list[int]] = [[] for _ in range(g.n)]
        self._inc_node: list[list[int]] = [[] for _ in range(g.n)]
        # live-node registry (swap-remove) feeding the MSF prefilter
        self._live = np.zeros(R, np.int32)
        self._live_pos = np.full(R, -1, np.int64)
        self._nlive = 0
        # delta-entry buffers; pack_index CSR-ifies them with one lexsort
        self.ent_node: list[int] = []
        self.ent_ts: list[int] = []
        self.ent_l: list[int] = []
        self.ent_r: list[int] = []
        self.ent_p: list[int] = []
        self.vent_vert: list[int] = []
        self.vent_ts: list[int] = []
        self.vent_node: list[int] = []
        # last-recorded (l, r, p) per node / entry node per vertex; -2 is
        # "never recorded" (NONE = -1 is a legal value)
        self._last = np.full((R, 3), -2, np.int32)
        self._last_vent = np.full(g.n, -2, np.int64)
        self._cur_ts: int = 0
        self._dirty_nodes: set[int] = set()
        self._dirty_verts: set[int] = set()

    # -- helpers --------------------------------------------------------
    def rank(self, x: int) -> tuple:
        return (int(self.n_ct[x]), int(self.n_edge[x]))

    def _new_node(self, edge_id: int, ct: int) -> int:
        x = self.num_nodes
        if x >= self._cap:
            raise ForestInvariantError(
                f"more inserts than version records ({self._cap})")
        self.num_nodes = x + 1
        self.n_edge[x] = edge_id
        self.n_ct[x] = ct
        self.n_u[x] = self.g.src[edge_id]
        self.n_v[x] = self.g.dst[edge_id]
        self.n_rank[x] = np.int64(ct) * self._stride + edge_id
        self.n_live_to[x] = self._cur_ts
        return x

    def _live_add(self, x: int):
        self._live[self._nlive] = x
        self._live_pos[x] = self._nlive
        self._nlive += 1

    def _live_remove(self, x: int):
        pos = int(self._live_pos[x])
        if pos < 0:
            raise ForestInvariantError(f"node {x} not live")
        last = self._nlive - 1
        mv = self._live[last]
        self._live[pos] = mv
        self._live_pos[mv] = pos
        self._live_pos[x] = -1
        self._nlive = last

    def _slot_of(self, node: int, child: int) -> int:
        c = self.n_child[node]
        if c[0] == child:
            return 0
        if c[1] != child:
            raise ForestInvariantError(
                f"node {child} is not a child of {node} ({c.tolist()})")
        return 1

    def _slot_for_vertex(self, node: int, vert: int) -> int:
        return 0 if self.n_u[node] == vert else 1

    def _inc_add(self, vert: int, node: int, key: int):
        keys = self._inc_key[vert]
        i = bisect.bisect_left(keys, key)
        keys.insert(i, key)
        self._inc_node[vert].insert(i, node)
        self._dirty_verts.add(vert)

    def _inc_remove(self, vert: int, node: int):
        keys = self._inc_key[vert]
        nodes = self._inc_node[vert]
        i = bisect.bisect_left(keys, int(self.n_rank[node]))
        if i >= len(keys) or nodes[i] != node:
            raise ForestInvariantError(
                f"node {node} missing from vertex {vert} incidence")
        keys.pop(i)
        nodes.pop(i)
        self._dirty_verts.add(vert)

    def _find_side(self, vert: int, rk: int):
        """findInsertion for one endpoint: returns (child, attach, via_slot).

        child  = component maximum below ``rk`` on this side (Def 4.9 child),
        attach = its old parent / lowest incident node above ``rk``,
        via_slot = slot index in ``attach`` consumed by the merge.
        """
        keys, nodes = self._inc_key[vert], self._inc_node[vert]
        cnt = len(keys)
        i = bisect.bisect_left(keys, rk)
        child = nodes[i - 1] if i > 0 else NONE
        attach = nodes[i] if i < cnt else NONE
        if child != NONE:
            # climb to the component maximum below rk (Alg 2 lines 5-9)
            parent, rank = self.n_parent, self.n_rank
            p = int(parent[child])
            while p != NONE and rank[p] < rk:
                child = p
                p = int(parent[child])
            attach = p
            via = self._slot_of(attach, child) if attach != NONE else NONE
        else:
            via = self._slot_for_vertex(attach, vert) if attach != NONE else NONE
            if attach != NONE and self.n_child[attach, via] != NONE:
                raise ForestInvariantError(
                    f"entry slot {via} of node {attach} unexpectedly taken")
        return child, attach, via

    # -- bulk candidate prefilter (Def 4.9 MSF membership) ---------------
    #: below this many (live + candidate) edges a direct Kruskal beats the
    #: fixed per-call cost of building a sparse matrix + scipy MST
    _KRUSKAL_CUTOVER = 128

    def _accept_mask(self, cand_edge: np.ndarray,
                     cand_ct: np.ndarray) -> np.ndarray:
        """bool mask: which candidate versions can join the forest at the
        current start time. Exact: a candidate joins iff it is in the unique
        rank-MSF over (live nodes + candidates)."""
        nc = cand_edge.shape[0]
        if not self.prefilter or nc == 0:
            return np.ones(nc, bool)
        n = self.g.n
        live = self._live[:self._nlive]
        crank = cand_ct.astype(np.int64) * self._stride + cand_edge
        u = np.concatenate([self.n_u[live], self.g.src[cand_edge]]).astype(np.int64)
        v = np.concatenate([self.n_v[live], self.g.dst[cand_edge]]).astype(np.int64)
        wt = np.concatenate([self.n_rank[live], crank])
        if (wt.shape[0] <= self._KRUSKAL_CUTOVER or not _HAVE_SCIPY
                or not self._scipy_exact):
            # Kruskal in rank order; parallel pairs need no dedup (the
            # union-find rejects the higher-ranked duplicate naturally)
            order = np.argsort(wt, kind="stable")
            nl = live.shape[0]
            parent = {}

            def find(x):
                root = x
                while parent.get(root, root) != root:
                    root = parent[root]
                while parent.get(x, x) != x:
                    parent[x], x = root, parent[x]
                return root

            accept = np.zeros(nc, bool)
            for i in order.tolist():
                ra, rb = find(int(u[i])), find(int(v[i]))
                if ra != rb:
                    parent[ra] = rb
                    if i >= nl:
                        accept[i - nl] = True
            return accept
        key = np.minimum(u, v) * n + np.maximum(u, v)
        order = np.lexsort((wt, key))
        key_s, wt_s = key[order], wt[order]
        first = np.ones(key_s.shape[0], bool)
        first[1:] = key_s[1:] != key_s[:-1]   # min-rank edge per vertex pair
        ek, ew = key_s[first], wt_s[first]
        # compact vertex ids + direct CSR build: the per-call cost is fixed
        # overhead (matrix conversion, O(n) Prim init), not the MSF itself,
        # and this runs once per start time
        r, c = ek // n, ek % n
        verts, inv = np.unique(np.concatenate([r, c]), return_inverse=True)
        nv = verts.shape[0]
        ri, ci = inv[:r.shape[0]], inv[r.shape[0]:]
        csr_order = np.argsort(ri, kind="stable")
        indptr = np.zeros(nv + 1, np.int32)
        np.cumsum(np.bincount(ri, minlength=nv), out=indptr[1:])
        mat = csr_matrix(((ew[csr_order] + 1).astype(np.float64),
                          ci[csr_order].astype(np.int32), indptr),
                         shape=(nv, nv))
        kept = (np.asarray(minimum_spanning_tree(mat).data) - 1).astype(np.int64)
        return np.isin(crank, kept)

    # -- core insert (Alg 2 + Alg 3 Merge/WE cascade as a zipper) --------
    def insert(self, edge_id: int, ct: int) -> int | None:
        """Insert the version (edge_id, ct); returns the expired node or None.
        Returns None without side effects when the version joins no MSF."""
        g = self.g
        uu, vv = int(g.src[edge_id]), int(g.dst[edge_id])
        if uu == vv:
            # self-loops are degenerate for k-core (from_edges drops them,
            # but direct construction admits them); inserting one would run
            # the zipper against a single vertex and corrupt the forest
            return None
        rk = int(np.int64(ct) * self._stride + edge_id)
        l, eu, via_u = self._find_side(uu, rk)
        r, ev, via_v = self._find_side(vv, rk)
        if l != NONE and l == r:
            # u, v already connected below rk: the new edge is the
            # highest-ranked edge of the induced cycle -> not in the MSF.
            return None

        x = self._new_node(edge_id, ct)
        self.n_in[x] = True
        self.n_child[x, 0] = l
        self.n_child[x, 1] = r
        if l != NONE:
            self.n_parent[l] = x
            self._dirty_nodes.add(l)
        if r != NONE:
            self.n_parent[r] = x
            self._dirty_nodes.add(r)
        self._inc_add(uu, x, rk)
        self._inc_add(vv, x, rk)
        self._live_add(x)
        self._dirty_nodes.add(x)

        # zipper merge of the two ancestor chains (WE-operator cascade)
        via = {}
        if eu != NONE:
            via[eu] = via_u
        if ev != NONE:
            via[ev] = via_v
        cur, a, b = x, eu, ev
        expired = None
        rank = self.n_rank
        while True:
            if a == NONE and b == NONE:
                self.n_parent[cur] = NONE
                break
            if a == NONE or b == NONE:
                t = a if a != NONE else b
                self.n_parent[cur] = t
                self.n_child[t, via[t]] = cur
                self._dirty_nodes.add(t)
                break
            if a == b:
                # Lemma 5.7: the meeting node is the cycle's LCA -> expired
                expired = a
                p = int(self.n_parent[a])
                self.n_parent[cur] = p
                if p != NONE:
                    self.n_child[p, self._slot_of(p, a)] = cur
                    self._dirty_nodes.add(p)
                self._delete_node(a)
                break
            lo, hi = (a, b) if rank[a] < rank[b] else (b, a)
            nxt = int(self.n_parent[lo])
            self.n_parent[cur] = lo
            self.n_child[lo, via[lo]] = cur
            self._dirty_nodes.add(lo)
            if nxt != NONE:
                via[nxt] = self._slot_of(nxt, lo)
            cur, a, b = lo, nxt, hi
        return expired

    def _delete_node(self, x: int):
        self.n_in[x] = False
        self.n_live_from[x] = self._cur_ts + 1
        self._inc_remove(int(self.n_u[x]), x)
        self._inc_remove(int(self.n_v[x]), x)
        self._live_remove(x)
        self._dirty_nodes.discard(x)

    # -- per-ts entry flush ----------------------------------------------
    def flush(self, ts: int):
        """Record delta entries for everything that changed at this start
        time (paper: an item is stored only if the neighbourhood differs
        from the previous start time)."""
        last = self._last
        for x in self._dirty_nodes:
            if not self.n_in[x]:
                continue
            l = int(self.n_child[x, 0])
            r = int(self.n_child[x, 1])
            p = int(self.n_parent[x])
            if last[x, 0] != l or last[x, 1] != r or last[x, 2] != p:
                last[x, 0] = l
                last[x, 1] = r
                last[x, 2] = p
                self.ent_node.append(x)
                self.ent_ts.append(ts)
                self.ent_l.append(l)
                self.ent_r.append(r)
                self.ent_p.append(p)
        for vert in self._dirty_verts:
            lst = self._inc_node[vert]
            node = lst[0] if lst else NONE
            if self._last_vent[vert] != node:
                self._last_vent[vert] = node
                self.vent_vert.append(vert)
                self.vent_ts.append(ts)
                self.vent_node.append(node)
        self._dirty_nodes.clear()
        self._dirty_verts.clear()

    # -- full build -------------------------------------------------------
    def run(self):
        """Process all version records in descending start time (Alg 3):
        per ts, bulk-prefilter the candidate versions, insert the survivors
        in ascending rank, then flush the delta entries."""
        tab = self.tab
        order = np.lexsort((tab.edge_id, tab.ct, -tab.ts_to))
        e_sorted = tab.edge_id[order].astype(np.int64)
        c_sorted = tab.ct[order].astype(np.int64)
        neg_ts = -tab.ts_to[order].astype(np.int64)   # ascending
        R = order.shape[0]
        done = 0
        for ts in range(tab.t_max, 0, -1):
            self._cur_ts = ts
            lo = int(np.searchsorted(neg_ts, -ts, side="left"))
            hi = int(np.searchsorted(neg_ts, -ts, side="right"))
            if hi > lo:
                ce, cc = e_sorted[lo:hi], c_sorted[lo:hi]
                acc = self._accept_mask(ce, cc)
                for e, c in zip(ce[acc].tolist(), cc[acc].tolist()):
                    self.insert(e, c)
                done = hi
            self.flush(ts)
        if done != R:
            raise ForestInvariantError(
                f"processed {done} of {R} version records")
        return self


class FastIncrementalBuilder(IncrementalBuilder):
    """`IncrementalBuilder` with the per-node hot state in Python lists.

    The zipper cascade and the findInsertion climb are scalar pointer
    chases — a few reads/writes of parent/child/rank per hop, tens of
    hops per insert. Numpy scalar indexing pays ~5x a list access for
    each of them, and the ``via`` slot bookkeeping allocated a dict per
    insert; this subclass keeps ``parent/child0/child1/rank/in`` as plain
    lists during `run` and resolves slots by direct child comparison.
    The numpy node arrays that the MSF prefilter and `pack_index` read
    (``n_u/n_v/n_ct/n_edge/n_rank/n_live_*``) stay maintained throughout,
    and `run` writes the list state back into ``n_parent``/``n_child`` so
    the finished builder is indistinguishable from the base class.

    The construction order is identical — same prefilter, same
    ascending-rank inserts, same flush — so the recorded entries are
    bit-identical to the base builder's (per-ts forests are unique, and
    node ids are assigned in the same insertion order). Tests assert
    exactly this; the stratified plane (`build_stratified_index`) uses
    the fast builder while the per-k oracle path keeps the base class.
    """

    def __init__(self, g, tab: CoreTimeTable, *, prefilter: bool = True):
        super().__init__(g, tab, prefilter=prefilter)
        R = self._cap
        self._parent_l: list[int] = [NONE] * R
        self._child0_l: list[int] = [NONE] * R
        self._child1_l: list[int] = [NONE] * R
        self._rank_l: list[int] = [0] * R
        self._in_l: list[bool] = [False] * R
        # last-recorded (l, r, p) per node as lists (-2 = never recorded)
        self._last_l: list[int] = [-2] * (3 * R)

    def _new_node(self, edge_id: int, ct: int) -> int:
        x = super()._new_node(edge_id, ct)
        self._rank_l[x] = int(self.n_rank[x])
        return x

    def _find_side(self, vert: int, rk: int):
        keys, nodes = self._inc_key[vert], self._inc_node[vert]
        i = bisect.bisect_left(keys, rk)
        if i > 0:
            child = nodes[i - 1]
            parent, rank = self._parent_l, self._rank_l
            p = parent[child]
            while p != NONE and rank[p] < rk:
                child = p
                p = parent[child]
            if p == NONE:
                return child, NONE, NONE
            if self._child0_l[p] == child:
                return child, p, 0
            if self._child1_l[p] != child:
                raise ForestInvariantError(
                    f"node {child} is not a child of {p}")
            return child, p, 1
        if i >= len(keys):
            return NONE, NONE, NONE
        attach = nodes[i]
        via = 0 if self.n_u[attach] == vert else 1
        taken = self._child0_l[attach] if via == 0 else self._child1_l[attach]
        if taken != NONE:
            raise ForestInvariantError(
                f"entry slot {via} of node {attach} unexpectedly taken")
        return NONE, attach, via

    def insert(self, edge_id: int, ct: int) -> int | None:
        g = self.g
        uu, vv = int(g.src[edge_id]), int(g.dst[edge_id])
        if uu == vv:
            return None
        rk = int(np.int64(ct) * self._stride + edge_id)
        l, eu, va = self._find_side(uu, rk)
        r, ev, vb = self._find_side(vv, rk)
        if l != NONE and l == r:
            return None

        x = self._new_node(edge_id, ct)
        parent, c0, c1 = self._parent_l, self._child0_l, self._child1_l
        rank = self._rank_l
        dirty = self._dirty_nodes
        self._in_l[x] = True
        c0[x] = l
        c1[x] = r
        if l != NONE:
            parent[l] = x
            dirty.add(l)
        if r != NONE:
            parent[r] = x
            dirty.add(r)
        self._inc_add(uu, x, rk)
        self._inc_add(vv, x, rk)
        self._live_add(x)
        dirty.add(x)

        # zipper merge; (a, va) and (b, vb) are the chain heads and the
        # slot each will hand to the node hung beneath it
        cur, a, b = x, eu, ev
        expired = None
        while True:
            if a == NONE and b == NONE:
                parent[cur] = NONE
                break
            if a == NONE or b == NONE:
                t, s = (a, va) if a != NONE else (b, vb)
                parent[cur] = t
                if s == 0:
                    c0[t] = cur
                else:
                    c1[t] = cur
                dirty.add(t)
                break
            if a == b:
                # Lemma 5.7: the meeting node is the cycle's LCA -> expired
                expired = a
                p = parent[a]
                parent[cur] = p
                if p != NONE:
                    if c0[p] == a:
                        c0[p] = cur
                    elif c1[p] == a:
                        c1[p] = cur
                    else:
                        raise ForestInvariantError(
                            f"node {a} is not a child of {p}")
                    dirty.add(p)
                self._delete_node(a)
                break
            if rank[a] < rank[b]:
                lo, vlo = a, va
            else:
                lo, vlo, b, vb = b, vb, a, va
            nxt = parent[lo]
            parent[cur] = lo
            if vlo == 0:
                c0[lo] = cur
            else:
                c1[lo] = cur
            dirty.add(lo)
            if nxt != NONE:
                if c0[nxt] == lo:
                    va = 0
                elif c1[nxt] == lo:
                    va = 1
                else:
                    raise ForestInvariantError(
                        f"node {lo} is not a child of {nxt}")
            cur, a = lo, nxt
        return expired

    def _delete_node(self, x: int):
        self._in_l[x] = False
        self.n_live_from[x] = self._cur_ts + 1
        self._inc_remove(int(self.n_u[x]), x)
        self._inc_remove(int(self.n_v[x]), x)
        self._live_remove(x)
        self._dirty_nodes.discard(x)

    def flush(self, ts: int):
        last = self._last_l
        in_l, c0, c1 = self._in_l, self._child0_l, self._child1_l
        parent = self._parent_l
        ent_node, ent_ts = self.ent_node, self.ent_ts
        ent_l, ent_r, ent_p = self.ent_l, self.ent_r, self.ent_p
        for x in self._dirty_nodes:
            if not in_l[x]:
                continue
            l, r, p = c0[x], c1[x], parent[x]
            j = 3 * x
            if last[j] != l or last[j + 1] != r or last[j + 2] != p:
                last[j] = l
                last[j + 1] = r
                last[j + 2] = p
                ent_node.append(x)
                ent_ts.append(ts)
                ent_l.append(l)
                ent_r.append(r)
                ent_p.append(p)
        for vert in self._dirty_verts:
            lst = self._inc_node[vert]
            node = lst[0] if lst else NONE
            if self._last_vent[vert] != node:
                self._last_vent[vert] = node
                self.vent_vert.append(vert)
                self.vent_ts.append(ts)
                self.vent_node.append(node)
        self._dirty_nodes.clear()
        self._dirty_verts.clear()

    def run(self):
        super().run()
        # write the list state back so the finished builder's numpy node
        # arrays match the base class bit for bit
        N = self.num_nodes
        if N:
            self.n_parent[:N] = self._parent_l[:N]
            self.n_child[:N, 0] = self._child0_l[:N]
            self.n_child[:N, 1] = self._child1_l[:N]
            self.n_in[:N] = self._in_l[:N]
            self._last[:N] = np.asarray(
                self._last_l[:3 * N], np.int32).reshape(N, 3)
        return self
