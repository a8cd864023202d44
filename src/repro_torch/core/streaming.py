"""Streaming epoch plane: grow a packed PECB index across suffix epochs,
shrink it across prefix-expiry (retention) epochs.

``TemporalGraph.extend`` appends *suffix* edges (every timestamp strictly
newer than ``t_max``) and yields the next graph epoch;
``core_time.extend_core_times`` grows the core-time table; this module
grows the **packed PECB index** — bit-identical to a cold
``build_pecb_index`` on the merged edge list (test-asserted), at a small
fraction of the cost.

Why a suffix append is cheap (the two structural facts everything below
rests on):

1.  **Old records are final, new records rank above them.** A finite
    core-time cell ``CT(e)_ts <= t_old`` describes a window that contains
    no appended edge, so it cannot change; cells that were ``INF`` in the
    old epoch can only become finite with ``ct in (t_old, t_new]``. Hence
    the new epoch's version set is exactly *old records (verbatim) + new
    records, all with ct > t_old* — and since the ECB rank is ``(ct,
    edge_id)`` ascending, **every new record outranks every old record**.

2.  **The old forest layer is epoch-invariant.** The ECB forest at start
    time ``ts`` is the unique rank-MSF of the active versions with
    children = per-endpoint component maxima (Def 4.9). Kruskal consumes
    edges in ascending rank, so the sub-forest over old records is decided
    before any new record is examined: old nodes keep their children, their
    acceptance, and their forest lifetimes from the old epoch, and old
    expiries replay identically (the expired LCA of an old insert lies on
    an old path). New records only ever (a) form an **overlay** on top —
    attaching to the *roots* of old components — and (b) expire *other
    overlay nodes*. The only old-node state that can change is the parent
    pointer of an old root that gets **adopted** by an overlay node, and
    the per-vertex entry point of a vertex whose old layer offers none.

The grow algorithm is therefore *snapshot differencing*, not cascade
replay: sweep ``ts`` from ``t_new`` down to 1, maintain the old layer by
replaying the previous epoch's **recorded delta entries** (cheap array
scatters — no Python forest work), and per ts build the overlay from
scratch as a Kruskal over the new records on the **contracted graph**
whose supernodes are old-component roots (found by pointer-jumping over
the replayed parent array). Because the incremental builder's state at
every ts equals the canonical Def-4.9 construction (link-exact, slot-exact
— asserted against ``build_forest_at``), consecutive-ts snapshot diffs
reproduce the cold builder's delta-compressed entries exactly. Finally,
node ids are renumbered to the cold build's insertion order — which is
fully determined by ``(live_to descending, rank ascending)`` — and every
id reference is remapped, yielding bit-identical packed arrays.

Cost: ``O(t_new)`` vectorized old-layer replay steps plus per-ts overlay
work proportional to the *active new records* (with per-contracted-pair
dedup before the Python Kruskal), plus one final lexsort pack — versus the
cold build's Python insert cascade over *all* versions.

PyTorch port of ``repro.core.streaming`` (host numpy, copied so the port
stands alone). The stratified entry points take the construction's
``engine``/``device`` arguments for the core-time sweeps they run (a
suffix epoch's rows on the card by default, see
``core_time.extend_stratified_core_times``); the forests grow and shrink
on the host.
"""

from __future__ import annotations

import numpy as np

from .core_time import (CoreTimeTable, default_ks,
                        extend_stratified_core_times, kcore_device,
                        shrink_stratified_core_times)
from .ecb_forest import NONE, ForestInvariantError
from .pecb_index import (PECBIndex, StratifiedPECB, _assemble_stratified,
                         _csr_sorted, _forest_builder, pack_index)
from .query_api import VersionStore
from .temporal_graph import TemporalGraph


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def array_delta(prev, new) -> str:
    """Classify how ``new`` relates to ``prev`` across one epoch step:
    ``"reuse"`` (identical), ``"suffix"`` (1-D, ``prev`` is a strict
    prefix — graph edge arrays under a suffix append), ``"prefix"`` (1-D,
    ``prev`` is a strict *suffix* — the packed node-table arrays: the cold
    insertion order is ``(live_to desc, rank asc)``, so an epoch's new
    overlay nodes renumber *in front of* the old nodes, whose relative
    order is preserved verbatim), else ``"full"``. The persistent store
    keys its delta commits on this (DESIGN.md §13.2): reuse re-references
    the on-disk parts, suffix/prefix write only the changed bytes."""
    if prev is None:
        return "full"
    prev, new = np.asarray(prev), np.asarray(new)
    if prev.dtype != new.dtype:
        return "full"
    if prev.shape == new.shape and np.array_equal(prev, new):
        return "reuse"
    if prev.ndim == 1 and new.ndim == 1 and new.size > prev.size:
        if np.array_equal(new[:prev.size], prev):
            return "suffix"
        if np.array_equal(new[new.size - prev.size:], prev):
            return "prefix"
    return "full"


def _flatten_entries(idx: PECBIndex):
    """(node, ts, l, r, p) flat views of the per-node entry CSR."""
    node = np.repeat(np.arange(idx.num_nodes, dtype=np.int64),
                     np.diff(idx.row_ptr).astype(np.int64))
    return (node, idx.ent_ts.astype(np.int64), idx.ent_left.astype(np.int64),
            idx.ent_right.astype(np.int64), idx.ent_parent.astype(np.int64))


def _flatten_vent(idx: PECBIndex):
    """(vert, ts, node) flat views of the per-vertex entry CSR."""
    vert = np.repeat(np.arange(idx.n, dtype=np.int64),
                     np.diff(idx.vrow_ptr).astype(np.int64))
    return vert, idx.vent_ts.astype(np.int64), idx.vent_node.astype(np.int64)


class _TsGroups:
    """Slices of a record array grouped by a ts key, consumed descending.
    Slice bounds for every ts are precomputed with one vectorized
    searchsorted so the sweep's per-ts lookups are O(1)."""

    def __init__(self, ts: np.ndarray, t_hi: int):
        ts = ts.astype(np.int64)
        self.order = np.argsort(-ts, kind="stable")
        neg = -ts[self.order]                       # ascending
        qs = -np.arange(t_hi + 1, dtype=np.int64)
        self._lo = np.searchsorted(neg, qs, side="left")
        self._hi = np.searchsorted(neg, qs, side="right")

    def at(self, ts: int) -> np.ndarray:
        return self.order[self._lo[ts]:self._hi[ts]]


def _step_lookup(keys_desc: np.ndarray, vals: np.ndarray,
                 queries: np.ndarray, default: int) -> np.ndarray:
    """Step-function lookup for a descending-recorded event stream: the
    value at query q is the payload of the *last* event with key >= q
    (events hold downward); ``default`` where no event covers q."""
    if keys_desc.size == 0:
        return np.full(queries.shape[0], default, np.int64)
    j = np.searchsorted(-keys_desc, -queries, side="right") - 1
    out = vals[np.clip(j, 0, None)]
    return np.where(j >= 0, out, default)


class _UnionFind:
    """Tiny union-find over dict keys with per-component max-node tracking
    (the Def 4.9 attachment point). Node refs use the sweep's encoding."""

    __slots__ = ("parent", "cmax")

    def __init__(self):
        self.parent: dict = {}
        self.cmax: dict = {}

    def find(self, x):
        p = self.parent
        root = x
        while p.get(root, root) != root:
            root = p[root]
        while p.get(x, x) != x:
            p[x], x = root, p[x]
        return root


# ----------------------------------------------------------------------
# the grow path
# ----------------------------------------------------------------------

def extend_pecb_index(g: TemporalGraph, k: int, tab: CoreTimeTable,
                      prev: PECBIndex) -> PECBIndex:
    """Grow ``prev`` (the previous epoch's packed index) into the index for
    suffix-extended graph ``g`` with extended core-time table ``tab``.

    Bit-identical to ``build_pecb_index(g, k, tab)`` — every packed array,
    including node-id assignment (test-asserted). Raises ``ValueError``
    when ``(g, tab, prev)`` are not a consistent suffix-epoch triple, so a
    wrong index is never produced silently.
    """
    from .pecb_index import build_pecb_index   # cold fallback (cycle-safe)

    t_old, t_new = prev.t_max, g.t_max
    if prev.k != k:
        raise ValueError(f"index k={prev.k} does not match k={k}")
    if prev.n != g.n:
        raise ValueError(f"vertex count changed ({prev.n} -> {g.n}); "
                         "extend needs the same vertex set")
    if prev.m > g.m or t_old > t_new:
        raise ValueError("prev index does not describe a prefix of g")
    if tab.t_max != t_new or tab.m != g.m:
        raise ValueError("tab is not the core-time table of g")
    if prev.m and g.t[prev.m - 1] > t_old:
        raise ValueError("prev index does not match g's edge prefix")
    if g.m > prev.m and g.t[prev.m] <= t_old:
        raise ValueError(
            f"appended edges must be a timestamp suffix (> {t_old})")
    if prev.versions is None or prev.m == 0 or t_old == 0:
        return build_pecb_index(g, k, tab)    # nothing trustworthy to grow

    # -- split the table: old records verbatim, new records ct > t_old ----
    new_mask = tab.ct.astype(np.int64) > t_old
    vs = prev.versions
    old_sel = ~new_mask
    if int(old_sel.sum()) != vs.num_versions or not (
            np.array_equal(tab.edge_id[old_sel], vs.edge_id)
            and np.array_equal(tab.ts_from[old_sel], vs.ts_from)
            and np.array_equal(tab.ts_to[old_sel], vs.ts_to)
            and np.array_equal(tab.ct[old_sel], vs.ct)):
        raise ValueError(
            "old version records changed across the epoch; this is not a "
            "suffix extension of the index's graph (cold rebuild required)")

    n, n_old = g.n, prev.num_nodes
    stride = np.int64(g.m + 1)
    rec_ids = np.flatnonzero(new_mask)
    r_new = rec_ids.shape[0]
    if r_new == 0:
        # no new versions: the forest is unchanged; only metadata grows
        return PECBIndex(
            g.n, g.m, t_new, k,
            prev.node_u, prev.node_v, prev.node_ct, prev.node_edge,
            prev.node_live_from, prev.node_live_to,
            prev.row_ptr, prev.ent_ts, prev.ent_left, prev.ent_right,
            prev.ent_parent, prev.vrow_ptr, prev.vent_ts, prev.vent_node,
            versions=VersionStore.from_table(g, k, tab),
        )

    # new records, sorted by rank (ct, edge) ascending — the Kruskal order
    ne_edge = tab.edge_id[rec_ids].astype(np.int64)
    ne_ct = tab.ct[rec_ids].astype(np.int64)
    ne_from = tab.ts_from[rec_ids].astype(np.int64)
    ne_to = tab.ts_to[rec_ids].astype(np.int64)
    rorder = np.lexsort((ne_edge, ne_ct))
    ne_edge, ne_ct = ne_edge[rorder], ne_ct[rorder]
    ne_from, ne_to = ne_from[rorder], ne_to[rorder]
    ne_rank = ne_ct * stride + ne_edge
    ne_u = g.src[ne_edge].astype(np.int64)
    ne_v = g.dst[ne_edge].astype(np.int64)

    # node-ref encoding for the sweep: old node o -> o; overlay record j ->
    # n_old + j; NONE -> -1. Contraction keys additionally tag node-less
    # vertices as n_old + r_new + vertex.
    OV = n_old                    # overlay ref base
    VTAG = n_old + r_new          # vertex-tag base (UF keys only)

    # -- old-layer replay feeds -------------------------------------------
    oe_node, oe_ts, oe_l, oe_r, oe_p = _flatten_entries(prev)
    oe_groups = _TsGroups(oe_ts, t_new)
    ov_vert, ov_ts, ov_node = _flatten_vent(prev)
    ov_groups = _TsGroups(ov_ts, t_new)
    old_live_to = prev.node_live_to.astype(np.int64)
    old_live_from = prev.node_live_from.astype(np.int64)
    act_groups = _TsGroups(old_live_to, t_new)          # activate at live_to
    deact_groups = _TsGroups(old_live_from - 1, t_new)  # dead below live_from
    rec_add = _TsGroups(ne_to, t_new)                   # active at ts_to
    rec_del = _TsGroups(ne_from - 1, t_new)             # inactive below

    # -- old-layer replay state -------------------------------------------
    par = np.full(n_old, NONE, np.int64)     # current old parent per node
    alive = np.zeros(n_old, bool)
    old_vent = np.full(n, NONE, np.int64)    # current old entry node / vert
    roots = np.arange(max(n_old, 1), dtype=np.int64)  # lazily recomputed
    roots_fresh = False

    # -- overlay sweep state ----------------------------------------------
    act = np.zeros(r_new, bool)
    inf_prev = np.zeros(r_new, bool)
    l_prev = np.full(r_new, NONE, np.int64)
    r_prev = np.full(r_new, NONE, np.int64)
    p_prev = np.full(r_new, NONE, np.int64)
    ever_in = np.zeros(r_new, bool)
    live_to_rec = np.zeros(r_new, np.int64)
    live_from_rec = np.ones(r_new, np.int64)
    adopt_prev: dict = {}        # old root -> overlay j currently adopting
    ovr_arr = np.full(n, NONE, np.int64)   # vertex -> current overlay vent
    prev_ov_verts = np.zeros(0, np.int64)  # vertices with ovr_arr != NONE

    # emissions (chunked arrays, concatenated at assembly)
    em_node: list[np.ndarray] = []     # overlay entries (enc refs)
    em_ts: list[np.ndarray] = []
    em_l: list[np.ndarray] = []
    em_r: list[np.ndarray] = []
    em_p: list[np.ndarray] = []
    adopt_events: dict[int, list] = {}   # old node -> [(ts, j | NONE)] desc
    vent_events: dict[int, list] = {}    # vertex -> [(ts, ref | NONE)] desc

    scratch_cid = np.full(n, NONE, np.int64)   # vertex -> contracted key

    for ts in range(t_new, 0, -1):
        # 1. old layer at ts (activations first: a node inserted and expired
        # at the same ts nets to dead, matching the cold builder's flush)
        a_ids = act_groups.at(ts)
        d_ids = deact_groups.at(ts)
        e_ids = oe_groups.at(ts)
        v_ids = ov_groups.at(ts)
        old_changed = a_ids.size or d_ids.size or e_ids.size or v_ids.size
        if a_ids.size:
            alive[a_ids] = True
            par[a_ids] = NONE
        if e_ids.size:
            par[oe_node[e_ids]] = oe_p[e_ids]
        if d_ids.size:
            alive[d_ids] = False
        if v_ids.size:
            old_vent[ov_vert[v_ids]] = ov_node[v_ids]
        if old_changed:
            roots_fresh = False

        # 2. active new records at ts
        adds = rec_add.at(ts)
        dels = rec_del.at(ts)
        rec_changed = adds.size or dels.size
        if adds.size:
            act[adds] = True
        if dels.size:
            act[dels] = False
            gone = dels[inf_prev[dels]]
            if gone.size:
                # leaving the active window while still in the forest: the
                # cold builder's parallel lower-ct version expires it here
                live_from_rec[gone] = ts + 1
                inf_prev[gone] = False
                l_prev[gone] = r_prev[gone] = p_prev[gone] = NONE

        if not old_changed and not rec_changed:
            continue    # both layers static: snapshot provably unchanged

        ids = np.flatnonzero(act)            # rank-ascending by construction

        # 3. contraction: endpoint vertex -> old component root (or tag)
        infn = np.zeros(r_new, bool)
        ln = np.full(r_new, NONE, np.int64)
        rn = np.full(r_new, NONE, np.int64)
        pn = np.full(r_new, NONE, np.int64)
        adopt_now: dict = {}
        if ids.size:
            verts = np.unique(np.concatenate([ne_u[ids], ne_v[ids]]))
            if n_old and not roots_fresh:
                live_ids = np.flatnonzero(alive)
                p_live = par[live_ids]
                roots[live_ids] = np.where(p_live >= 0, p_live, live_ids)
                while True:
                    nxt = roots[roots[live_ids]]
                    if np.array_equal(nxt, roots[live_ids]):
                        break
                    roots[live_ids] = nxt
                roots_fresh = True
            ent = old_vent[verts]
            if n_old:
                cid = np.where(ent >= 0, roots[np.clip(ent, 0, None)],
                               VTAG + verts)
            else:
                cid = VTAG + verts
            scratch_cid[verts] = cid
            cu = scratch_cid[ne_u[ids]]
            cv = scratch_cid[ne_v[ids]]

            # 4. per-pair dedup (Kruskal rejects the higher-ranked parallel
            # record anyway; dropping it keeps the Python loop short)
            key = (np.minimum(cu, cv) * np.int64(VTAG + n + 1)
                   + np.maximum(cu, cv))
            _, first = np.unique(key, return_index=True)
            first.sort()
            kr = ids[first]
            kcu, kcv = cu[first], cv[first]

            uf = _UnionFind()
            parent = uf.parent
            cmax = uf.cmax
            for j, a0, b0 in zip(kr.tolist(), kcu.tolist(), kcv.tolist()):
                ra, rb = uf.find(a0), uf.find(b0)
                if ra == rb:
                    continue
                # component max: the old root itself for untouched old
                # comps, NONE for bare vertices, else the tracked overlay ref
                la = cmax.get(ra, ra if ra < n_old else NONE)
                lb = cmax.get(rb, rb if rb < n_old else NONE)
                infn[j] = True
                ln[j], rn[j] = la, lb
                for child in (la, lb):
                    if child == NONE:
                        continue
                    if child >= OV:
                        pn[child - OV] = OV + j
                    else:
                        adopt_now[child] = j
                parent[ra] = rb
                cmax[rb] = OV + j

        # 5. diff vs the previous ts snapshot -> emissions (vectorized)
        entered = infn & ~inf_prev
        if entered.any():
            ej = np.flatnonzero(entered)
            if ever_in[ej].any():
                raise ForestInvariantError(
                    "overlay version re-entered the forest: non-interval "
                    f"lifetime at ts={ts}")
            ever_in[ej] = True
            live_to_rec[ej] = ts
        left = inf_prev & ~infn
        if left.any():
            live_from_rec[np.flatnonzero(left)] = ts + 1
        changed = infn & (entered | (ln != l_prev) | (rn != r_prev)
                          | (pn != p_prev))
        cj = np.flatnonzero(changed)
        if cj.size:
            em_node.append(OV + cj)
            em_ts.append(np.full(cj.size, ts, np.int64))
            em_l.append(ln[cj].copy())
            em_r.append(rn[cj].copy())
            em_p.append(pn[cj].copy())
        inf_prev, l_prev, r_prev, p_prev = infn, ln, rn, pn

        # 6. adoption diff (old roots whose merged parent is an overlay ref)
        if adopt_now != adopt_prev:
            for o, j in adopt_now.items():
                if adopt_prev.get(o) != j:
                    adopt_events.setdefault(o, []).append((ts, j))
            for o in adopt_prev:
                if o not in adopt_now:
                    adopt_events.setdefault(o, []).append((ts, NONE))
            adopt_prev = adopt_now

        # 7. vertex entry-point overrides: lowest-rank in-forest overlay
        # node per endpoint vertex (relevant only where the old layer has
        # no entry; the merge is resolved at assembly time)
        fj = np.flatnonzero(infn)
        if fj.size:
            v_all = np.concatenate([ne_u[fj], ne_v[fj]])
            j_all = np.concatenate([fj, fj])
            vord = np.lexsort((j_all, v_all))
            v_s, j_s = v_all[vord], j_all[vord]
            vfirst = np.ones(v_s.size, bool)
            vfirst[1:] = v_s[1:] != v_s[:-1]
            cur_verts = v_s[vfirst]
            cur_vals = OV + j_s[vfirst]
        else:
            cur_verts = np.zeros(0, np.int64)
            cur_vals = np.zeros(0, np.int64)
        union_verts = np.union1d(cur_verts, prev_ov_verts)
        if union_verts.size:
            new_vals = np.full(union_verts.size, NONE, np.int64)
            if cur_verts.size:
                pos = np.searchsorted(union_verts, cur_verts)
                new_vals[pos] = cur_vals
            delta = new_vals != ovr_arr[union_verts]
            if delta.any():
                for vtx, val in zip(union_verts[delta].tolist(),
                                    new_vals[delta].tolist()):
                    vent_events.setdefault(vtx, []).append((ts, val))
                ovr_arr[union_verts] = new_vals
            prev_ov_verts = cur_verts

    # ------------------------------------------------------------------
    # assembly
    # ------------------------------------------------------------------
    js = np.flatnonzero(ever_in)
    n_ov = js.shape[0]
    total = n_old + n_ov

    # cold insertion order: (live_to descending, rank ascending)
    old_rank = (prev.node_ct.astype(np.int64) * stride
                + prev.node_edge.astype(np.int64))
    all_live_to = np.concatenate([old_live_to, live_to_rec[js]])
    all_rank = np.concatenate([old_rank, ne_rank[js]])
    order = np.lexsort((all_rank, -all_live_to))
    newid = np.empty(total, np.int64)
    newid[order] = np.arange(total, dtype=np.int64)
    map_old = newid[:n_old]
    map_rec = np.full(r_new, NONE, np.int64)
    map_rec[js] = newid[n_old:]

    def remap_refs(refs: np.ndarray) -> np.ndarray:
        """Sweep-encoded refs -> final node ids (NONE passthrough)."""
        refs = np.asarray(refs, np.int64)
        out = np.full(refs.shape, NONE, np.int64)
        m_o = (0 <= refs) & (refs < OV)
        out[m_o] = map_old[refs[m_o]]
        m_v = refs >= OV
        out[m_v] = map_rec[refs[m_v] - OV]
        if (out[m_v] == NONE).any():
            raise ForestInvariantError("entry references a rejected version")
        return out

    # node table
    node_u = np.empty(total, np.int64)
    node_v = np.empty(total, np.int64)
    node_ct = np.empty(total, np.int64)
    node_edge = np.empty(total, np.int64)
    node_lf = np.empty(total, np.int64)
    node_lt = np.empty(total, np.int64)
    node_u[map_old] = prev.node_u
    node_v[map_old] = prev.node_v
    node_ct[map_old] = prev.node_ct
    node_edge[map_old] = prev.node_edge
    node_lf[map_old] = old_live_from
    node_lt[map_old] = old_live_to
    mj = map_rec[js]
    node_u[mj] = ne_u[js]
    node_v[mj] = ne_v[js]
    node_ct[mj] = ne_ct[js]
    node_edge[mj] = ne_edge[js]
    node_lf[mj] = live_from_rec[js]
    node_lt[mj] = live_to_rec[js]

    # entries: verbatim old (never-adopted) + rebuilt adopted + overlay
    adopted = np.fromiter(adopt_events.keys(), np.int64,
                          count=len(adopt_events))
    keep = (~np.isin(oe_node, adopted)) if adopted.size else np.ones(
        oe_node.shape[0], bool)
    fe_node = [map_old[oe_node[keep]]]
    fe_ts = [oe_ts[keep]]
    fe_l = [remap_refs(oe_l[keep])]
    fe_r = [remap_refs(oe_r[keep])]
    fe_p = [remap_refs(oe_p[keep])]

    for o, events in adopt_events.items():
        # merge the node's old entry stream with its adoption override
        # intervals; re-delta-compress exactly as the cold builder would
        lo_, hi_ = int(prev.row_ptr[o]), int(prev.row_ptr[o + 1])
        e_ts = prev.ent_ts[lo_:hi_].astype(np.int64)      # ascending
        ev_ts = np.asarray([t for (t, _) in events], np.int64)   # descending
        ev_ref = np.asarray([r for (_, r) in events], np.int64)
        lt_o, lf_o = int(old_live_to[o]), int(old_live_from[o])
        cands = np.unique(np.concatenate([e_ts, ev_ts]))[::-1]
        cands = cands[(cands >= lf_o) & (cands <= lt_o)]
        pos = np.searchsorted(e_ts, cands, side="left")
        if (pos >= e_ts.shape[0]).any():
            raise ForestInvariantError(
                f"adopted node {o} lacks an old entry covering a change")
        l0 = prev.ent_left[lo_:hi_].astype(np.int64)[pos]
        r0 = prev.ent_right[lo_:hi_].astype(np.int64)[pos]
        p0 = prev.ent_parent[lo_:hi_].astype(np.int64)[pos]
        ov = _step_lookup(ev_ts, ev_ref, cands, NONE)
        p1 = np.where(ov != NONE, OV + ov, p0)
        chg = np.ones(cands.size, bool)
        chg[1:] = ((l0[1:] != l0[:-1]) | (r0[1:] != r0[:-1])
                   | (p1[1:] != p1[:-1]))
        if chg.any():
            ci = np.flatnonzero(chg)
            fe_node.append(np.full(ci.size, map_old[o], np.int64))
            fe_ts.append(cands[ci])
            fe_l.append(remap_refs(l0[ci]))
            fe_r.append(remap_refs(r0[ci]))
            fe_p.append(remap_refs(p1[ci]))

    if em_node:
        fe_node.append(remap_refs(np.concatenate(em_node)))
        fe_ts.append(np.concatenate(em_ts))
        fe_l.append(remap_refs(np.concatenate(em_l)))
        fe_r.append(remap_refs(np.concatenate(em_r)))
        fe_p.append(remap_refs(np.concatenate(em_p)))

    ent_node = np.concatenate(fe_node)
    ent_ts_f = np.concatenate(fe_ts)
    ent_l_f = np.concatenate(fe_l)
    ent_r_f = np.concatenate(fe_r)
    ent_p_f = np.concatenate(fe_p)

    # vertex entries: verbatim for unaffected vertices + rebuilt merges
    affected = np.fromiter(vent_events.keys(), np.int64,
                           count=len(vent_events))
    vkeep = (~np.isin(ov_vert, affected)) if affected.size else np.ones(
        ov_vert.shape[0], bool)
    fv_vert = [ov_vert[vkeep]]
    fv_ts = [ov_ts[vkeep]]
    fv_node = [remap_refs(ov_node[vkeep])]

    for vtx, events in vent_events.items():
        lo_, hi_ = int(prev.vrow_ptr[vtx]), int(prev.vrow_ptr[vtx + 1])
        o_ts = prev.vent_ts[lo_:hi_].astype(np.int64)     # ascending
        o_nd = prev.vent_node[lo_:hi_].astype(np.int64)
        ev_ts = np.asarray([t for (t, _) in events], np.int64)   # descending
        ev_ref = np.asarray([r for (_, r) in events], np.int64)
        cands = np.unique(np.concatenate([o_ts, ev_ts]))[::-1]
        pos = np.searchsorted(o_ts, cands, side="left")
        base = np.where(pos < o_ts.shape[0],
                        o_nd[np.clip(pos, 0, max(o_ts.shape[0] - 1, 0))]
                        if o_ts.size else NONE, NONE)
        ov = _step_lookup(ev_ts, ev_ref, cands, NONE)
        val = np.where(base != NONE, base, ov)
        chg = np.ones(cands.size, bool)
        chg[1:] = val[1:] != val[:-1]
        ci = np.flatnonzero(chg)
        if ci.size:
            fv_vert.append(np.full(ci.size, vtx, np.int64))
            fv_ts.append(cands[ci])
            fv_node.append(remap_refs(val[ci]))

    vent_vert = np.concatenate(fv_vert)
    vent_ts_f = np.concatenate(fv_ts)
    vent_node_f = np.concatenate(fv_node)

    # pack: identical CSR layout to pack_index
    row_ptr, ent_ts_c, (ent_l_c, ent_r_c, ent_p_c) = _csr_sorted(
        ent_node, ent_ts_f, (ent_l_f, ent_r_f, ent_p_f), total)
    vrow_ptr, vent_ts_c, (vent_node_c,) = _csr_sorted(
        vent_vert, vent_ts_f, (vent_node_f,), n)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return PECBIndex(
        g.n, g.m, t_new, k,
        i32(node_u), i32(node_v), i32(node_ct), i32(node_edge),
        i32(node_lf), i32(node_lt),
        row_ptr, ent_ts_c, ent_l_c, ent_r_c, ent_p_c,
        vrow_ptr, vent_ts_c, vent_node_c,
        versions=VersionStore.from_table(g, k, tab),
    )


# ----------------------------------------------------------------------
# the shrink path (retention plane)
# ----------------------------------------------------------------------

def shrink_pecb_index(g: TemporalGraph, k: int, tab: CoreTimeTable,
                      prev: PECBIndex) -> PECBIndex:
    """Shrink ``prev`` (the pre-expiry epoch's packed index) into the index
    for the prefix-expired, shifted graph ``g`` with shrunk core-time table
    ``tab`` (``core_time.shrink_core_times``).

    Bit-identical to ``build_pecb_index(g, k, tab)`` — every packed array,
    including node-id assignment (test-asserted) — at pure-slicing cost.
    Where the grow path must *replay* the old layer and overlay new
    Kruskal work, the shrink path needs neither: by the cut invariant
    (no surviving window contains an expired edge) the ECB forest at every
    surviving start time ``ts >= t_cut`` is **literally the old forest**
    at that ts, so the new index is the old one restricted to the
    surviving time range and relabeled:

    * **Nodes** survive iff their forest lifetime reaches the cut
      (``live_to >= t_cut``); ``live_from`` clips to the cut. Node ids
      compact in order: the cold insertion order is ``(live_to desc,
      rank asc)`` (the PR-4 invariant) and both keys shift uniformly
      (``live_to - shift``; rank ``(ct - shift, edge - cut)``), so stable
      compaction of the surviving old ids *is* the cold id assignment.
    * **Entries** survive iff recorded at ``ts >= t_cut``. Recording
      points above the cut are unchanged (same state changes at the same
      sweep steps), and the entry covering the new ``ts = 1`` is exactly
      the old entry covering ``t_cut`` (the step function holds
      downward), so a ts-filter reproduces the cold build's delta
      compression verbatim. Every reference inside a kept entry points at
      a node in the forest at the recording ts ``>= t_cut`` — a survivor
      — so remapping is total (a miss raises ``ForestInvariantError``).
    * **Per-vertex entry points** filter and remap the same way.

    Raises ``ValueError`` when ``(g, tab, prev)`` is not a consistent
    prefix-expiry triple, so a wrong index is never produced silently.
    """
    from .pecb_index import build_pecb_index   # cold fallback (cycle-safe)

    shift = prev.t_max - g.t_max
    cut_m = prev.m - g.m
    t_cut = shift + 1
    if prev.k != k:
        raise ValueError(f"index k={prev.k} does not match k={k}")
    if prev.n != g.n:
        raise ValueError(f"vertex count changed ({prev.n} -> {g.n}); "
                         "shrink needs the same vertex set")
    if shift < 0 or cut_m < 0:
        raise ValueError("prev index does not describe a supergraph of g "
                         "(shrink goes forward in time; use "
                         "extend_pecb_index to grow)")
    if tab.t_max != g.t_max or tab.m != g.m or tab.n != g.n:
        raise ValueError("tab is not the core-time table of g; pass "
                         "tab=shrink_core_times(g, k, prev_tab)")
    if shift == 0 and cut_m == 0:
        return prev                       # no cut: same epoch
    if prev.versions is None or g.m == 0 or g.t_max == 0:
        return build_pecb_index(g, k, tab)   # nothing trustworthy to slice

    # -- integrity: prev's surviving records, clipped+shifted, must be tab
    vs = prev.versions
    vkeep = vs.ts_to.astype(np.int64) >= t_cut
    if not (int(vkeep.sum()) == tab.num_versions
            and np.array_equal(vs.edge_id[vkeep].astype(np.int64) - cut_m,
                               tab.edge_id)
            and np.array_equal(
                np.maximum(vs.ts_from[vkeep].astype(np.int64), t_cut) - shift,
                tab.ts_from)
            and np.array_equal(vs.ts_to[vkeep].astype(np.int64) - shift,
                               tab.ts_to)
            and np.array_equal(vs.ct[vkeep].astype(np.int64) - shift,
                               tab.ct)):
        raise ValueError(
            "surviving version records of prev do not clip to tab; this is "
            "not a prefix expiry of the index's graph (cold rebuild "
            "required)")

    # -- node survival + id compaction (order-preserving) -----------------
    old_lt = prev.node_live_to.astype(np.int64)
    nkeep = old_lt >= t_cut
    newid = np.cumsum(nkeep, dtype=np.int64) - 1      # valid where nkeep
    total = int(nkeep.sum())

    def remap_refs(refs: np.ndarray) -> np.ndarray:
        """Old node refs -> compacted ids (NONE passthrough); referencing a
        dead node means the index was not a consistent epoch snapshot."""
        refs = np.asarray(refs, np.int64)
        live = refs >= 0
        if live.any() and not nkeep[refs[live]].all():
            raise ForestInvariantError(
                "a surviving entry references an expired forest node")
        out = np.full(refs.shape, NONE, np.int64)
        out[live] = newid[refs[live]]
        return out

    node_edge = prev.node_edge[nkeep].astype(np.int64) - cut_m
    if node_edge.size and node_edge.min() < 0:
        raise ValueError(
            "a surviving forest node references an expired edge; prev is "
            "not the index of g's pre-expiry epoch")

    # -- entries: ts-filter on surviving nodes, shift, remap --------------
    oe_node, oe_ts, oe_l, oe_r, oe_p = _flatten_entries(prev)
    ekeep = nkeep[oe_node] & (oe_ts >= t_cut)
    ov_vert, ov_ts, ov_node = _flatten_vent(prev)
    vent_keep = ov_ts >= t_cut

    row_ptr, ent_ts_c, (ent_l_c, ent_r_c, ent_p_c) = _csr_sorted(
        newid[oe_node[ekeep]], oe_ts[ekeep] - shift,
        (remap_refs(oe_l[ekeep]), remap_refs(oe_r[ekeep]),
         remap_refs(oe_p[ekeep])), total)
    vrow_ptr, vent_ts_c, (vent_node_c,) = _csr_sorted(
        ov_vert[vent_keep], ov_ts[vent_keep] - shift,
        (remap_refs(ov_node[vent_keep]),), g.n)

    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return PECBIndex(
        g.n, g.m, g.t_max, k,
        i32(prev.node_u[nkeep]), i32(prev.node_v[nkeep]),
        i32(prev.node_ct[nkeep].astype(np.int64) - shift), i32(node_edge),
        i32(np.maximum(prev.node_live_from[nkeep].astype(np.int64), t_cut)
            - shift),
        i32(old_lt[nkeep] - shift),
        row_ptr, ent_ts_c, ent_l_c, ent_r_c, ent_p_c,
        vrow_ptr, vent_ts_c, vent_node_c,
        versions=VersionStore.from_table(g, k, tab),
    )


# ----------------------------------------------------------------------
# stratified epoch lifecycle: one call covers every k
# ----------------------------------------------------------------------

def extend_stratified_index(g: TemporalGraph, prev: StratifiedPECB,
                            ks=None, *, strata=None, engine: str = "auto",
                            device="cuda") -> StratifiedPECB:
    """Grow a whole k-stratified index across one suffix-append epoch.

    Each existing stratum grows through :func:`extend_pecb_index`
    (bit-identical incremental); strata the new epoch adds (``ks``
    defaults to ``default_ks(g)``, and appended edges can raise the
    graph's degeneracy) are built cold through the fastest forest
    engine. One call replaces |K| per-k lifecycle operations. Pass
    ``strata`` to reuse an already-extended table (a caller that times
    the core and forest stages separately); otherwise the table is
    extended on ``device`` by ``engine``. The default ``ks`` and
    ``k_max_graph`` are peeled on the build's device
    (:func:`core_time.kcore_device`).
    """
    from .kcore import k_max as _graph_k_max
    from .pecb_index import build_stratified_index

    if prev.strata is None:
        return build_stratified_index(g, ks, strata=strata, engine=engine,
                                      device=device)
    kdev = kcore_device(engine, device)
    if ks is None:
        ks = default_ks(g, kdev)
    stab = (strata if strata is not None
            else extend_stratified_core_times(g, prev.strata, ks,
                                              engine=engine, device=device))
    indices = []
    for k in stab.ks:
        tab = stab.table_for(int(k))
        if k in prev.supported_ks:
            indices.append(extend_pecb_index(g, int(k), tab,
                                             prev.slice_k(k)))
        else:
            indices.append(pack_index(g, int(k), _forest_builder(g, tab)))
    return _assemble_stratified(g, stab, indices, _graph_k_max(g, kdev))


def shrink_stratified_index(g: TemporalGraph, prev: StratifiedPECB,
                            ks=None, *, strata=None, engine: str = "auto",
                            device="cuda") -> StratifiedPECB:
    """Shrink a whole k-stratified index across one prefix-expiry epoch
    (pure slicing per stratum, :func:`shrink_pecb_index`). ``ks``
    defaults to ``default_ks(g)`` — expiry can lower the degeneracy, in
    which case the dropped strata simply disappear (queries above the
    new ``k_max_graph`` stay exactly empty). ``engine``/``device`` serve
    the cold build of an index that carries no table, and pick where the
    default ``ks`` and ``k_max_graph`` are peeled
    (:func:`core_time.kcore_device`)."""
    from .kcore import k_max as _graph_k_max
    from .pecb_index import build_stratified_index

    if prev.strata is None:
        return build_stratified_index(g, ks, strata=strata, engine=engine,
                                      device=device)
    kdev = kcore_device(engine, device)
    if ks is None:
        ks = default_ks(g, kdev)
    stab = (strata if strata is not None
            else shrink_stratified_core_times(g, prev.strata, ks))
    indices = [shrink_pecb_index(g, int(k), stab.table_for(int(k)),
                                 prev.slice_k(k))
               for k in stab.ks]
    return _assemble_stratified(g, stab, indices, _graph_k_max(g, kdev))
