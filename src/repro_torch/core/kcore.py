"""K-core computation: numpy peeling oracle + window/TCCS brute force.

These are the ground-truth routines every index in the repo is tested
against. They are deliberately simple; the fast paths live in
``core_time.py`` (host build plane) and ``batch_query.py`` / ``kernels``
(device query plane).

PyTorch port of ``repro.core.kcore``, copied so the port's tests and
builds stand alone; :func:`distinct_pairs` is the port's own, shared by
the distinct k-core and the card's peel.
"""

from __future__ import annotations

import numpy as np

from .temporal_graph import TemporalGraph


def kcore_edge_mask(src: np.ndarray, dst: np.ndarray, n: int, k: int,
                    active: np.ndarray | None = None) -> np.ndarray:
    """Boolean mask over edges that survive in the k-core of the (multi)graph.

    Iterative peeling as a fixpoint: drop every edge incident to a vertex of
    degree < k; repeat. Matches Definition 2.2 (connectivity ignored).
    Parallel edges each count toward degree (consistent with projecting a
    temporal multigraph, as in the paper's Figure 1 examples).
    """
    m = src.shape[0]
    alive = np.ones(m, bool) if active is None else active.copy()
    while True:
        deg = np.bincount(src[alive], minlength=n) + np.bincount(dst[alive], minlength=n)
        vk = deg >= k
        new_alive = alive & vk[src] & vk[dst]
        if new_alive.sum() == alive.sum():
            return new_alive
        alive = new_alive


def distinct_kcore_edge_mask(src: np.ndarray, dst: np.ndarray, n: int, k: int) -> np.ndarray:
    """Like :func:`kcore_edge_mask` but with the paper's semantics: degree =
    number of *distinct* neighbours ("at least k neighbors", Def 2.1/2.2).
    Parallel temporal edges are collapsed for peeling and the surviving mask
    is broadcast back to every parallel copy."""
    if src.size == 0:
        return np.zeros(0, bool)
    us, ud, inv = distinct_pairs(src, dst, n)
    return kcore_edge_mask(us, ud, n, k)[inv]


def distinct_pairs(src: np.ndarray, dst: np.ndarray, n: int):
    """The distinct undirected pairs (min, max) of the edges, sorted, as
    int64 arrays ``us``, ``ud``, and the index of each edge's pair:
    ``(us, ud, inv)``."""
    key = np.minimum(src, dst).astype(np.int64) * n + np.maximum(src, dst)
    uniq, inv = np.unique(key, return_inverse=True)
    return uniq // n, uniq % n, inv


def temporal_kcore_edges(g: TemporalGraph, k: int, ts: int, te: int) -> np.ndarray:
    """Edge ids (into g) of the temporal k-core of window [ts, te]."""
    s, d, ids = g.project(ts, te)
    alive = distinct_kcore_edge_mask(s, d, g.n, k)
    return ids[alive]


def connected_component(src: np.ndarray, dst: np.ndarray, n: int, u: int) -> np.ndarray:
    """Vertices reachable from u over the given edges (u included iff it has
    an incident edge or stands alone)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(src.tolist(), dst.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    ru = find(u)
    roots = np.fromiter((find(i) for i in range(n)), dtype=np.int64, count=n)
    return np.nonzero(roots == ru)[0]


def tccs_oracle(g: TemporalGraph, k: int, u: int, ts: int, te: int) -> set[int]:
    """Brute-force TCCS: the k-core component of u in G_[ts,te].

    Returns the empty set when u is not in the temporal k-core (the paper's
    query semantics: the component containing u, which does not exist then).
    """
    ids = temporal_kcore_edges(g, k, ts, te)
    if ids.size == 0:
        return set()
    s, d = g.src[ids], g.dst[ids]
    touched = np.zeros(g.n, bool)
    touched[s] = True
    touched[d] = True
    if not touched[u]:
        return set()
    comp = connected_component(s, d, g.n, u)
    return set(int(v) for v in comp if touched[v])


def tccs_oracle_edges(g: TemporalGraph, k: int, u: int, ts: int, te: int) -> set[int]:
    """Brute-force member edges of u's k-core component in G_[ts,te]:
    edge ids (into g) of the temporal k-core edges with an endpoint in the
    component (components partition core edges, so one endpoint in implies
    both). Ground truth for the v2 EDGES/SUBGRAPH result modes."""
    ids = temporal_kcore_edges(g, k, ts, te)
    if ids.size == 0:
        return set()
    s, d = g.src[ids], g.dst[ids]
    touched = np.zeros(g.n, bool)
    touched[s] = True
    touched[d] = True
    if not touched[u]:
        return set()
    comp = connected_component(s, d, g.n, u)
    in_comp = np.zeros(g.n, bool)
    in_comp[comp] = True
    return set(int(e) for e in ids[in_comp[s]])


def k_max(g: TemporalGraph) -> int:
    """Largest k with a non-empty k-core of the full window (paper Table 3)."""
    s, d = g.src, g.dst
    lo, hi = 1, 1
    while distinct_kcore_edge_mask(s, d, g.n, hi).any():
        lo, hi = hi, hi * 2
    # binary search in (lo, hi]
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if distinct_kcore_edge_mask(s, d, g.n, mid).any():
            lo = mid
        else:
            hi = mid
    return lo
