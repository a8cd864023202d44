"""K-core computation: numpy peeling oracle + window/TCCS brute force.

These are the ground-truth routines every index in the repo is tested
against. They are deliberately simple; the fast paths live in
``core_time.py`` (host build plane) and ``batch_query.py`` / ``kernels``
(device query plane).

PyTorch port of ``repro.core.kcore``, copied so the port's tests and
builds stand alone; :func:`distinct_pairs` is the port's own, shared by
the distinct k-core and the card's peel.

The distinct k-core routines (:func:`distinct_kcore_edge_mask`,
:func:`temporal_kcore_edges`, :func:`k_max`, :func:`tccs_oracle`,
:func:`tccs_oracle_edges`) take ``device``: ``None`` (the default) peels
in numpy, the reference's ground truth; a torch device uploads the
distinct pairs once as int32 and peels them through
``ops.kcore_fixpoint`` (on CUDA one fixpoint launch per peel, on the CPU
its plain version). Both give the same masks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
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


def distinct_kcore_edge_mask(src: np.ndarray, dst: np.ndarray, n: int, k: int,
                             device=None) -> np.ndarray:
    """Like :func:`kcore_edge_mask` but with the paper's semantics: degree =
    number of *distinct* neighbours ("at least k neighbors", Def 2.1/2.2).
    Parallel temporal edges are collapsed for peeling and the surviving mask
    is broadcast back to every parallel copy. ``device``: see the module
    docstring."""
    if src.size == 0:
        return np.zeros(0, bool)
    us, ud, inv = distinct_pairs(src, dst, n)
    if device is None:
        return kcore_edge_mask(us, ud, n, k)[inv]
    return ops.kcore_fixpoint(*_upload(us, ud, device), n,
                              k).cpu().numpy()[inv]


def distinct_pairs(src: np.ndarray, dst: np.ndarray, n: int):
    """The distinct undirected pairs (min, max) of the edges, sorted, as
    int64 arrays ``us``, ``ud``, and the index of each edge's pair:
    ``(us, ud, inv)``."""
    key = np.minimum(src, dst).astype(np.int64) * n + np.maximum(src, dst)
    uniq, inv = np.unique(key, return_inverse=True)
    return uniq // n, uniq % n, inv


def _upload(us: np.ndarray, ud: np.ndarray, device):
    """The distinct pairs as int32 tensors on ``device``, the operands of
    the peel fixpoint."""
    return (torch.as_tensor(us.astype(np.int32), device=device),
            torch.as_tensor(ud.astype(np.int32), device=device))


def temporal_kcore_edges(g: TemporalGraph, k: int, ts: int, te: int,
                         device=None) -> np.ndarray:
    """Edge ids (into g) of the temporal k-core of window [ts, te]."""
    s, d, ids = g.project(ts, te)
    alive = distinct_kcore_edge_mask(s, d, g.n, k, device)
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


def tccs_oracle(g: TemporalGraph, k: int, u: int, ts: int, te: int,
                device=None) -> set[int]:
    """Brute-force TCCS: the k-core component of u in G_[ts,te].

    Returns the empty set when u is not in the temporal k-core (the paper's
    query semantics: the component containing u, which does not exist then).
    """
    ids = temporal_kcore_edges(g, k, ts, te, device)
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


def tccs_oracle_edges(g: TemporalGraph, k: int, u: int, ts: int, te: int,
                      device=None) -> set[int]:
    """Brute-force member edges of u's k-core component in G_[ts,te]:
    edge ids (into g) of the temporal k-core edges with an endpoint in the
    component (components partition core edges, so one endpoint in implies
    both). Ground truth for the v2 EDGES/SUBGRAPH result modes."""
    ids = temporal_kcore_edges(g, k, ts, te, device)
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


def k_max(g: TemporalGraph, device=None) -> int:
    """Largest k with a non-empty k-core of the full window (paper Table 3).
    On a torch ``device`` the distinct pairs are uploaded once and every
    probe of the doubling and the bisection is one fixpoint and one
    ``.any()`` read."""
    s, d = g.src, g.dst
    if device is None or s.size == 0:
        def nonempty(k: int) -> bool:
            return bool(distinct_kcore_edge_mask(s, d, g.n, k).any())
    else:
        us, ud, _ = distinct_pairs(s, d, g.n)
        ps, pd = _upload(us, ud, device)

        def nonempty(k: int) -> bool:
            return bool(ops.kcore_fixpoint(ps, pd, g.n, k).any())
    lo, hi = 1, 1
    while nonempty(hi):
        lo, hi = hi, hi * 2
    # binary search in (lo, hi]
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if nonempty(mid):
            lo = mid
        else:
            hi = mid
    return lo
