"""EF-Index — behaviourally-faithful reimplementation of the SOTA baseline
(Yang et al. [32], paper §3.1), per DESIGN.md §5.

The original EF-Index (a full paper on its own) enumerates every distinct
temporal k-core over all windows with OTCD (cost ``O(t_max^2 · V_k)``),
organizes them into a lineage graph, covers the lineages with chains
(Hopcroft–Karp), and stores one Minimum Temporal Spanning Forest per chain.
Queries look up the TTI chain and run a label-constrained DFS.

This reimplementation preserves the *complexity profile* the paper measures
against, with documented simplifications that are neutral or favour EF:

* **OTCD-style enumeration** — for every start time, every core changepoint
  (distinct edge core-time) materialises the grown core; each (window ×
  member-edge) pair is touched, reproducing the quadratic build cost. Cores
  are deduplicated across start times by (count, 64-bit mix-hash) instead of
  full edge-set keys — same dedup effect, less build RAM (favours EF).
* **Chains** — for a fixed start time the cores for growing ``te`` form a
  containment chain (the natural lineage); consecutive start times with an
  identical chain share one stored forest (the chain-cover effect). Each
  stored chain keeps a *full* MTSF with per-edge validity labels — the
  per-chain storage redundancy the paper's Figure 4 measures.
* **Lookup** — window -> chain resolution is a direct array index (O(1),
  faster than the paper's ``O(d·log p_max)`` — favours EF query time).
* Queries are exact (tested against the brute-force oracle).

PyTorch port of ``repro.core.ef_index`` (host code, copied so the port
stands alone): the enumeration, the chain cover and the DFS are the
reference's, so every count and array equals its own. Without ``tab`` the
core-time table is built by the port's ``edge_core_times`` on ``device``
(the card by default).
"""

from __future__ import annotations

import warnings

import numpy as np

from .core_time import CoreTimeTable, edge_core_times
from .ctmsf import kruskal_msf
from .ecb_forest import active_versions
from .query_api import ComponentBackend, VersionStore
from .temporal_graph import TemporalGraph


def _mix(h: int, x: int) -> int:
    # splitmix64-style mix; order-independent combination via addition
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return (h + (x ^ (x >> 31))) & 0xFFFFFFFFFFFFFFFF


class _ChainForest:
    """One stored MTSF: CSR adjacency over graph vertices with ct labels."""

    __slots__ = ("vptr", "adj_node", "node_u", "node_v", "node_ct", "nbytes")

    def __init__(self, n: int, u: np.ndarray, v: np.ndarray, ct: np.ndarray):
        deg = np.bincount(u, minlength=n) + np.bincount(v, minlength=n)
        self.vptr = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=self.vptr[1:])
        pos = self.vptr[:-1].copy()
        nn = u.shape[0]
        self.adj_node = np.zeros(2 * nn, np.int32)
        for i in range(nn):
            a, b = int(u[i]), int(v[i])
            self.adj_node[pos[a]] = i
            pos[a] += 1
            self.adj_node[pos[b]] = i
            pos[b] += 1
        self.node_u = u.astype(np.int32)
        self.node_v = v.astype(np.int32)
        self.node_ct = ct.astype(np.int32)
        self.nbytes = (self.vptr.nbytes + self.adj_node.nbytes +
                       self.node_u.nbytes + self.node_v.nbytes + self.node_ct.nbytes)


class EFIndex(ComponentBackend):
    backend_name = "ef"

    def __init__(self, g: TemporalGraph, k: int,
                 tab: CoreTimeTable | None = None, *, device="cuda"):
        self.g = g
        self.k = k
        tab = tab if tab is not None else edge_core_times(g, k, device=device)
        self.versions = VersionStore.from_table(g, k, tab)  # v2 surface
        t_max = g.t_max
        self.t_max = t_max

        # ---- OTCD-style enumeration + lineage chains --------------------
        core_ids: dict[tuple, int] = {}     # (size, hash) -> core id
        self.num_distinct_cores = 0
        self.enumerated_core_edges = 0      # Σ |core| over all windows (cost meter)
        chain_sigs: list[tuple] = []        # per ts: tuple of core ids (the chain)
        forests: list[_ChainForest] = []
        self.ts_to_forest = np.zeros(t_max + 2, np.int64)

        prev_sig = None
        for ts in range(1, t_max + 1):
            e_ids, cts = active_versions(tab, ts)   # ascending (ct, edge)
            # changepoints of te: distinct core times
            sig = []
            h, cnt = 0, 0
            j = 0
            nn = e_ids.shape[0]
            while j < nn:
                c = cts[j]
                while j < nn and cts[j] == c:
                    h = _mix(h, int(e_ids[j]))
                    cnt += 1
                    j += 1
                # the temporal k-core of [ts, c]: every member edge touched
                self.enumerated_core_edges += cnt
                key = (cnt, h)
                if key not in core_ids:
                    core_ids[key] = len(core_ids)
                sig.append(core_ids[key])
            sig = tuple(sig)
            if prev_sig is not None and sig == prev_sig:
                # identical chain: share the previous forest (chain cover)
                self.ts_to_forest[ts] = self.ts_to_forest[ts - 1]
            else:
                u = g.src[e_ids].astype(np.int64)
                v = g.dst[e_ids].astype(np.int64)
                keep = kruskal_msf(u, v, cts.astype(np.int64), g.n)
                forests.append(_ChainForest(g.n, u[keep], v[keep], cts[keep]))
                self.ts_to_forest[ts] = len(forests) - 1
            prev_sig = sig
        self.num_distinct_cores = len(core_ids)
        self.forests = forests

    def nbytes(self) -> int:
        return int(self.ts_to_forest.nbytes + sum(f.nbytes for f in self.forests))

    # -- label-constrained DFS over the chain's MTSF ----------------------
    def query(self, u: int, ts: int, te: int) -> set[int]:
        """Deprecated positional shim; prefer ``answer(TCCSQuery(...))``.
        Emits :class:`DeprecationWarning`."""
        warnings.warn(
            "EFIndex.query(u, ts, te) is deprecated; use "
            "answer(TCCSQuery(u, ts, te, k))",
            DeprecationWarning, stacklevel=2)
        return self._component_vertices(u, ts, te)

    def _component_vertices(self, u: int, ts: int, te: int) -> set[int]:
        if not (1 <= ts <= self.t_max):
            return set()
        f = self.forests[int(self.ts_to_forest[ts])]
        lo, hi = int(f.vptr[u]), int(f.vptr[u + 1])
        if not any(f.node_ct[f.adj_node[i]] <= te for i in range(lo, hi)):
            return set()
        seen: set[int] = set()
        stack = [u]
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            for i in range(int(f.vptr[x]), int(f.vptr[x + 1])):
                node = int(f.adj_node[i])
                if f.node_ct[node] > te:
                    continue
                y = int(f.node_u[node]) if int(f.node_v[node]) == x else int(f.node_v[node])
                if y not in seen:
                    stack.append(y)
        return seen
