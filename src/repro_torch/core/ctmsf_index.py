"""CTMSF-Index — the paper's vertex-centric baseline (§6).

Materialises the CT-MSF directly: each graph vertex stores the list of its
incident MSF edges, and writes a *new full list* whenever the list differs
from the previous start time. Vertex degree in a CT-MSF is unbounded, which
is exactly the redundancy the ECB forest removes — high-degree vertices
re-write long lists on every change. Index size accounting (``nbytes``)
charges every stored list in full, as the paper's Figure 4 does.

The MSF evolution itself is shared with the PECB builder (identical MSFs by
rank uniqueness), so construction cost is near-identical — matching the
paper's observation that the two build times coincide (§6.2).

PyTorch port of ``repro.core.ctmsf_index`` (host code, copied so the port
stands alone): the builder taps the port's ``IncrementalBuilder``, whose
``flush`` clears ``_dirty_verts`` after the tap as the reference's does.
Without ``tab`` the core-time table is built by the port's
``edge_core_times`` on ``device`` (the card by default).
"""

from __future__ import annotations

import bisect
import warnings

import numpy as np

from .core_time import CoreTimeTable, edge_core_times
from .ecb_forest import IncrementalBuilder
from .query_api import ComponentBackend, VersionStore
from .temporal_graph import TemporalGraph


class _VertexCentricBuilder(IncrementalBuilder):
    """Taps the shared MSF maintenance to snapshot per-vertex lists."""

    def __init__(self, g, tab):
        super().__init__(g, tab)
        # per-vertex list of (ts, tuple_of_node_ids) in build (desc-ts) order
        self.vlists: list[list[tuple]] = [[] for _ in range(g.n)]

    def flush(self, ts: int):
        for vert in self._dirty_verts:
            cur = tuple(self._inc_node[vert])
            ent = self.vlists[vert]
            if not ent or ent[-1][1] != cur:
                ent.append((ts, cur))
        super().flush(ts)


class CTMSFIndex(ComponentBackend):
    backend_name = "ctmsf"

    def __init__(self, g: TemporalGraph, k: int,
                 tab: CoreTimeTable | None = None, *, device="cuda"):
        self.g = g
        self.k = k
        tab = tab if tab is not None else edge_core_times(g, k, device=device)
        self.versions = VersionStore.from_table(g, k, tab)  # v2 surface
        b = _VertexCentricBuilder(g, tab).run()
        N = b.num_nodes
        self.node_u = np.asarray(b.n_u[:N], np.int32)
        self.node_v = np.asarray(b.n_v[:N], np.int32)
        self.node_ct = np.asarray(b.n_ct[:N], np.int32)
        # ascending-ts order for binary search
        self.vlists = [ent[::-1] for ent in b.vlists]

    # -- size accounting --------------------------------------------------
    def nbytes(self) -> int:
        total = (self.node_u.nbytes + self.node_v.nbytes + self.node_ct.nbytes)
        for ent in self.vlists:
            for (_, lst) in ent:
                total += 4 + 4 * len(lst)   # ts key + node ids
        return total

    # -- query (vertex-centric DFS over the CT-MSF) ------------------------
    def _list_at(self, vert: int, ts: int) -> tuple:
        ent = self.vlists[vert]
        i = bisect.bisect_left(ent, (ts, ()))
        if i == len(ent):
            return ()
        return ent[i][1]

    def query(self, u: int, ts: int, te: int) -> set[int]:
        """Deprecated positional shim; prefer ``answer(TCCSQuery(...))``.
        Emits :class:`DeprecationWarning`."""
        warnings.warn(
            "CTMSFIndex.query(u, ts, te) is deprecated; use "
            "answer(TCCSQuery(u, ts, te, k))",
            DeprecationWarning, stacklevel=2)
        return self._component_vertices(u, ts, te)

    def _component_vertices(self, u: int, ts: int, te: int) -> set[int]:
        first = self._list_at(u, ts)
        if not first or self.node_ct[first[0]] > te:
            return set()
        result: set[int] = set()
        seen_v: set[int] = set()
        stack = [u]
        while stack:
            x = stack.pop()
            if x in seen_v:
                continue
            seen_v.add(x)
            lst = self._list_at(x, ts)
            joined = False
            for node in lst:
                if self.node_ct[node] > te:
                    continue
                joined = True
                for y in (int(self.node_u[node]), int(self.node_v[node])):
                    if y not in seen_v:
                        stack.append(y)
            if joined or x == u:
                result.add(x)
        # u itself is only in the component if it had a valid incident edge
        if not any(self.node_ct[e] <= te for e in first):
            return set()
        return result
