"""Temporal graph representation and workload generators.

A temporal graph is an undirected multigraph whose edges carry integer
timestamps. Per the paper (§2) timestamps form a contiguous integer range
starting at 1; ``t_max`` is the largest timestamp. The projected graph
``G_[ts,te]`` keeps the edges whose timestamp lies in the window.

The canonical in-memory layout is struct-of-arrays (``src``, ``dst``, ``t``)
in int32 so the same object feeds the numpy oracle and the host build plane
without conversion.

PyTorch port of ``repro.core.temporal_graph``: the class, the seeded
generator and the named workloads are copied verbatim (same seed, same
graph), and so are the streaming-epoch methods (``extend``,
``expire_before``, ``retain_last``, ``split_at``), ``aggregate_days``
and the contact-tracing generator ``gen_contact_network``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


@dataclasses.dataclass(frozen=True)
class TemporalGraph:
    """Undirected temporal multigraph in edge-list (SoA) form.

    Edges are stored sorted by ``(t, src, dst)``; edge id == array index, so
    the paper's tie-break on "edge ID" is reproducible.
    """

    n: int                     # number of vertices (ids 0..n-1)
    src: np.ndarray            # int32[m]
    dst: np.ndarray            # int32[m]
    t: np.ndarray              # int32[m], timestamps in [1, t_max]

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def t_max(self) -> int:
        # Cached in __post_init__: the serving path and the workload
        # generators hit this per request, and arrays are immutable here.
        return self._t_max

    def __post_init__(self):
        if not (self.src.shape == self.dst.shape == self.t.shape):
            raise ValueError(
                f"edge arrays disagree: src{self.src.shape} "
                f"dst{self.dst.shape} t{self.t.shape}")
        if self.m:
            if int(self.src.max()) >= self.n or int(self.dst.max()) >= self.n:
                raise ValueError(
                    f"endpoint id >= n={self.n} "
                    f"(max src={int(self.src.max())}, "
                    f"dst={int(self.dst.max())})")
            if int(self.t.min()) < 1:
                raise ValueError(
                    f"timestamps must be >= 1, got min {int(self.t.min())}")
        object.__setattr__(self, "_t_max", int(self.t.max()) if self.m else 0)

    # ------------------------------------------------------------------
    @staticmethod
    def from_edges(n: int, edges: Iterable[tuple[int, int, int]]) -> "TemporalGraph":
        """Build from ``(u, v, t)`` triples; sorts by (t, u, v), dedups nothing
        (parallel temporal edges are legal), drops self-loops (degenerate for
        k-core)."""
        arr = np.asarray([(u, v, t) for (u, v, t) in edges if u != v], dtype=np.int64)
        if arr.size == 0:
            z = np.zeros(0, np.int32)
            return TemporalGraph(n, z, z.copy(), z.copy())
        order = np.lexsort((arr[:, 1], arr[:, 0], arr[:, 2]))
        arr = arr[order]
        return TemporalGraph(
            n,
            arr[:, 0].astype(np.int32),
            arr[:, 1].astype(np.int32),
            arr[:, 2].astype(np.int32),
        )

    # -- streaming epochs ----------------------------------------------
    def extend(self, edges: Iterable[tuple[int, int, int]]) -> "TemporalGraph":
        """Append *suffix* edges (all strictly newer than ``t_max``) and
        return the next graph epoch.

        The suffix condition is what makes the streaming plane cheap and
        exact: because edges are stored sorted by ``(t, src, dst)``, a
        suffix append keeps every existing edge id (the old edge arrays are
        a prefix of the new ones), so core-time tables, PECB indexes and
        cached results built for this epoch remain valid for every window
        with ``te <= t_max`` and can be *extended* rather than rebuilt
        (``core_time.extend_core_times``, ``pecb_index.build_pecb_index``
        with ``resume_from``). Out-of-order (historical) edges are
        rejected: they would invalidate the prefix property and require a
        cold rebuild — callers wanting that should build a new graph.

        Self-loops are dropped (as in :meth:`from_edges`); an empty
        ``edges`` returns ``self``.
        """
        arr = np.asarray(
            [(u, v, t) for (u, v, t) in edges if u != v], dtype=np.int64)
        if arr.size == 0:
            return self
        if int(arr[:, 2].min()) <= self.t_max:
            raise ValueError(
                f"extend() takes suffix edges only: got timestamp "
                f"{int(arr[:, 2].min())} <= t_max={self.t_max}; historical "
                "edges need a cold rebuild (TemporalGraph.from_edges)")
        if int(arr[:, :2].max()) >= self.n or int(arr[:, :2].min()) < 0:
            raise ValueError(
                f"extend() edge endpoints must lie in [0, {self.n})")
        order = np.lexsort((arr[:, 1], arr[:, 0], arr[:, 2]))
        arr = arr[order]
        return TemporalGraph(
            self.n,
            np.concatenate([self.src, arr[:, 0].astype(np.int32)]),
            np.concatenate([self.dst, arr[:, 1].astype(np.int32)]),
            np.concatenate([self.t, arr[:, 2].astype(np.int32)]),
        )

    def expire_before(self, t_cut: int) -> "TemporalGraph":
        """Drop every edge with timestamp ``< t_cut`` (prefix expiry) and
        return the next graph epoch with surviving timestamps *shifted* to
        start at 1 again (new ``t`` = old ``t - (t_cut - 1)``).

        The shift is what keeps long-running deployments bounded: every
        downstream structure — the dense ``vertex_ct`` matrix, the packed
        index's per-ts entry streams, device buffers — is sized by
        ``t_max``, so retention must shrink the time axis, not merely thin
        the edge list. The shifted epoch is exactly the graph a cold
        ``from_edges`` build over the surviving triples would produce:
        edges stay sorted by ``(t, src, dst)`` (a constant shift preserves
        the order) and the surviving edges keep their relative ids
        (new id = old id - #expired), which is what lets
        ``core_time.shrink_core_times`` / ``streaming.shrink_pecb_index``
        reduce the retained indices by pure slicing instead of a rebuild.

        ``t_cut <= 1`` expires nothing and returns ``self``; ``t_cut >
        t_max`` expires everything (an empty epoch over the same vertex
        set). Note a cut below the smallest timestamp still *shifts* —
        retention contracts the timeline, not just the edge list.
        """
        t_cut = int(t_cut)
        if t_cut <= 1:
            return self
        cut = int(np.searchsorted(self.t, t_cut, side="left"))
        return TemporalGraph(
            self.n,
            np.ascontiguousarray(self.src[cut:]),
            np.ascontiguousarray(self.dst[cut:]),
            np.ascontiguousarray(self.t[cut:] - np.int32(t_cut - 1)),
        )

    def retain_last(self, w: int) -> "TemporalGraph":
        """Sliding-window retention: keep only the last ``w`` timestamps
        (``expire_before(t_max - w + 1)``). ``w >= t_max`` keeps everything
        and returns ``self``."""
        if w <= 0:
            raise ValueError(f"retention window must be positive, got {w}")
        return self.expire_before(self.t_max - int(w) + 1)

    def split_at(self, t: int) -> tuple["TemporalGraph", np.ndarray]:
        """(epoch graph of edges with timestamp <= t, suffix triples after
        ``t`` as an int64[(s, 3)] array) — the replay harness for streaming
        benchmarks/tests: ``g0.extend(suffix)`` reproduces ``self``."""
        cut = int(np.searchsorted(self.t, t, side="right"))
        g0 = TemporalGraph(self.n, self.src[:cut], self.dst[:cut],
                           self.t[:cut])
        suffix = np.stack([self.src[cut:], self.dst[cut:],
                           self.t[cut:]], axis=1).astype(np.int64)
        return g0, suffix

    def window_mask(self, ts: int, te: int) -> np.ndarray:
        return (self.t >= ts) & (self.t <= te)

    def project(self, ts: int, te: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Edge arrays of the projected graph ``G_[ts,te]`` plus edge ids."""
        mask = self.window_mask(ts, te)
        ids = np.nonzero(mask)[0]
        return self.src[ids], self.dst[ids], ids

    def remap_timestamps(self) -> "TemporalGraph":
        """Densify timestamps to 1..#distinct (paper's contiguity assumption)."""
        uniq, inv = np.unique(self.t, return_inverse=True)
        return TemporalGraph(self.n, self.src, self.dst, (inv + 1).astype(np.int32))

    def aggregate_days(self, edges_per_day: int) -> "TemporalGraph":
        """Coarsen timestamps (the paper's day-level aggregation, §6)."""
        t = ((self.t - 1) // edges_per_day + 1).astype(np.int32)
        return TemporalGraph(self.n, self.src, self.dst, t)


# ----------------------------------------------------------------------
# Synthetic workload generators (the Table 3 datasets are not bundled;
# these mimic their shape — power-law degrees, bursty times).
# ----------------------------------------------------------------------

def gen_temporal_graph(
    n: int,
    m: int,
    t_max: int,
    *,
    seed: int = 0,
    power: float = 1.2,
    burstiness: float = 0.35,
) -> TemporalGraph:
    """Power-law-ish temporal graph.

    Vertex popularity ~ Zipf(power); each edge picks endpoints by popularity;
    timestamps are a mixture of uniform and "bursty" (repeat-previous) draws,
    which produces the core-time clustering real interaction graphs show.
    """
    rng = np.random.default_rng(seed)
    pop = (np.arange(1, n + 1, dtype=np.float64)) ** (-power)
    pop /= pop.sum()
    u = rng.choice(n, size=2 * m, p=pop).astype(np.int64)
    src, dst = u[:m], u[m:]
    fix = src == dst
    dst[fix] = (src[fix] + 1 + rng.integers(0, n - 1, fix.sum())) % n
    t = rng.integers(1, t_max + 1, size=m)
    # bursts: a fraction of edges reuse the timestamp of a random earlier edge
    nb = int(burstiness * m)
    if nb and m > 1:
        idx = rng.integers(1, m, size=nb)
        t[idx] = t[idx - 1]
    return TemporalGraph.from_edges(n, zip(src.tolist(), dst.tolist(), t.tolist())).remap_timestamps()


#: Named benchmark workloads, shaped after Table 3 (reduced scale).
BENCH_WORKLOADS: dict[str, dict] = {
    "fb_like": dict(n=300, m=4000, t_max=160, seed=1),      # FB-Forum-ish
    "cm_like": dict(n=600, m=9000, t_max=190, seed=2),      # CollegeMsg-ish
    "em_like": dict(n=400, m=20000, t_max=260, seed=3),     # Email-ish (dense)
    "mo_like": dict(n=2000, m=24000, t_max=700, seed=4),    # MathOverflow-ish
    "wk_like": dict(n=3000, m=60000, t_max=150, seed=5),    # Wikipedia-ish (few days)
}


def bench_graph(name: str) -> TemporalGraph:
    return gen_temporal_graph(**BENCH_WORKLOADS[name])


def random_queries(g: TemporalGraph, n_q: int, seed: int = 0) -> list[tuple[int, int, int]]:
    """Random (u, ts, te) TCCS queries over the graph's time range — the
    query distribution shared by benchmarks and serving entry points."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, g.n, n_q)
    if g.t_max == 0:          # empty graph: every window is empty anyway
        return [(int(v), 1, 0) for v in u]
    ts = rng.integers(1, g.t_max + 1, n_q)
    te = np.minimum(ts + rng.integers(0, g.t_max, n_q), g.t_max)
    return list(zip(u.tolist(), ts.tolist(), te.tolist()))



def gen_contact_network(n: int, days: int, *, seed: int = 0, meetings_per_day: int | None = None) -> TemporalGraph:
    """Contact-tracing style workload: small-world daily meetings."""
    rng = np.random.default_rng(seed)
    meetings_per_day = meetings_per_day or 4 * n
    edges = []
    home = rng.integers(0, max(1, n // 20), size=n)  # household clusters
    for day in range(1, days + 1):
        a = rng.integers(0, n, size=meetings_per_day)
        same = rng.random(meetings_per_day) < 0.5
        b = np.where(
            same,
            (a + rng.integers(1, 6, meetings_per_day)) % n,  # near ids = same household-ish
            rng.integers(0, n, size=meetings_per_day),
        )
        keep = a != b
        edges.extend(zip(a[keep].tolist(), b[keep].tolist(), [day] * int(keep.sum())))
    return TemporalGraph.from_edges(n, edges)
