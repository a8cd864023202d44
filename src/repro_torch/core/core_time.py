"""Edge core times for all start times (paper §5, Def 4.3).

``CT(e)_ts`` = earliest end time ``te`` such that edge ``e`` is in the k-core
of ``[ts, te]``; ``INF`` (= ``t_max + 1``) when no such ``te`` exists (in
particular whenever ``t(e) < ts``).

Instead of the sequential decremental maintenance of Yu et al. [33], we use a
data-parallel *least-fixpoint* formulation (our TPU-facing adaptation, see
DESIGN.md §3):

    c_v = k-th smallest over distinct neighbours u of  max(t_uv, c_u)
          (t_uv = earliest timestamp >= ts among parallel (u,v) edges),
    c_v = INF when v has < k distinct neighbours in [ts, t_max].

Iterating this monotone operator from a lower bound converges to the least
fixpoint, which equals the true vertex core times: for any fixpoint c* and
any te, S = {v : c*_v <= te} induces a subgraph of G_[ts,te] with min degree
>= k, so S is inside the true k-core (hence true <= c*); Kleene iteration
from below yields the least fixpoint (hence <= true). We iterate the
*clamped* operator ``c <- max(c, kth(w))``: iterates are then monotone, stay
below the least fixpoint, and a converged point is simultaneously a pre- and
post-fixpoint, hence the least fixpoint itself. Edge core times follow as
``CT(e)_ts = max(t_e, c_u, c_v)`` (§5: "the larger one among the core times
of its terminal vertices", plus window membership t_e >= ts).

Both engines sweep ts = 1..t_max with warm-started lower bounds
(c_{ts-1} <= c_ts because shrinking the window only raises core times)
over one precomputed structure (`_PairCSR` + blockwise `_tuv_rows` of
per-pair earliest timestamps >= ts), and both return bit-identical tables
(the least fixpoint is unique; tests assert array equality):

* ``engine="host"`` — numpy: per iteration one in-place packed sort
  (segment id packed into the key's high bits) gives both the fixpoint
  *verification* (a searchsorted rank probe: c is converged iff
  count(w <= c_v) >= k) and, when not converged, the k-th smallest climb.
* ``engine="device"`` — the counterpart of the reference's ``_sweep_jax``
  (and of its ``"jax_pallas"`` variant): the same verification and gated
  climb, every probe and climb of every stratum over a whole t_uv block
  in one launch of the hand-written kernel
  ``kernels/segmented_select.stratum_sweep``. No host is in the fixpoint
  loop: the host builds and uploads each t_uv block, as the reference
  does, and downloads the rows once.

* ``engine="legacy"`` — the seed's per-ts numpy lexsort loop, kept as the
  differential-testing oracle.

``engine="auto"`` picks by the ``device`` argument: a CUDA device runs the
device engine, the CPU the host engine. The result is delta-compressed by
the vectorized run-length `_compress`.

The epoch plane grows a table across a suffix append
(`extend_core_times`, `extend_stratified_core_times`) and shrinks it
across a prefix expiry (`shrink_core_times`,
`shrink_stratified_core_times`), each bit-identical to a cold build of
the new graph. Extend has the host and the device engine: the host runs
the reference's suffix sweep and frontier fixpoint, the device sweeps
every stratum of the new graph in the same launches as a cold build; both
then keep the previous records verbatim and run-detect new ones only
over the flipped intervals. Shrink is pure slicing on the host.

PyTorch port of ``repro.core.core_time``, copied so the port stands
alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.segmented_select import stratum_sweep
from .temporal_graph import TemporalGraph


# ----------------------------------------------------------------------
# Shared precomputed structure: directed distinct-pair CSR + t_uv table
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _PairCSR:
    """Doubled (directed) distinct-pair CSR over *all* edges, pairs sorted
    by (src, dst), per-pair timestamps ascending. Built once per (g,)."""

    src: np.ndarray      # int32[E] pair source, non-decreasing
    dst: np.ndarray      # int32[E]
    ptr: np.ndarray      # int64[E+1] pair -> slots in tsorted
    tsorted: np.ndarray  # int32[2m] per-pair ascending timestamps
    vptr: np.ndarray     # int64[n+1] vertex -> pair rows (CSR over src)
    pidx: np.ndarray     # int64[2m] slot -> pair (inverse of ptr)


def _pair_csr(g: TemporalGraph) -> _PairCSR:
    n = g.n
    s = np.concatenate([g.src, g.dst]).astype(np.int64)
    d = np.concatenate([g.dst, g.src]).astype(np.int64)
    t = np.concatenate([g.t, g.t]).astype(np.int64)
    key = s * n + d
    order = np.lexsort((t, key))
    key, t = key[order], t[order]
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(first)
    ptr = np.concatenate([starts, [key.shape[0]]]).astype(np.int64)
    pkey = key[first]
    src = (pkey // n).astype(np.int32)
    vptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=vptr[1:])
    pidx = np.repeat(np.arange(ptr.shape[0] - 1), np.diff(ptr))
    # repro: ignore[int32-narrowing] — g.t's int32 timestamps, sorted
    tsorted = t.astype(np.int32)
    return _PairCSR(src, (pkey % n).astype(np.int32), ptr, tsorted, vptr,
                    pidx)


#: ts rows materialized per t_uv block: bounds sweep scratch at O(BLOCK * E)
TUV_BLOCK = 256


def _tuv_rows(csr: _PairCSR, ts0: int, ts1: int, t_max: int) -> np.ndarray:
    """int32[ts1-ts0, E]: row i = earliest pair timestamp >= ts0+i (INF when
    none). Blocked so the sweep never holds the full (t_max, E) table: a
    global searchsorted seeds row ts1, block-local events + one reverse
    running-min fill the rest."""
    E = csr.ptr.shape[0] - 1
    inf = t_max + 1
    # stored descending (row i = ts1 - i) so the running min walks forward
    # over contiguous memory; the caller gets an ascending reversed view
    rev = np.full((ts1 - ts0 + 1, E), inf, np.int32)
    if E == 0:
        return rev[1:]
    # seed (row 0): earliest timestamp >= ts1 per pair. tsorted is sorted
    # by (pair, t), so pair*stride + t is globally sorted and one
    # searchsorted answers every pair at once.
    stride = np.int64(t_max + 2)
    packed = csr.pidx * stride + csr.tsorted
    pos = np.searchsorted(packed, np.arange(E, dtype=np.int64) * stride + ts1)
    valid = pos < csr.ptr[1:]
    rev[0, valid] = csr.tsorted[pos[valid]]
    # events inside [ts0, ts1), then running min toward ts0
    ev = (csr.tsorted >= ts0) & (csr.tsorted < ts1)
    rev[ts1 - csr.tsorted[ev], csr.pidx[ev]] = csr.tsorted[ev]
    np.minimum.accumulate(rev, axis=0, out=rev)
    return rev[1:][::-1]


# ----------------------------------------------------------------------
# Legacy per-ts fixpoint (seed implementation; oracle)
# ----------------------------------------------------------------------

def _simple_projection(g: TemporalGraph, ts: int):
    """Doubled (directed) simple-graph arrays for window [ts, t_max]:
    per (v, u) distinct pair the earliest timestamp >= ts."""
    keep = g.t >= ts
    s, d, t = g.src[keep], g.dst[keep], g.t[keep]
    src_d = np.concatenate([s, d]).astype(np.int64)
    dst_d = np.concatenate([d, s]).astype(np.int64)
    t_d = np.concatenate([t, t]).astype(np.int64)
    # group by (src, dst), keep min t
    key = src_d * g.n + dst_d
    order = np.lexsort((t_d, key))
    key, t_d = key[order], t_d[order]
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    key, t_d = key[first], t_d[first]
    return (key // g.n).astype(np.int64), (key % g.n).astype(np.int64), t_d


def vertex_core_times(g: TemporalGraph, k: int, ts: int,
                      warm: np.ndarray | None = None) -> np.ndarray:
    """int64[n] vertex core times for start time ts (INF = t_max + 1).

    The seed's per-ts numpy lexsort fixpoint, kept verbatim: the batched
    engines are asserted bit-identical against it."""
    INF = g.t_max + 1
    src_d, dst_d, t_d = _simple_projection(g, ts)
    n = g.n
    deg = np.bincount(src_d, minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    has_k = deg >= k
    sel = offsets[:-1][has_k] + (k - 1)  # index of k-th smallest within segment

    c = np.full(n, INF, np.int64)
    if warm is not None:
        c = np.maximum(warm, np.where(has_k, 0, INF))
        c[~has_k] = INF
    else:
        # lower bound: k-th smallest edge timestamp per vertex
        order = np.lexsort((t_d, src_d))
        c[has_k] = t_d[order[sel]]
    while True:
        w = np.maximum(t_d, c[dst_d])
        order = np.lexsort((w, src_d))
        c_new = np.full(n, INF, np.int64)
        c_new[has_k] = w[order[sel]]
        c_new = np.minimum(c_new, INF)
        if np.array_equal(c_new, c):
            return c
        c = c_new


# ----------------------------------------------------------------------
# Compressed table
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoreTimeTable:
    """Compressed core times for all start times (paper Table 1 layout).

    Version records, sorted by (edge_id, ts_from): edge ``edge_id`` has core
    time ``ct`` for every start time in ``[ts_from, ts_to]`` (inclusive);
    ``ts_to`` is the paper's ``lst``. Only finite-CT versions are stored.
    All values are bounded by ``max(t_max + 1, m)``, so records are stored
    int32; ``nbytes`` is the paper's index-size metric and sums the actual
    bytes of the stored version arrays (mirroring ``PECBIndex.nbytes``).
    """

    n: int
    m: int
    t_max: int
    edge_id: np.ndarray   # int32[R]
    ts_from: np.ndarray   # int32[R]
    ts_to: np.ndarray     # int32[R]  (lst)
    ct: np.ndarray        # int32[R]
    vertex_ct: np.ndarray  # int32[t_max + 1, n]; row ts = vertex core times

    @property
    def INF(self) -> int:
        return self.t_max + 1

    @property
    def num_versions(self) -> int:
        return int(self.edge_id.shape[0])

    def nbytes(self) -> int:
        """True byte size of the stored version arrays (the compressed
        core-time table alone, excluding the dense vertex_ct matrix)."""
        return int(self.edge_id.nbytes + self.ts_from.nbytes
                   + self.ts_to.nbytes + self.ct.nbytes)

    def ct_at(self, edge: int, ts: int) -> int:
        """CT(edge)_ts by scanning this edge's versions (test helper)."""
        sel = (self.edge_id == edge) & (self.ts_from <= ts) & (ts <= self.ts_to)
        idx = np.nonzero(sel)[0]
        return int(self.ct[idx[0]]) if idx.size else self.INF


def _as_table(g: TemporalGraph, edge_id, ts_from, ts_to, ct,
              vct) -> CoreTimeTable:
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return CoreTimeTable(g.n, g.m, g.t_max, i32(edge_id), i32(ts_from),
                         i32(ts_to), i32(ct), i32(vct))


# ----------------------------------------------------------------------
# Vectorized delta-compression (shared by every engine)
# ----------------------------------------------------------------------

def _compress(g: TemporalGraph, vct: np.ndarray,
              edge_chunk: int = 8192) -> CoreTimeTable:
    """Version records from the dense (t_max+1, n) vertex-core-time matrix.

    Per edge, CT rows over ts form maximal constant runs; finite runs are
    the stored versions. Edge-major run detection keeps the output exactly
    in (edge_id, ts_from) lexsort order. Chunked over edges to bound the
    (chunk, T) scratch."""
    t_max, m = g.t_max, g.m
    inf = t_max + 1
    if t_max == 0 or m == 0:
        z = np.zeros(0, np.int32)
        return _as_table(g, z, z, z, z, vct)
    ts_row = np.arange(1, t_max + 1, dtype=np.int32)[None, :]
    vct_t = np.ascontiguousarray(vct[1:].T)               # (n, T) row-major
    recs = []
    for lo in range(0, m, edge_chunk):
        hi = min(lo + edge_chunk, m)
        su = g.src[lo:hi].astype(np.int64)
        sv = g.dst[lo:hi].astype(np.int64)
        st = g.t[lo:hi].astype(np.int32)
        ctm = np.maximum(vct_t[su], vct_t[sv])            # (B, T) edge-major
        np.maximum(ctm, st[:, None], out=ctm)
        np.minimum(ctm, inf, out=ctm)
        ctm[ts_row > st[:, None]] = inf                   # edge outside window
        flat = ctm.reshape(-1)
        start = np.empty(flat.shape[0], bool)
        start[0] = True
        np.not_equal(flat[1:], flat[:-1], out=start[1:])
        start[::t_max] = True                             # runs never span edges
        sidx = np.flatnonzero(start)
        vals = flat[sidx]
        nxt = np.empty_like(sidx)
        nxt[:-1] = sidx[1:]
        nxt[-1] = flat.shape[0]
        keep = vals < inf
        sidx, nxt, vals = sidx[keep], nxt[keep], vals[keep]
        recs.append((sidx // t_max + lo, sidx % t_max + 1,
                     (nxt - 1) % t_max + 1, vals))
    edge_id = np.concatenate([r[0] for r in recs])
    ts_from = np.concatenate([r[1] for r in recs])
    ts_to = np.concatenate([r[2] for r in recs])
    ct = np.concatenate([r[3] for r in recs])
    return _as_table(g, edge_id, ts_from, ts_to, ct, vct)


# ----------------------------------------------------------------------
# Host engine: vectorized numpy sweep
# ----------------------------------------------------------------------

def _sweep_host(g: TemporalGraph, k: int) -> np.ndarray:
    """(t_max+1, n) int32 vertex core times for every start time.

    Per iteration one in-place sort of segment-packed keys serves both the
    convergence probe (searchsorted rank test) and the k-th-smallest climb;
    warm starts make most start times converge in a single iteration."""
    n, t_max = g.n, g.t_max
    inf = t_max + 1
    vct = np.full((t_max + 1, n), inf, np.int32)
    if g.m == 0 or t_max == 0:
        return vct
    csr = _pair_csr(g)
    deg = np.diff(csr.vptr)
    has_k = deg >= k
    sel = csr.vptr[:-1][has_k] + (k - 1)
    # segment id packed into high bits: one flat sort orders every segment
    S = 1
    while S < inf + 2:
        S *= 2
    kdtype = np.int32 if n * S < 2 ** 31 else np.int64
    base = (csr.src.astype(np.int64) * S).astype(kdtype)
    vbase = (np.arange(n, dtype=np.int64) * S).astype(kdtype)
    pd = csr.dst.astype(np.int64)
    vstart = csr.vptr[:-1]

    c = np.zeros(n, np.int32)
    for ts0 in range(1, t_max + 1, TUV_BLOCK):
        ts1 = min(ts0 + TUV_BLOCK, t_max + 1)
        tuv_rows = _tuv_rows(csr, ts0, ts1, t_max)
        for ts in range(ts0, ts1):
            tuv = tuv_rows[ts - ts0]
            while True:
                w = np.maximum(tuv, c[pd]).astype(kdtype, copy=False)
                key = base + w
                key.sort()
                # count(w <= c_v) per segment: rank probe in the sorted keys
                cnt = np.searchsorted(key, vbase + c + 1) - vstart
                if bool(((cnt >= k) | (c >= inf)).all()):
                    break
                c_new = np.full(n, inf, np.int32)
                c_new[has_k] = (key[sel] & (S - 1)) if kdtype == np.int32 \
                    else key[sel] % S
                np.minimum(c_new, inf, out=c_new)
                np.maximum(c, c_new, out=c)
            vct[ts] = c
    return vct


# ----------------------------------------------------------------------
# K-stratified plane: one build serves every k
# ----------------------------------------------------------------------

def _rle_columns(vct: np.ndarray, t_max: int):
    """Run-length encode the finite cells of a dense (t_max+1, n) vertex
    core-time matrix, per vertex over ts = 1..t_max.

    Returns ``(counts, ts_from, ts_to, val)`` with runs sorted by
    (vertex, ts_from) — the same edge-major run detection as `_compress`,
    applied to vertex columns. INF cells are simply absent (decode fills
    INF), so encode/decode round-trips bit-exactly.
    """
    n = vct.shape[1]
    inf = t_max + 1
    z = np.zeros(0, np.int32)
    if t_max == 0 or n == 0:
        return np.zeros(n, np.int64), z, z, z
    cols = np.ascontiguousarray(vct[1:].T).reshape(-1)    # (n*T,) row-major
    start = np.empty(cols.shape[0], bool)
    start[0] = True
    np.not_equal(cols[1:], cols[:-1], out=start[1:])
    start[::t_max] = True                                 # runs stay in-column
    sidx = np.flatnonzero(start)
    vals = cols[sidx]
    nxt = np.empty_like(sidx)
    nxt[:-1] = sidx[1:]
    nxt[-1] = cols.shape[0]
    keep = vals < inf
    sidx, nxt, vals = sidx[keep], nxt[keep], vals[keep]
    counts = np.bincount(sidx // t_max, minlength=n).astype(np.int64)
    return (counts, (sidx % t_max + 1).astype(np.int32),
            ((nxt - 1) % t_max + 1).astype(np.int32),
            vals.astype(np.int32))


def _expand_runs(n: int, t_max: int, vptr: np.ndarray, ts_from: np.ndarray,
                 ts_to: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Inverse of `_rle_columns`: dense (t_max+1, n) int32 matrix, INF
    everywhere no run covers. ``vptr`` is the per-vertex run CSR."""
    vct = np.full((t_max + 1, n), t_max + 1, np.int32)
    if ts_from.size == 0:
        return vct
    lens = (ts_to - ts_from + 1).astype(np.int64)
    total = int(lens.sum())
    off = np.zeros(ts_from.shape[0] + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    flat_ts = (np.arange(total, dtype=np.int64)
               - np.repeat(off[:-1], lens) + np.repeat(ts_from, lens))
    run_vert = np.repeat(np.arange(n, dtype=np.int64), np.diff(vptr))
    vct[flat_ts, np.repeat(run_vert, lens)] = np.repeat(val, lens)
    return vct


@dataclasses.dataclass(frozen=True)
class StratifiedCoreTable:
    """Core-time tables for every supported k, packed as one structure.

    Record arrays are the per-k ``CoreTimeTable`` version records
    concatenated in ascending-k blocks (``kptr`` bounds block i); each
    block keeps its (edge_id, ts_from) lexsort order verbatim, so
    ``table_for(k)`` is a zero-copy slice that is bit-identical to the
    per-k table of stratum k.

    Vertex core times are stored run-length encoded per (k, vertex) slot
    (``vptr`` is a CSR over slot = k_index * n + vertex) instead of |K|
    dense (t_max+1, n) matrices — columns are piecewise constant in ts,
    so this is the memory lever that lets one stratified handle undercut
    |K| per-k handles. ``table_for`` re-expands the dense matrix on
    demand (the forest builder reads the per-k table).
    """

    n: int
    m: int
    t_max: int
    ks: tuple[int, ...]       # ascending, strictly increasing
    kptr: np.ndarray          # int64[|K|+1] record-block bounds
    edge_id: np.ndarray       # int32[R] concat per-k blocks
    ts_from: np.ndarray       # int32[R]
    ts_to: np.ndarray         # int32[R]
    ct: np.ndarray            # int32[R]
    vptr: np.ndarray          # int64[|K|*n + 1] vertex-run CSR over slots
    v_ts_from: np.ndarray     # int32[VR]
    v_ts_to: np.ndarray       # int32[VR]
    v_ct: np.ndarray          # int32[VR]

    @property
    def INF(self) -> int:
        return self.t_max + 1

    @property
    def num_versions(self) -> int:
        return int(self.edge_id.shape[0])

    def nbytes(self) -> int:
        """Bytes of everything stored — records, vertex runs and both
        pointer tables (unlike `CoreTimeTable.nbytes` there is no dense
        matrix to exclude; the RLE strata *are* the vertex storage)."""
        return int(self.kptr.nbytes + self.edge_id.nbytes
                   + self.ts_from.nbytes + self.ts_to.nbytes + self.ct.nbytes
                   + self.vptr.nbytes + self.v_ts_from.nbytes
                   + self.v_ts_to.nbytes + self.v_ct.nbytes)

    def k_index(self, k: int) -> int:
        i = int(np.searchsorted(np.asarray(self.ks), k))
        if i >= len(self.ks) or self.ks[i] != k:
            raise KeyError(f"k={k} not in supported strata {self.ks}")
        return i

    def table_for(self, k: int) -> CoreTimeTable:
        """The per-k ``CoreTimeTable`` of stratum k: record arrays are
        views, the dense vertex matrix is re-expanded from the runs."""
        i = self.k_index(k)
        lo, hi = int(self.kptr[i]), int(self.kptr[i + 1])
        vlo, vhi = i * self.n, (i + 1) * self.n
        rlo, rhi = int(self.vptr[vlo]), int(self.vptr[vhi])
        vct = _expand_runs(self.n, self.t_max,
                           self.vptr[vlo:vhi + 1] - self.vptr[vlo],
                           self.v_ts_from[rlo:rhi], self.v_ts_to[rlo:rhi],
                           self.v_ct[rlo:rhi])
        return CoreTimeTable(self.n, self.m, self.t_max,
                             self.edge_id[lo:hi], self.ts_from[lo:hi],
                             self.ts_to[lo:hi], self.ct[lo:hi], vct)

    @classmethod
    def from_tables(cls, g: TemporalGraph, ks, tables) -> "StratifiedCoreTable":
        """Stratify per-k ``CoreTimeTable``s (ascending k order). Each
        table's records are taken verbatim; dense matrices are RLE'd."""
        ks = _validate_ks(ks)
        if len(tables) != len(ks):
            raise ValueError("one table per k required")
        n, t_max = g.n, g.t_max
        kptr = np.zeros(len(ks) + 1, np.int64)
        counts_all = []
        for i, tab in enumerate(tables):
            if (tab.n, tab.m, tab.t_max) != (n, g.m, t_max):
                raise ValueError("table shape mismatch with graph")
            kptr[i + 1] = kptr[i] + tab.num_versions
        i32 = lambda parts: (np.concatenate(parts).astype(np.int32, copy=False)
                             if parts else np.zeros(0, np.int32))
        rle = [_rle_columns(tab.vertex_ct, t_max) for tab in tables]
        for counts, _, _, _ in rle:
            counts_all.append(counts)
        vptr = np.zeros(len(ks) * n + 1, np.int64)
        if counts_all:
            np.cumsum(np.concatenate(counts_all), out=vptr[1:])
        return cls(
            n, g.m, t_max, ks, kptr,
            i32([t.edge_id for t in tables]), i32([t.ts_from for t in tables]),
            i32([t.ts_to for t in tables]), i32([t.ct for t in tables]),
            vptr, i32([r[1] for r in rle]), i32([r[2] for r in rle]),
            i32([r[3] for r in rle]))


def _validate_ks(ks) -> tuple[int, ...]:
    ks = tuple(int(k) for k in ks)
    if any(k < 1 for k in ks):
        raise ValueError(f"strata must be k >= 1, got {ks}")
    if any(b <= a for a, b in zip(ks, ks[1:])):
        raise ValueError(f"strata must be strictly ascending, got {ks}")
    return ks


def default_ks(g: TemporalGraph, device=None) -> tuple[int, ...]:
    """The full useful range 2..k_max(g): below 2 a TCCS query is invalid,
    above the degeneracy every answer is exactly empty (no stratum needed).
    ``device`` is :func:`kcore.k_max`'s: None peels in numpy, a torch device
    through the peel fixpoint there."""
    from .kcore import k_max

    if g.m == 0:
        return ()
    return tuple(range(2, k_max(g, device) + 1))


def kcore_device(engine: str, device):
    """Where a build's k range is peeled: on ``device`` when the build runs
    the device engine, in numpy (None) for the host and legacy engines."""
    return device if _engine(engine, device) == "device" else None


def _sweep_host_stratified(g: TemporalGraph, ks) -> list[np.ndarray]:
    """Dense (t_max+1, n) vertex core times for every k in ``ks``, fused.

    One pair-CSR and one blocked t_uv table serve every stratum; inside a
    ts block the k loop ascends and seeds each stratum's fixpoint with
    ``max(carry_k(ts-1), c_{kprev}(ts))`` — both are lower bounds of the
    least fixpoint (window shrink / k-core nesting), and iterating the
    clamped operator from *any* lower bound converges to the same lfp, so
    every stratum row is bit-identical to the per-k `_sweep_host` row.
    The inner loop is `_sweep_host`'s verbatim (one packed sort per
    iteration serves both the rank probe and the climb).
    """
    n, t_max = g.n, g.t_max
    inf = t_max + 1
    vcts = [np.full((t_max + 1, n), inf, np.int32) for _ in ks]
    if g.m == 0 or t_max == 0 or not ks:
        return vcts
    csr = _pair_csr(g)
    deg = np.diff(csr.vptr)
    S = 1
    while S < inf + 2:
        S *= 2
    kdtype = np.int32 if n * S < 2 ** 31 else np.int64
    base = (csr.src.astype(np.int64) * S).astype(kdtype)
    vbase = (np.arange(n, dtype=np.int64) * S).astype(kdtype)
    pd = csr.dst.astype(np.int64)
    vstart = csr.vptr[:-1]
    has_k = [deg >= k for k in ks]
    sel = [csr.vptr[:-1][h] + (k - 1) for k, h in zip(ks, has_k)]
    carry = [np.zeros(n, np.int32) for _ in ks]
    for ts0 in range(1, t_max + 1, TUV_BLOCK):
        ts1 = min(ts0 + TUV_BLOCK, t_max + 1)
        tuv_rows = _tuv_rows(csr, ts0, ts1, t_max)
        for ki, k in enumerate(ks):
            c = carry[ki]
            vct = vcts[ki]
            seed_rows = vcts[ki - 1] if ki else None
            for ts in range(ts0, ts1):
                tuv = tuv_rows[ts - ts0]
                if seed_rows is not None:
                    np.maximum(c, seed_rows[ts], out=c)
                while True:
                    w = np.maximum(tuv, c[pd]).astype(kdtype, copy=False)
                    key = base + w
                    key.sort()
                    cnt = np.searchsorted(key, vbase + c + 1) - vstart
                    if bool(((cnt >= k) | (c >= inf)).all()):
                        break
                    c_new = np.full(n, inf, np.int32)
                    c_new[has_k[ki]] = (key[sel[ki]] & (S - 1)) \
                        if kdtype == np.int32 else key[sel[ki]] % S
                    np.minimum(c_new, inf, out=c_new)
                    np.maximum(c, c_new, out=c)
                vct[ts] = c
    return vcts


# ----------------------------------------------------------------------
# Device engine: the sweep on the card, one kernel launch per t_uv block
# ----------------------------------------------------------------------

def _sweep_device_stratified(g: TemporalGraph, ks, *, device,
                             stats: dict | None = None) -> list[np.ndarray]:
    """Dense (t_max+1, n) int32 vertex core times for every k in ``ks``,
    swept on ``device``; the counterpart of the reference's ``_sweep_jax``
    with its Pallas counter.

    Per (k, ts) the same verification as the reference: with ``w =
    max(t_uv, c[dst])``, ``c`` is converged iff every segment has
    ``count(w <= c_v) >= k`` or ``c_v >= INF``; otherwise the climb ``c
    <- max(c, kth(w))`` and the probe repeats. One pair CSR serves every
    stratum; per t_uv block the host builds and uploads the rows and makes
    one `stratum_sweep` launch, which runs every stratum's probes and
    climbs over the block on the device and writes the rows straight into
    one (|K|, t_max+1, n) tensor, downloaded once at the end. The carry is
    warm across ts and across blocks; row 0 stays INF. Each stratum starts
    each ts from its own carry (a lower bound of the least fixpoint, as
    the host's ``max(carry, c_{kprev}(ts))`` is), so every stratum equals
    the per-k sweep, counts included. ``stats`` (optional) gains the
    counts ``iterations`` (probes) and ``climbs``, summed over strata, and
    ``strata``, an int64 (|K|, 2) array of the same per stratum."""
    n, t_max = g.n, g.t_max
    inf = t_max + 1
    if g.m == 0 or t_max == 0 or not ks:
        return [np.full((t_max + 1, n), inf, np.int32) for _ in ks]
    device = torch.device(device)
    csr = _pair_csr(g)
    seg = torch.as_tensor(csr.src, device=device)        # CSR: non-decreasing
    vptr = torch.as_tensor(csr.vptr.astype(np.int32), device=device)
    dst = torch.as_tensor(csr.dst, device=device)
    ks_t = torch.as_tensor(np.asarray(ks, np.int32), device=device)
    rows = torch.full((len(ks), t_max + 1, n), inf, dtype=torch.int32,
                      device=device)
    carry = torch.zeros((len(ks), n), dtype=torch.int32, device=device)
    counts = torch.zeros((len(ks), 2), dtype=torch.int64, device=device)
    for ts0 in range(1, t_max + 1, TUV_BLOCK):
        ts1 = min(ts0 + TUV_BLOCK, t_max + 1)
        tuv = torch.as_tensor(
            np.ascontiguousarray(_tuv_rows(csr, ts0, ts1, t_max)),
            device=device)
        counts += stratum_sweep(tuv, seg, vptr, dst, ks_t, carry, inf,
                                out=rows[:, ts0:ts1])[1]
    if stats is not None:
        per = counts.cpu().numpy()
        stats["iterations"] = stats.get("iterations", 0) + int(per[:, 0].sum())
        stats["climbs"] = stats.get("climbs", 0) + int(per[:, 1].sum())
        stats["strata"] = per
    host = rows.cpu().numpy()
    return list(host)


def _sweep_device(g: TemporalGraph, k: int, *, device,
                  stats: dict | None = None) -> np.ndarray:
    """(t_max+1, n) int32 vertex core times of one k, on ``device``."""
    return _sweep_device_stratified(g, (k,), device=device, stats=stats)[0]


# ----------------------------------------------------------------------
# Engine dispatch
# ----------------------------------------------------------------------

def _edge_core_times_legacy(g: TemporalGraph, k: int) -> CoreTimeTable:
    """The seed's construction loop: per-ts projection + lexsort
    fixpoint, incremental version bookkeeping."""
    t_max = g.t_max
    INF = t_max + 1
    m = g.m
    su, sv, st = (g.src.astype(np.int64), g.dst.astype(np.int64),
                  g.t.astype(np.int64))

    cur = np.full(m, -1, np.int64)          # current CT per edge (-1 = unseen)
    open_from = np.zeros(m, np.int64)       # ts at which `cur` became valid
    recs_e, recs_a, recs_b, recs_c = [], [], [], []
    vct = np.full((t_max + 2, g.n), INF, np.int64)

    warm = None
    for ts in range(1, t_max + 1):
        c = vertex_core_times(g, k, ts, warm=warm)
        warm = c
        vct[ts] = c
        ct_ts = np.maximum(st, np.maximum(c[su], c[sv]))
        ct_ts = np.where(st >= ts, ct_ts, INF)
        ct_ts = np.minimum(ct_ts, INF)
        changed = ct_ts != cur
        if changed.any():
            idx = np.nonzero(changed)[0]
            closing = idx[cur[idx] >= 0]
            # close versions whose CT was finite
            fin = closing[cur[closing] < INF]
            if fin.size:
                recs_e.append(fin)
                recs_a.append(open_from[fin])
                recs_b.append(np.full(fin.size, ts - 1, np.int64))
                recs_c.append(cur[fin])
            cur[idx] = ct_ts[idx]
            open_from[idx] = ts
    # close the tail versions
    tail = np.nonzero((cur >= 0) & (cur < INF))[0]
    if tail.size:
        recs_e.append(tail)
        recs_a.append(open_from[tail])
        recs_b.append(np.full(tail.size, t_max, np.int64))
        recs_c.append(cur[tail])

    if recs_e:
        edge_id = np.concatenate(recs_e)
        ts_from = np.concatenate(recs_a)
        ts_to = np.concatenate(recs_b)
        ct = np.concatenate(recs_c)
        order = np.lexsort((ts_from, edge_id))
        edge_id, ts_from, ts_to, ct = (edge_id[order], ts_from[order],
                                       ts_to[order], ct[order])
    else:
        edge_id = ts_from = ts_to = ct = np.zeros(0, np.int64)
    return _as_table(g, edge_id, ts_from, ts_to, ct, vct[: t_max + 1])


ENGINES = ("auto", "host", "device", "legacy")


def _engine(engine: str, device) -> str:
    """The engine to run: ``"auto"`` follows the ``device`` argument (CUDA:
    ``"device"``, CPU: ``"host"``), never what the machine has."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}, expected one of {ENGINES}")
    if engine != "auto":
        return engine
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no construction engine for device {device}")
    return "device" if kind == "cuda" else "host"


def edge_core_times(g: TemporalGraph, k: int, *, engine: str = "auto",
                    device="cuda", stats: dict | None = None) -> CoreTimeTable:
    """CT(e)_ts for every edge and start time, delta-compressed.

    ``engine`` is ``"host"`` (numpy), ``"device"`` (the sweep on
    ``device``, one `stratum_sweep` launch per t_uv block), ``"legacy"``
    (the seed's per-ts loop) or ``"auto"`` (by ``device``). Every engine
    returns bit-identical tables; ``stats`` collects the device engine's
    counts (see `_sweep_device_stratified`)."""
    eng = _engine(engine, device)
    if eng == "legacy":
        return _edge_core_times_legacy(g, k)
    if eng == "host":
        vct = _sweep_host(g, k)
    else:
        vct = _sweep_device(g, k, device=device, stats=stats)
    return _compress(g, vct)


def stratified_core_times(g: TemporalGraph, ks=None, *, engine: str = "auto",
                          device="cuda",
                          stats: dict | None = None) -> StratifiedCoreTable:
    """One k-stratified core-time build covering every k in ``ks``
    (default: the full useful range ``default_ks(g)``, its k-core peeled
    on ``device`` by the device engine, see :func:`kcore_device`): the fused
    warm-seeded sweep of the chosen engine (``"auto"``: by ``device``;
    ``"legacy"`` runs per k). Every stratum is bit-identical to the per-k
    table."""
    if ks is None:
        ks = default_ks(g, kcore_device(engine, device))
    ks = _validate_ks(ks)
    eng = _engine(engine, device)
    if eng == "legacy":
        tables = [_edge_core_times_legacy(g, k) for k in ks]
        return StratifiedCoreTable.from_tables(g, ks, tables)
    if eng == "host":
        vcts = _sweep_host_stratified(g, ks)
    else:
        vcts = _sweep_device_stratified(g, ks, device=device, stats=stats)
    return StratifiedCoreTable.from_tables(
        g, ks, [_compress(g, vct) for vct in vcts])


# ----------------------------------------------------------------------
# Streaming plane: incremental sweep for suffix-extended graphs
# ----------------------------------------------------------------------

def _extend_engine(engine: str, device) -> str:
    eng = _engine(engine, device)
    if eng == "legacy":
        raise ValueError("extend runs the host or the device engine, not "
                         "'legacy'")
    return eng


def _check_extend(g: TemporalGraph, prev) -> bool:
    """Raise unless ``g`` suffix-extends the graph ``prev`` (a
    ``CoreTimeTable`` or a ``StratifiedCoreTable``) was built for; True
    when nothing was appended (the same epoch)."""
    t_old, t_new = prev.t_max, g.t_max
    m_old, m_new = prev.m, g.m
    if prev.n != g.n:
        raise ValueError(f"vertex count changed ({prev.n} -> {g.n}); "
                         "extend_core_times needs the same vertex set")
    if m_old > m_new or t_old > t_new:
        raise ValueError("prev table does not describe a prefix of g")
    if m_old and g.t[m_old - 1] > t_old:
        raise ValueError("prev table does not match g's edge prefix")
    if m_new > m_old and g.t[m_old] <= t_old:
        raise ValueError(
            f"appended edges must be a timestamp suffix (> {t_old}); "
            "historical edges need a cold edge_core_times rebuild")
    return m_new == m_old


def _extend_rows_host(g: TemporalGraph, k: int,
                      prev: CoreTimeTable) -> np.ndarray:
    """The new epoch's (t_new+1, n) int32 vertex core times from the old
    epoch's, on the host (the reference's algorithm): an ordinary sweep
    over the shifted suffix for the new start times, a frontier fixpoint
    over the old ones (see `extend_core_times`)."""
    t_old, t_new = prev.t_max, g.t_max
    m_old = prev.m
    inf_new = t_new + 1
    n = g.n
    vct = np.full((t_new + 1, n), inf_new, np.int32)
    vo = prev.vertex_ct

    # -- new start times: ordinary sweep over the shifted suffix ---------
    g_suf = TemporalGraph(n, g.src[m_old:], g.dst[m_old:],
                          (g.t[m_old:] - t_old).astype(np.int32))
    vs = _sweep_host(g_suf, k)            # (t_new - t_old + 1, n)
    t_suf = t_new - t_old
    fin = vs[1:] <= t_suf
    block = np.full((t_suf, n), inf_new, np.int32)
    block[fin] = (vs[1:][fin] + t_old).astype(np.int32)
    vct[t_old + 1:] = block

    # -- old start times: frontier fixpoint ------------------------------
    csr = _pair_csr(g)
    stride = np.int64(t_new + 2)
    packed = csr.pidx * stride + csr.tsorted      # globally sorted
    rowend = csr.ptr[1:]
    deg_all = np.diff(csr.vptr)
    S = np.int64(1)
    while S < inf_new + 2:
        S <<= 1
    carry = np.zeros(n, np.int32)     # previous new row (lower bound)
    for ts in range(1, t_old + 1):
        old = vo[ts]
        known = old <= t_old
        vct[ts] = np.where(known, old, inf_new)
        front = np.flatnonzero(~known & (carry <= t_new) & (deg_all >= k))
        if front.size == 0:
            carry = vct[ts]
            continue
        starts = csr.vptr[front]
        counts = csr.vptr[front + 1] - starts
        total = int(counts.sum())
        segptr = np.zeros(front.size + 1, np.int64)
        np.cumsum(counts, out=segptr[1:])
        rows = (np.arange(total, dtype=np.int64)
                - np.repeat(segptr[:-1], counts) + np.repeat(starts, counts))
        # t_uv at this ts for the frontier's pair rows only
        pos = np.searchsorted(packed, rows * stride + ts)
        tuv = np.full(total, inf_new, np.int64)
        valid = pos < rowend[rows]
        tuv[valid] = csr.tsorted[pos[valid]]
        dstv = csr.dst[rows].astype(np.int64)
        base = np.repeat(np.arange(front.size, dtype=np.int64), counts) * S
        segbase = np.arange(front.size, dtype=np.int64) * S
        sel = segptr[:-1] + (k - 1)
        val = vct[ts].astype(np.int64)    # known + settled-INF constants
        c = np.maximum(carry[front].astype(np.int64), t_old + 1)
        while True:
            val[front] = c
            key = base + np.maximum(tuv, val[dstv])
            key.sort()
            cnt = np.searchsorted(key, segbase + c + 1) - segptr[:-1]
            if bool(((cnt >= k) | (c >= inf_new)).all()):
                break
            c_new = key[sel] % S          # k-th smallest per segment
            np.minimum(c_new, inf_new, out=c_new)
            np.maximum(c, c_new, out=c)
        vct[ts, front] = c.astype(np.int32)
        carry = vct[ts]
    return vct


def _extend_records(g: TemporalGraph, prev: CoreTimeTable,
                    vct: np.ndarray) -> CoreTimeTable:
    """The interval recompress: the new epoch's table from the old one's
    records (kept verbatim) and the new epoch's (t_new+1, n) vertex core
    times, whichever engine swept them.

    Per vertex, the cells whose CT flipped old-INF -> new-finite form one
    ts-interval [s_v, L_v] (both signals are monotone in ts): s_v = first
    old-INF row, L_v = last new-finite row. A new record of an old edge
    lives only where an endpoint flipped; appended edges are all-new over
    [1, t(e)]. Flatten those per-edge intervals and run-detect over them."""
    t_old, t_new = prev.t_max, g.t_max
    m_old, m_new = prev.m, g.m
    inf_new = t_new + 1
    vo = prev.vertex_ct
    s_v = (vo[1:] <= t_old).sum(axis=0).astype(np.int64) + 1
    L_v = (vct[1:] <= t_new).sum(axis=0).astype(np.int64)
    eu = g.src.astype(np.int64)
    ev = g.dst.astype(np.int64)
    te_e = g.t.astype(np.int64)
    # old edges: union of the two endpoint intervals, clipped to [1, t(e)]
    a1 = np.maximum(s_v[eu[:m_old]], 1)
    b1 = np.minimum(L_v[eu[:m_old]], te_e[:m_old])
    a2 = np.maximum(s_v[ev[:m_old]], 1)
    b2 = np.minimum(L_v[ev[:m_old]], te_e[:m_old])
    swap = a2 < a1
    a1s, a2s = np.where(swap, a2, a1), np.where(swap, a1, a2)
    b1s, b2s = np.where(swap, b2, b1), np.where(swap, b1, b2)
    merged = a2s <= b1s + 1                     # touching/overlapping
    lo_a = a1s
    hi_a = np.where(merged, np.maximum(b1s, b2s), b1s)
    lo_b = np.where(merged, 1, a2s)             # second piece (if distinct)
    hi_b = np.where(merged, 0, b2s)
    # appended edges: one full piece [1, t(e)]
    app = np.arange(m_old, m_new, dtype=np.int64)
    piece_e = np.concatenate([np.arange(m_old, dtype=np.int64)] * 2 + [app])
    piece_lo = np.concatenate([lo_a, lo_b, np.ones(app.size, np.int64)])
    piece_hi = np.concatenate([hi_a, hi_b, te_e[app]])
    keep_p = piece_lo <= piece_hi
    piece_e, piece_lo, piece_hi = piece_e[keep_p], piece_lo[keep_p], piece_hi[keep_p]
    lens = piece_hi - piece_lo + 1
    total_cells = int(lens.sum())
    if total_cells == 0:
        new_e = new_f = new_t = new_c = np.zeros(0, np.int64)
    else:
        # order pieces by (edge, ts) so runs are contiguous per edge
        po = np.lexsort((piece_lo, piece_e))
        piece_e, piece_lo, lens = piece_e[po], piece_lo[po], lens[po]
        pp = np.zeros(piece_e.size + 1, np.int64)
        np.cumsum(lens, out=pp[1:])
        flat_ts = (np.arange(total_cells, dtype=np.int64)
                   - np.repeat(pp[:-1], lens) + np.repeat(piece_lo, lens))
        flat_e = np.repeat(piece_e, lens)
        cu = vct[flat_ts, eu[flat_e]].astype(np.int64)
        cv = vct[flat_ts, ev[flat_e]].astype(np.int64)
        cval = np.maximum(np.maximum(cu, cv), te_e[flat_e])
        np.minimum(cval, inf_new, out=cval)
        # run boundaries: edge change, ts gap, or value change
        brk = np.ones(total_cells, bool)
        brk[1:] = ((flat_e[1:] != flat_e[:-1])
                   | (flat_ts[1:] != flat_ts[:-1] + 1)
                   | (cval[1:] != cval[:-1]))
        sidx = np.flatnonzero(brk)
        eidx = np.empty_like(sidx)
        eidx[:-1] = sidx[1:] - 1
        eidx[-1] = total_cells - 1
        fin = cval[sidx] < inf_new
        sidx, eidx = sidx[fin], eidx[fin]
        new_e, new_f = flat_e[sidx], flat_ts[sidx]
        new_t, new_c = flat_ts[eidx], cval[sidx]
    edge_id = np.concatenate([prev.edge_id.astype(np.int64), new_e])
    ts_from = np.concatenate([prev.ts_from.astype(np.int64), new_f])
    ts_to = np.concatenate([prev.ts_to.astype(np.int64), new_t])
    ct = np.concatenate([prev.ct.astype(np.int64), new_c])
    order = np.lexsort((ts_from, edge_id))
    return _as_table(g, edge_id[order], ts_from[order], ts_to[order],
                     ct[order], vct)


def extend_core_times(g: TemporalGraph, k: int, prev: CoreTimeTable, *,
                      engine: str = "auto", device="cuda") -> CoreTimeTable:
    """Extend a core-time table after a suffix append (streaming epochs).

    ``g`` must be a suffix extension of the graph ``prev`` was built for
    (``TemporalGraph.extend``): the old edges are a prefix of ``g``'s
    arrays and every appended timestamp exceeds ``prev.t_max``. The result
    is **bit-identical** to ``edge_core_times(g, k)`` (test-asserted), and
    recomputes only what a suffix append can change:

    * **Finite old entries are final.** For ``te <= t_old`` the window
      ``[ts, te]`` contains no appended edge, so its k-core — and hence
      any vertex core time that was ``<= t_old`` — is unchanged. Only
      entries that were INF in the old epoch can move (into
      ``(t_old, t_new]``, or to the new INF).
    * **The new vertex rows** come from the chosen engine. ``"host"`` runs
      the reference's algorithm: new start times see only the suffix, so
      their rows come from one ordinary sweep over the (timestamp-shifted)
      suffix subgraph; old start times run a frontier fixpoint that
      re-solves only vertices whose old entry was INF *and* whose entry
      at ts-1 is still finite (column monotonicity), from the lower bound
      ``max(c[ts-1], t_old + 1)``, with every other vertex pinned. The
      ``"device"`` engine sweeps the whole new graph on ``device`` (the
      cold build's launches): since the least fixpoint is unique and the
      finite old entries are final, its rows equal the host's.
    * **Interval recompress** (`_extend_records`). Every previous record
      is kept verbatim, and *new* records are detected only over the
      cells that can hold one: a cell ``(e, ts)`` grows a record iff an
      endpoint's vertex core time flipped from old-INF to new-finite
      there, and by column monotonicity those cells form one ts-interval
      per vertex (``[first old-INF, last new-finite]``). Runs never
      straddle the interval boundary (values change from ``<= t_old`` to
      ``> t_old`` across it), so run detection over the flattened
      per-edge interval union is exact.

    The same epoch (nothing appended) returns ``prev`` itself; an empty
    old epoch builds cold.
    """
    eng = _extend_engine(engine, device)
    if _check_extend(g, prev):
        return prev                       # no appended edges: same epoch
    if eng == "host":
        if prev.m == 0 or prev.t_max == 0:
            return _compress(g, _sweep_host(g, k))  # nothing to extend from
        return _extend_records(g, prev, _extend_rows_host(g, k, prev))
    vct = _sweep_device(g, k, device=device)
    if prev.m == 0 or prev.t_max == 0:
        return _compress(g, vct)
    return _extend_records(g, prev, vct)


# ----------------------------------------------------------------------
# Retention plane: prefix expiry for sliding-window epochs
# ----------------------------------------------------------------------

def shrink_core_times(g: TemporalGraph, k: int,
                      prev: CoreTimeTable) -> CoreTimeTable:
    """Shrink a core-time table after prefix expiry (sliding-window epochs).

    ``g`` must be the shifted epoch ``old_graph.expire_before(t_cut)`` of
    the graph ``prev`` was built for: edges with timestamp ``< t_cut``
    dropped, survivors shifted by ``shift = t_cut - 1`` and renumbered by
    ``-cut`` (the expired edge count). The result is **bit-identical** to
    ``edge_core_times(g, k)`` (test-asserted) at pure-slicing cost,
    because of the *cut invariant*:

        every surviving start time ``ts >= t_cut`` projects a window
        ``[ts, te] ⊆ [ts, t_max]`` whose edges all have ``t >= ts >=
        t_cut`` — no expired edge can appear in it.

    So no vertex needs re-solving: the k-core of every surviving window
    is untouched, and the whole table reduces by relabeling —

    * **vertex rows**: new row ``ts`` = old row ``ts + shift``, finite
      values shifted down, old-INF (``t_old + 1``) mapped to new-INF.
    * **version records die or clip, never change.** A record survives
      iff its start-time interval reaches the cut (``ts_to >= t_cut``);
      a surviving record keeps its core time (shifted) with ``ts_from``
      clipped to the cut. Clipping cannot merge runs (run values are
      constant and maximal already) and preserves the ``(edge_id,
      ts_from)`` sort, so the record stream needs no re-sort and no
      re-run-detection. Records of expired edges always die: their
      intervals end at ``ts_to <= t(e) < t_cut``.

    Raises ``ValueError`` when ``(g, prev)`` is not a consistent
    prefix-expiry pair, so a wrong table is never produced silently.
    """
    shift = prev.t_max - g.t_max
    cut_m = prev.m - g.m
    t_cut = shift + 1
    if prev.n != g.n:
        raise ValueError(f"vertex count changed ({prev.n} -> {g.n}); "
                         "shrink_core_times needs the same vertex set")
    if shift < 0 or cut_m < 0:
        raise ValueError("prev table does not describe a supergraph of g "
                         "(shrink goes forward in time; use "
                         "extend_core_times to grow)")
    if shift == 0 and cut_m == 0:
        return prev                       # no cut: same epoch
    if g.m == 0 or g.t_max == 0:
        return _compress(g, _sweep_host(g, k))   # everything expired
    inf_old, inf_new = prev.t_max + 1, g.t_max + 1

    # -- vertex rows: slice + shift, INF remapped -------------------------
    vo = prev.vertex_ct[t_cut:].astype(np.int64)
    vct = np.full((g.t_max + 1, g.n), inf_new, np.int32)
    fin = vo < inf_old
    block = np.full(vo.shape, inf_new, np.int64)
    block[fin] = vo[fin] - shift
    # values are core times bounded by inf_new = g.t_max + 1: int32
    vct[1:] = block.astype(np.int32)  # repro: ignore[int32-narrowing]

    # -- records: drop dead, clip the cut straddlers, shift, renumber -----
    keep = prev.ts_to.astype(np.int64) >= t_cut
    edge_id = prev.edge_id[keep].astype(np.int64) - cut_m
    if edge_id.size and edge_id.min() < 0:
        raise ValueError(
            "a surviving version references an expired edge; prev is not "
            "the table of g's pre-expiry epoch")
    ts_from = np.maximum(prev.ts_from[keep].astype(np.int64), t_cut) - shift
    ts_to = prev.ts_to[keep].astype(np.int64) - shift
    ct = prev.ct[keep].astype(np.int64) - shift
    return _as_table(g, edge_id, ts_from, ts_to, ct, vct)


# ----------------------------------------------------------------------
# K-stratified epochs: one call covers every stratum
# ----------------------------------------------------------------------

def extend_stratified_core_times(g: TemporalGraph, prev: StratifiedCoreTable,
                                 ks=None, *, engine: str = "auto",
                                 device="cuda") -> StratifiedCoreTable:
    """Suffix-append epoch for every stratum at once: existing strata are
    extended (bit-identical incremental, see `extend_core_times`), strata
    newly requested via ``ks`` (e.g. the appended edges raised k_max) are
    built cold. ``ks`` defaults to ``prev.ks``.

    The ``"device"`` engine sweeps every stratum that needs rows, old and
    new, in one `_sweep_device_stratified` call (one `stratum_sweep`
    launch per t_uv block); the ``"host"`` engine extends stratum by
    stratum as the reference does. Both return bit-identical tables."""
    ks = _validate_ks(prev.ks if ks is None else ks)
    eng = _extend_engine(engine, device)
    if eng == "host":
        tables = [extend_core_times(g, k, prev.table_for(k), engine="host")
                  if k in prev.ks else _compress(g, _sweep_host(g, k))
                  for k in ks]
        return StratifiedCoreTable.from_tables(g, ks, tables)
    # the host path's checks, raised under the same conditions
    same = any(k in prev.ks for k in ks) and _check_extend(g, prev)
    sweep = [k for k in ks if k not in prev.ks or not same]
    rows = dict(zip(sweep, _sweep_device_stratified(g, sweep,
                                                    device=device)))
    cold = prev.m == 0 or prev.t_max == 0
    tables = []
    for k in ks:
        if k in prev.ks and same:
            tables.append(prev.table_for(k))
        elif k in prev.ks and not cold:
            tables.append(_extend_records(g, prev.table_for(k), rows[k]))
        else:
            tables.append(_compress(g, rows[k]))
    return StratifiedCoreTable.from_tables(g, ks, tables)


def shrink_stratified_core_times(g: TemporalGraph, prev: StratifiedCoreTable,
                                 ks=None) -> StratifiedCoreTable:
    """Prefix-expiry epoch for every stratum at once (see
    `shrink_core_times`); ``ks`` defaults to ``prev.ks`` and may drop
    strata (expiry can lower k_max) but must not add any."""
    ks = _validate_ks(prev.ks if ks is None else ks)
    missing = [k for k in ks if k not in prev.ks]
    if missing:
        raise ValueError(f"shrink cannot add strata {missing}; "
                         "build them cold instead")
    return StratifiedCoreTable.from_tables(
        g, ks, [shrink_core_times(g, k, prev.table_for(k)) for k in ks])


# ----------------------------------------------------------------------
# Brute-force oracle (tests only): CT by scanning te for each (ts, e).
# ----------------------------------------------------------------------

def edge_core_time_naive(g: TemporalGraph, k: int, ts: int) -> np.ndarray:
    """int64[m] CT(e)_ts by recomputing the k-core for every te."""
    from .kcore import kcore_edge_mask

    INF = g.t_max + 1
    out = np.full(g.m, INF, np.int64)
    for te in range(ts, g.t_max + 1):
        s, d, ids = g.project(ts, te)
        if ids.size == 0:
            continue
        # distinct-neighbour degrees: collapse parallel edges for peeling
        key = np.minimum(s, d).astype(np.int64) * g.n + np.maximum(s, d)
        uniq, inv = np.unique(key, return_inverse=True)
        us, ud = (uniq // g.n).astype(np.int64), (uniq % g.n).astype(np.int64)
        alive_simple = kcore_edge_mask(us, ud, g.n, k)
        alive = alive_simple[inv]
        newly = ids[alive]
        out[newly] = np.minimum(out[newly], te)
    return out
