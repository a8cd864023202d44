"""Segmented k-th-smallest selection over CSR segments, and B2.

The construction sweep's inner op: for every segment (one vertex's
incident pair slots) select the k-th smallest slot value with a floor
``lo``, so the caller gets ``max(lo, kth)`` directly (the clamped fixpoint
update of ``core_time``). Values live in ``[0, inf_value]``, so the k-th
smallest is the least ``x`` with ``|{i in seg : w_i <= x}| >= k``: a
*counting bisection*, where each step needs only a segmented count.

PyTorch port of ``repro.kernels.segmented_select``:

* :func:`count_le_csr` / :func:`kth_smallest_csr` — plain PyTorch over
  contiguous CSR segments (a cumsum and two gathers);
* :func:`segmented_count_le` — B2, the hand-written CUDA kernel
  (``csrc/segmented_count_le.cu``; replaces the Pallas kernel of
  ``src/repro/kernels/segmented_select.py:117``). CUDA tensors launch it,
  CPU tensors take the plain version ``ref.segmented_count_le``. It is
  bound by memory, ``8 * E + 8 * n`` bytes (:func:`bound_ms`), about
  0.1 us at the sweep's shape, so each launch costs its overhead;
* :func:`kth_smallest` — the counterpart of ``kth_smallest_pallas``: a
  host-driven bisection with B2 as its inner op, one launch per step;
* :func:`stratum_sweep` — B2 redesigned for Hopper: the whole k-stratified
  core-time sweep over one block of start times (every probe and every
  climb of every stratum) as one launch of a hand-written CUDA kernel
  (``csrc/stratum_sweep.cu``; replaces the reference's scan
  ``src/repro/core/core_time.py:346`` and the Pallas counter it drives).
  It is the construction's kernel: B2 and B2' stay as the counterparts of
  the Pallas functions, off the build path. CPU tensors take the plain
  version ``ref.stratum_sweep``. Bound by memory (:func:`sweep_bound_ms`)
  but latency-bound in practice: its serial chain is the longest
  stratum's probes;
* :func:`segmented_kth_smallest_np` — the numpy reference.

There is no fallback: a missing nvcc, a failed build or a refused launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from . import ref
from ._args import count_launch, cuda_only, int32_array, int32_vector
from ._build import build_cuda

_CSRC = Path(__file__).resolve().parent / "csrc"
_SRC = _CSRC / "segmented_count_le.cu"
_SWEEP_SRC = _CSRC / "stratum_sweep.cu"

#: H100 SXM device-memory rate, bytes/s (the bound's denominator)
HBM_BYTES_PER_S = 3.35e12
#: shared memory one block may use on an H100 (227 KB): the sweep keeps its
#: two int32 buffers of c there while 8 * n bytes fit
SMEM_PER_BLOCK = 232_448
#: the sweep's two routes for c, by size
SWEEP_ROUTES = ("shared", "global")


@functools.cache
def _library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("segmented_count_le", [_SRC])
    lib = ctypes.CDLL(str(so))
    fn = lib.segmented_count_le_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
    return lib, so


@functools.cache
def _sweep_library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("stratum_sweep", [_SWEEP_SRC])
    lib = ctypes.CDLL(str(so))
    fn = lib.stratum_sweep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 2 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib, so


def build() -> Path:
    """Build B2's library (if needed) and load it; returns its path."""
    return _library()[1]


def build_sweep() -> Path:
    """Build the stratum sweep's library (if needed) and load it; returns
    its path."""
    return _sweep_library()[1]


def bound_ms(E: int, n: int) -> float:
    """Least time one B2 launch can take on an H100: each slot's ``w`` and
    ``seg`` read once (8 B), each segment's threshold read once and count
    written once (8 B), over the memory rate. One compare and one add per
    slot are far below the compute roof, so bytes bound it."""
    return (8 * E + 8 * n) / HBM_BYTES_PER_S * 1e3


def segmented_count_le(w: torch.Tensor, seg: torch.Tensor, thr: torch.Tensor,
                       n: int) -> torch.Tensor:
    """int32[n]: per segment ``v``, the count of slots with ``seg == v``
    and ``w <= thr[v]``; ``seg`` need not be sorted and ids outside
    ``[0, n)`` count nothing. Integer operands are cast to int32, as the
    reference casts them. ``segmented_count_le.launches`` counts kernel
    launches (CPU calls and empty shapes launch nothing)."""
    w = int32_vector("w", w)
    seg = int32_vector("seg", seg, w.shape[0], w.device)
    thr = int32_vector("thr", thr, n, w.device)
    if w.device.type == "cpu":
        return ref.segmented_count_le(w, seg, thr, n)
    cuda_only(w.device, "segmented_count_le")
    E = w.shape[0]
    if n == 0 or E == 0:
        return torch.zeros(n, dtype=torch.int32, device=w.device)
    out = torch.empty(n, dtype=torch.int32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library()[0].segmented_count_le_launch(
            w.data_ptr(), seg.data_ptr(), thr.data_ptr(), out.data_ptr(),
            E, n, stream)
    if rc:
        raise RuntimeError(f"segmented_count_le launch failed: CUDA error {rc}")
    count_launch(segmented_count_le)
    return out


segmented_count_le.launches = 0


def count_le_csr(w: torch.Tensor, thr: torch.Tensor, seg: torch.Tensor,
                 vptr: torch.Tensor) -> torch.Tensor:
    """int32[n] per-segment count of ``w[i] <= thr[seg[i]]`` for CSR
    segments (``seg`` non-decreasing, delimited by ``vptr``): a cumsum and
    two boundary gathers, no scatter."""
    x = (w <= thr[seg.long()]).to(torch.int64)
    s = torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])
    vptr = vptr.long()
    return (s[vptr[1:]] - s[vptr[:-1]]).to(torch.int32)


def _bisect(count, lo: torch.Tensor, k: int, inf_value: int,
            steps: int) -> torch.Tensor:
    """Counting bisection over ``[lo, inf_value]``: ``count(thr)`` gives
    the per-segment number of slots ``<= thr``. Same update and clamp as
    the reference (``segmented_select.py:60-81``)."""
    lo = lo.to(torch.int32)
    hi = torch.full_like(lo, inf_value)
    for _ in range(steps):
        mid = (lo + hi) // 2
        ge = count(mid) >= k
        lo, hi = (torch.where(ge | (lo >= hi), lo, mid + 1),
                  torch.where(ge & (lo < hi), mid, hi))
    return torch.clamp(lo, max=inf_value)


def kth_smallest_csr(w: torch.Tensor, lo: torch.Tensor, k: int,
                     inf_value: int, steps: int, seg: torch.Tensor,
                     vptr: torch.Tensor, count_fn=count_le_csr) -> torch.Tensor:
    """Per-segment ``max(lo, k-th smallest of w)`` clamped to
    ``inf_value``; ``steps`` must be >= ceil(log2(inf_value + 1)).
    Segments with fewer than k qualifying slots resolve to ``inf_value``."""
    return _bisect(lambda thr: count_fn(w, thr, seg, vptr), lo, k, inf_value,
                   steps)


def bisection_steps(inf_value: int) -> int:
    """Steps of :func:`kth_smallest`: ``ceil(log2(inf + 1)) + 1``, 1 when
    ``inf_value == 0`` (``kth_smallest_pallas``)."""
    return int(np.ceil(np.log2(inf_value + 1))) + 1 if inf_value > 0 else 1


def kth_smallest(w: torch.Tensor, seg: torch.Tensor, n: int, k: int,
                 inf_value: int, *, lo: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Per-segment clamped k-th smallest with B2 as the bisection's inner
    op (``kth_smallest_pallas``): a host loop of
    :func:`bisection_steps` launches; ``seg`` need not be sorted."""
    lo = (torch.zeros(n, dtype=torch.int32, device=w.device)
          if lo is None else lo)
    return _bisect(lambda thr: segmented_count_le(w, seg, thr, n), lo, k,
                   inf_value, bisection_steps(inf_value))


def segmented_kth_smallest_np(w: np.ndarray, vptr: np.ndarray, k: int,
                              inf_value: int,
                              lo: np.ndarray | None = None) -> np.ndarray:
    """Reference: per-segment ``max(lo, k-th smallest)`` clamped to
    ``inf_value`` (segments are ``w[vptr[i]:vptr[i+1]]``)."""
    n = vptr.shape[0] - 1
    out = np.full(n, inf_value, np.int64)
    for v in range(n):
        segv = np.sort(w[vptr[v]:vptr[v + 1]])
        if segv.shape[0] >= k:
            out[v] = min(int(segv[k - 1]), inf_value)
    if lo is not None:
        out = np.maximum(out, lo)
    return np.minimum(out, inf_value)


def sweep_route(n: int) -> str:
    """Where the sweep keeps c: ``"shared"`` while its two int32 buffers
    (8 * n bytes) fit one block's shared memory, else ``"global"`` (a
    scratch of 8 * n bytes per stratum in device memory)."""
    return "shared" if 8 * n <= SMEM_PER_BLOCK else "global"


def sweep_bound_ms(K: int, R: int, E: int, n: int) -> float:
    """Least time of one :func:`stratum_sweep` launch on an H100: the t_uv
    block read once (4 * R * E bytes), the rows written once (4 * K * R *
    n), dst and vptr read once (4 * E + 4 * (n + 1)), ks read and carry
    read and written once (4 * K + 8 * K * n), the counts written (16 * K),
    over the memory rate. The compares are integer operations far below any
    compute roof, so bytes bound it."""
    nbytes = (4 * R * E + 4 * K * R * n + 4 * E + 4 * (n + 1) + 4 * K
              + 8 * K * n + 16 * K)
    return nbytes / HBM_BYTES_PER_S * 1e3


def stratum_sweep(tuv: torch.Tensor, seg: torch.Tensor, vptr: torch.Tensor,
                  dst: torch.Tensor, ks: torch.Tensor, carry: torch.Tensor,
                  inf: int, *, out: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every stratum's core-time sweep over one block of start times: for
    stratum ``i`` (``k = ks[i]``) and each row ``r`` of ``tuv`` (R, E) in
    order, the least fixpoint from ``carry[i]`` by probes and clamped
    Jacobi climbs (``csrc/stratum_sweep.cu`` and ``ref.stratum_sweep`` state
    the function), written to ``out[i, r]``.

    ``tuv`` int32 (R, E) is the block of `core_time._tuv_rows` (values in
    ``[0, inf]``); ``seg``, ``vptr`` and ``dst`` the pair CSR over sources
    (``seg`` non-decreasing, ``vptr`` int32[n + 1] from 0 to E); ``ks``
    int32[|K|], each >= 1; ``carry`` int32 (|K|, n), read and updated in
    place. ``out`` (default: a new tensor) is int32 (|K|, R, n) with rows n
    apart, e.g. a slice ``rows[:, ts0:ts1]`` of a (|K|, t_max + 1, n)
    tensor. Returns ``(out, stats)``, ``stats`` int64 (|K|, 2): probes and
    climbs per stratum. ``stratum_sweep.launches`` counts kernel launches
    and ``stratum_sweep.routes`` the same by :func:`sweep_route` (CPU calls
    and empty shapes launch nothing; with no stratum, row or vertex there
    is no probe either)."""
    if tuv.dim() != 2 or carry.dim() != 2:
        raise ValueError(f"tuv (R, E) and carry (|K|, n) must be 2-D, got "
                         f"{tuple(tuv.shape)} and {tuple(carry.shape)}")
    (R, E), (K, n) = tuv.shape, carry.shape
    device = tuv.device
    int32_array("tuv", tuv, (R, E))
    int32_array("carry", carry, (K, n), device)
    seg = int32_vector("seg", seg, E, device)
    dst = int32_vector("dst", dst, E, device)
    vptr = int32_vector("vptr", vptr, n + 1, device)
    ks = int32_vector("ks", ks, K, device)
    if out is None:
        out = torch.empty((K, R, n), dtype=torch.int32, device=device)
    int32_array("out", out, (K, R, n), device)
    if not (tuv.is_contiguous() and carry.is_contiguous()) or (
            out.numel() and (out.stride(2) != 1 or out.stride(1) != n)):
        raise ValueError("tuv and carry must be contiguous, and out's rows "
                         "contiguous and n apart")
    if E >= 2 ** 31 or int(inf) < 1 or int(inf) >= 2 ** 31 - 1:
        raise ValueError(f"the sweep takes E < 2^31 and 1 <= inf < 2^31 - 1, "
                         f"got E = {E}, inf = {inf}")
    if K and int(ks.min()) < 1:
        raise ValueError("every stratum must have k >= 1")
    if int(vptr[0]) != 0 or int(vptr[-1]) != E:
        raise ValueError(f"vptr must run from 0 to E = {E}")
    if K == 0 or R == 0 or n == 0:        # nothing to sweep: no probe
        return out, torch.zeros((K, 2), dtype=torch.int64, device=device)
    if device.type == "cpu":
        return out, ref.stratum_sweep(tuv, seg, vptr, dst, ks, carry,
                                      int(inf), out)
    cuda_only(device, "stratum_sweep")
    stats = torch.empty((K, 2), dtype=torch.int64, device=device)
    route = sweep_route(n)
    scratch = (torch.empty((K, 2, n), dtype=torch.int32, device=device)
               if route == "global" else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _sweep_library()[0].stratum_sweep_launch(
            tuv.data_ptr(), vptr.data_ptr(), dst.data_ptr(), ks.data_ptr(),
            carry.data_ptr(), out.data_ptr(), stats.data_ptr(),
            None if scratch is None else scratch.data_ptr(), E,
            out.stride(0), n, R, K, int(inf), stream)
    if rc:
        raise RuntimeError(f"stratum_sweep launch failed ({route} route): "
                           f"CUDA error {rc}")
    count_launch(stratum_sweep, route)
    return out, stats


def reset_sweep_counts() -> None:
    """Set ``stratum_sweep.launches`` and every count of
    ``stratum_sweep.routes`` to 0."""
    stratum_sweep.launches = 0
    stratum_sweep.routes = dict.fromkeys(SWEEP_ROUTES, 0)


reset_sweep_counts()
