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
from ._args import cuda_only, int32_vector
from ._build import build_cuda

_SRC = Path(__file__).resolve().parent / "csrc" / "segmented_count_le.cu"

#: H100 SXM device-memory rate, bytes/s (the bound's denominator)
HBM_BYTES_PER_S = 3.35e12


@functools.cache
def _library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("segmented_count_le", [_SRC])
    lib = ctypes.CDLL(str(so))
    fn = lib.segmented_count_le_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
    return lib, so


def build() -> Path:
    """Build B2's library (if needed) and load it; returns its path."""
    return _library()[1]


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
    segmented_count_le.launches += 1
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
