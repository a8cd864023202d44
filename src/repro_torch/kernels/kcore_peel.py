"""B3a and B3b: one k-core peel round, as hand-written CUDA kernels.

Replaces the TPU kernels of ``src/repro/kernels/kcore_peel.py``:

* B3a :func:`degree_count` (``:62``, Pallas body ``_degree_kernel``): the
  alive-weighted degree of every vertex, counting both endpoints;
* B3b :func:`peel_threshold` (the ``_threshold_kernel`` half of
  ``peel_round``, ``:117``): the new alive mask
  ``alive > 0 & deg[src] >= k & deg[dst] >= k``, with an int32 change
  flag like B1's so that :func:`kcore_fixpoint` loops on the device with
  one flag read per round.

:func:`peel_round` launches B3a then B3b, as the reference does. The CUDA
source (``csrc/kcore_peel.cu``) states the design: one thread per edge,
integer atomics for the degrees. Both kernels are bound by memory, a few
bytes per edge and per vertex (:func:`degree_bound_ms`,
:func:`threshold_bound_ms`), well under a microsecond at the CollegeMsg
scale, so each launch costs its overhead.

Dispatch is by the tensors' device: CUDA tensors launch the kernels
(built with nvcc at first use, loaded with ctypes), CPU tensors take the
plain versions in ``ref.py``. There is no fallback: a missing nvcc, a
failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from . import ref
from ._args import cuda_only, flag, int32_vector
from ._build import build_cuda

_SRC = Path(__file__).resolve().parent / "csrc" / "kcore_peel.cu"

#: H100 SXM device-memory rate, bytes/s (the bound's denominator)
HBM_BYTES_PER_S = 3.35e12


@functools.cache
def _library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("kcore_peel", [_SRC])
    lib = ctypes.CDLL(str(so))
    deg = lib.degree_count_launch
    deg.restype = ctypes.c_int
    deg.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_void_p]
    thr = lib.peel_threshold_launch
    thr.restype = ctypes.c_int
    thr.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    return lib, so


def build() -> Path:
    """Build the B3 library (if needed) and load it; returns its path."""
    return _library()[1]


def degree_bound_ms(m: int, n: int, alive_bytes: int = 1) -> float:
    """Least time of one B3a launch on an H100: src, dst and alive read
    once per edge, deg written once per vertex, over the memory rate."""
    return ((8 + alive_bytes) * m + 4 * n) / HBM_BYTES_PER_S * 1e3


def threshold_bound_ms(m: int, n: int, alive_bytes: int = 1) -> float:
    """Least time of one B3b launch on an H100: src, dst and alive read
    and the one-byte mask written once per edge, deg read once per
    vertex, over the memory rate."""
    return ((9 + alive_bytes) * m + 4 * n) / HBM_BYTES_PER_S * 1e3


def _alive(alive: torch.Tensor, m: int, device) -> torch.Tensor:
    """``alive`` as the kernels take it: bool as is, other integers as
    int32 weights."""
    if alive.dtype != torch.bool:
        alive = int32_vector("alive", alive)
    if alive.shape != (m,) or alive.device != device:
        raise ValueError(f"alive must be a length-{m} vector on {device}, "
                         f"got {tuple(alive.shape)} on {alive.device}")
    if not alive.is_contiguous():
        raise ValueError("alive must be contiguous")
    return alive


def _edges(src, dst, alive):
    src = int32_vector("src", src)
    dst = int32_vector("dst", dst, src.shape[0], src.device)
    return src, dst, _alive(alive, src.shape[0], src.device)


def degree_count(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
                 n: int) -> torch.Tensor:
    """B3a: int32[n] alive-weighted degrees (both endpoints; ids outside
    ``[0, n)`` count nothing). ``degree_count.launches`` counts kernel
    launches (CPU calls and empty shapes launch nothing)."""
    src, dst, alive = _edges(src, dst, alive)
    if src.device.type == "cpu":
        return ref.degree_count(src, dst, alive, n)
    cuda_only(src.device, "degree_count")
    m = src.shape[0]
    if n == 0 or m == 0:
        return torch.zeros(n, dtype=torch.int32, device=src.device)
    deg = torch.empty(n, dtype=torch.int32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library()[0].degree_count_launch(
            src.data_ptr(), dst.data_ptr(), alive.data_ptr(),
            alive.element_size(), deg.data_ptr(), m, n, stream)
    if rc:
        raise RuntimeError(f"degree_count launch failed: CUDA error {rc}")
    degree_count.launches += 1
    return deg


degree_count.launches = 0


def peel_threshold(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
                   deg: torch.Tensor, k: int, *,
                   changed: torch.Tensor) -> torch.Tensor:
    """B3b: bool[m] ``alive > 0 & deg[src] >= k & deg[dst] >= k`` (an
    endpoint outside ``[0, len(deg))`` fails). ``changed`` (int32[1]) is
    set to 1 when the mask differs from ``alive > 0`` and left untouched
    otherwise: the caller zeroes it. ``peel_threshold.launches`` counts
    kernel launches."""
    src, dst, alive = _edges(src, dst, alive)
    deg = int32_vector("deg", deg, device=src.device)
    flag(changed, src.device)
    n, m = deg.shape[0], src.shape[0]
    if src.device.type == "cpu":
        out = ref.peel_threshold(src, dst, alive, deg, k)
        if bool((out != (alive > 0)).any()):
            changed.fill_(1)
        return out
    cuda_only(src.device, "peel_threshold")
    out = torch.empty(m, dtype=torch.bool, device=src.device)
    if m == 0:
        return out
    if n == 0:                  # every endpoint is out of range: all die
        changed.copy_(torch.maximum(
            changed, (alive > 0).any().to(torch.int32).reshape(1)))
        return out.zero_()
    k = max(min(int(k), 2**31 - 1), -2**31)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library()[0].peel_threshold_launch(
            src.data_ptr(), dst.data_ptr(), alive.data_ptr(),
            alive.element_size(), deg.data_ptr(), out.data_ptr(),
            changed.data_ptr(), m, n, k, stream)
    if rc:
        raise RuntimeError(f"peel_threshold launch failed: CUDA error {rc}")
    peel_threshold.launches += 1
    return out


peel_threshold.launches = 0


def peel_round(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
               n: int, k: int, *, changed: torch.Tensor) -> torch.Tensor:
    """One peel round, B3a then B3b: the new alive mask (bool[m]);
    ``changed`` as in :func:`peel_threshold`."""
    deg = degree_count(src, dst, alive, n)
    return peel_threshold(src, dst, alive, deg, k, changed=changed)


def kcore_fixpoint(src: torch.Tensor, dst: torch.Tensor, n: int, k: int,
                   alive0: torch.Tensor | None = None) -> torch.Tensor:
    """bool[m] k-core edge mask: peel rounds on the tensors' device until
    none changes, one read of the change flag per round (the reference's
    ``ref.kcore_fixpoint``; parallel edges each count toward a degree).
    ``alive0`` defaults to every edge alive."""
    alive = (torch.ones(src.shape, dtype=torch.bool, device=src.device)
             if alive0 is None else alive0)
    changed = torch.zeros(1, dtype=torch.int32, device=src.device)
    while True:
        changed.zero_()
        new = peel_round(src, dst, alive, n, k, changed=changed)
        if not int(changed.item()):
            return new
        alive = new
