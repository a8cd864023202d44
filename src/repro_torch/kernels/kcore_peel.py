"""B3: the k-core peel on the card, as hand-written CUDA kernels.

Replaces the TPU kernels of ``src/repro/kernels/kcore_peel.py`` and the
reference's fixpoint over them (``src/repro/kernels/ref.py:33``):

* :func:`kcore_fixpoint` — B3 redesigned for Hopper: a whole peel
  fixpoint (every round) as one cooperative launch of
  ``csrc/kcore_fixpoint.cu``, with no host read between rounds. It is
  the peel's kernel; B3a and B3b stay as the Pallas functions'
  counterparts, off the fixpoint path. Bound by memory (:func:`fixpoint_bound_ms`) but
  latency-bound in practice: its serial chain is the rounds;
* B3a :func:`degree_count` (``:62``, Pallas body ``_degree_kernel``): the
  alive-weighted degree of every vertex, counting both endpoints;
* B3b :func:`peel_threshold` (the ``_threshold_kernel`` half of
  ``peel_round``, ``:117``): the new alive mask
  ``alive > 0 & deg[src] >= k & deg[dst] >= k``, with an int32 change
  flag like B1's.

:func:`peel_round` launches B3a then B3b, as the reference does. The CUDA
source ``csrc/kcore_peel.cu`` states their design: one thread per edge,
integer atomics for the degrees. Both are bound by memory, a few bytes per
edge and per vertex (:func:`degree_bound_ms`, :func:`threshold_bound_ms`),
well under a microsecond at the CollegeMsg scale, so each launch costs its
overhead.

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
from ._args import count_launch, plain, cuda_only, flag, int32_vector
from ._build import build_cuda
from .contracts import ANY_INT, INT32, INT_OR_BOOL, ArraySpec, kernel_contract

#: the edges every peel wrapper takes (cast to the kernels' int32) and
#: their alive mask (bool) or integer weights (cast to int32)
_EDGES = {"src": ArraySpec(("E",), ANY_INT), "dst": ArraySpec(("E",), ANY_INT)}

_CSRC = Path(__file__).resolve().parent / "csrc"
_SRC = _CSRC / "kcore_peel.cu"
_FIXPOINT_SRC = _CSRC / "kcore_fixpoint.cu"

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


@functools.cache
def _fixpoint_library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("kcore_fixpoint", [_FIXPOINT_SRC])
    lib = ctypes.CDLL(str(so))
    fn = lib.kcore_fixpoint_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_void_p]
    blocks = lib.kcore_fixpoint_grid_blocks
    blocks.restype = ctypes.c_int
    blocks.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    return lib, so


def build() -> Path:
    """Build the B3a/B3b library (if needed) and load it; returns its
    path."""
    return _library()[1]


def build_fixpoint() -> Path:
    """Build the fixpoint kernel's library (if needed) and load it;
    returns its path."""
    return _fixpoint_library()[1]


def degree_bound_ms(m: int, n: int, alive_bytes: int = 1) -> float:
    """Least time of one B3a launch on an H100: src, dst and alive read
    once per edge, deg written once per vertex, over the memory rate."""
    return ((8 + alive_bytes) * m + 4 * n) / HBM_BYTES_PER_S * 1e3


def threshold_bound_ms(m: int, n: int, alive_bytes: int = 1) -> float:
    """Least time of one B3b launch on an H100: src, dst and alive read
    and the one-byte mask written once per edge, deg read once per
    vertex, over the memory rate."""
    return ((9 + alive_bytes) * m + 4 * n) / HBM_BYTES_PER_S * 1e3


def fixpoint_bound_ms(m: int, alive_bytes: int = 0) -> float:
    """Least time of one :func:`kcore_fixpoint` launch on an H100: src and
    dst read once (8 B per edge), ``alive0`` read once (``alive_bytes``
    per edge: 0 when it is None, 1 for bool, 4 for int32), the one-byte
    mask and the 4-byte round count written once, over the memory rate.
    The degrees are the kernel's scratch, not the function's operands."""
    return ((9 + alive_bytes) * m + 4) / HBM_BYTES_PER_S * 1e3


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


@kernel_contract(
    in_specs={**_EDGES, "alive": ArraySpec(("E",), INT_OR_BOOL)},
    out_specs=ArraySpec(("n",), INT32),
    smem_bound=lambda v: 0)
def degree_count(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
                 n: int) -> torch.Tensor:
    """B3a: int32[n] alive-weighted degrees (both endpoints; ids outside
    ``[0, n)`` count nothing). ``degree_count.launches`` counts kernel
    launches (CPU calls and empty shapes launch nothing)."""
    src, dst, alive = _edges(src, dst, alive)
    if plain(src.device):
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
    count_launch(degree_count)
    return deg


degree_count.launches = 0


@kernel_contract(
    in_specs={**_EDGES, "alive": ArraySpec(("E",), INT_OR_BOOL),
              "deg": ArraySpec(("n",), ANY_INT),
              "changed": ArraySpec((1,), INT32)},
    out_specs=ArraySpec(("E",), ("bool",)),
    smem_bound=lambda v: 0)
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
    if plain(src.device):
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
    count_launch(peel_threshold)
    return out


peel_threshold.launches = 0


def peel_round(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
               n: int, k: int, *, changed: torch.Tensor) -> torch.Tensor:
    """One peel round, B3a then B3b: the new alive mask (bool[m]);
    ``changed`` as in :func:`peel_threshold`."""
    deg = degree_count(src, dst, alive, n)
    return peel_threshold(src, dst, alive, deg, k, changed=changed)


@kernel_contract(
    in_specs={**_EDGES, "alive0": ArraySpec(("E",), INT_OR_BOOL),
              "rounds": ArraySpec((1,), INT32)},
    out_specs=ArraySpec(("E",), ("bool",)),
    smem_bound=lambda v: 0)
def kcore_fixpoint(src: torch.Tensor, dst: torch.Tensor, n: int, k: int,
                   alive0: torch.Tensor | None = None, *,
                   rounds: torch.Tensor | None = None) -> torch.Tensor:
    """bool[m] k-core edge mask: peel rounds until none changes, the
    plain version ``ref.kcore_fixpoint`` (parallel edges each count toward
    a degree, a self-loop twice; ``alive0``, default every edge alive, is a
    bool or integer weight, counted in round 1 only).

    CUDA tensors launch ``csrc/kcore_fixpoint.cu`` once, every round on
    the card and no host synchronisation; a refused cooperative launch
    raises. ``rounds`` (int32[1] on the edges' device), when given,
    receives the number of rounds, the last one (where nothing dies)
    included, as the plain loop counts them. ``kcore_fixpoint.launches``
    counts launches (CPU calls launch nothing)."""
    src = int32_vector("src", src)
    dst = int32_vector("dst", dst, src.shape[0], src.device)
    m, device = src.shape[0], src.device
    if alive0 is not None:
        alive0 = _alive(alive0, m, device)
    if rounds is not None and (rounds.dtype != torch.int32
                               or rounds.shape != (1,)
                               or rounds.device != device):
        raise ValueError(f"rounds must be an int32[1] tensor on {device}")
    if not 0 <= n < 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"the fixpoint takes 0 <= n < 2^31 and m < 2^31, "
                         f"got n = {n}, m = {m}")
    if plain(device):
        return ref.kcore_fixpoint(src, dst, n, k, alive0, rounds=rounds)
    cuda_only(device, "kcore_fixpoint")
    out = torch.empty(m, dtype=torch.bool, device=device)
    if rounds is None:
        rounds = torch.empty(1, dtype=torch.int32, device=device)
    scratch = torch.empty(2 * n + 1, dtype=torch.int32, device=device)
    k = max(min(int(k), 2**63 - 1), -2**63)     # compared in int64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fixpoint_library()[0].kcore_fixpoint_launch(
            src.data_ptr(), dst.data_ptr(),
            None if alive0 is None else alive0.data_ptr(),
            0 if alive0 is None else alive0.element_size(), out.data_ptr(),
            rounds.data_ptr(), scratch.data_ptr(), m, n, k, stream)
    if rc:
        raise RuntimeError(f"kcore_fixpoint launch failed: CUDA error {rc}")
    count_launch(kcore_fixpoint)
    return out


kcore_fixpoint.launches = 0


def grid_blocks(m: int, n: int, alive_bytes: int = 0) -> int:
    """Blocks of 1,024 threads that :func:`kcore_fixpoint` launches for m
    edges and n vertices on the current card: one thread per edge or
    vertex, capped at the blocks the card holds at once. Needs the card."""
    blocks = _fixpoint_library()[0].kcore_fixpoint_grid_blocks(
        m, n, alive_bytes)
    if blocks < 0:
        raise RuntimeError(f"kcore_fixpoint_grid_blocks: CUDA error "
                           f"{-blocks}")
    return blocks
