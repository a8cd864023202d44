"""B5, the tiled GEMM ``f32[M, N] = a @ b``, and B4, the segment sum, as
hand-written CUDA kernels.

B5 replaces the TPU kernel ``matmul`` of
``src/repro/kernels/segment_matmul.py:52`` (Pallas body ``_matmul_kernel``):
f32 or bf16 operands, f32 output with f32 accumulation. In the reference no
model path calls it (the projections are ``x @ w``); in the port it is
every dense projection of the LM (``models/transformer.py``: wq/wk/wv/wo,
the FFN's wi/wg/wo and the head) and of GraphSAGE (``models/gnn.py``:
w_self, w_neigh and the head, in f32), with the weight in the reference's
``(d_in, d_out)`` layout, read as it is.

The CUDA source (``csrc/matmul.cu``, with the Hopper helpers of
``csrc/sm90.cuh``) states the design. :func:`plan` picks one of four
routes from the dtype and shape: ``"wgmma"`` (bf16, M > 64: TMA loads into
an mbarrier ring feeding wgmma, 128 x 256 tiles, a persistent grid),
``"skinny"`` (bf16, M <= 64: the same ring streaming the weight, the
product swapped so the weight's columns are wgmma's 64-row side),
``"masked"`` (bf16 operands TMA cannot take: K or N not a multiple of 8,
or a base not 16-byte aligned; WMMA with masked loads) and ``"f32"``
(register-blocked full-f32 FMA). Split-K with a fixed-order reduction
fills the card when the output has too few tiles (on the f32 route: the
weight gradients, such as MIND's 64 x 64 over 3,276,800 rows); ragged
edges are masked in the kernel, nothing is padded. :func:`tensor_maps`
gives the TMA layouts the wrapper hands to the library. :func:`bound_ms`
is the least time on an H100: operations at the tensor-core (or f32)
peak, or bytes at 3.35 TB/s, whichever is larger.

B4 :func:`segment_sum` replaces the TPU kernel ``segment_sum`` of
``src/repro/kernels/segment_matmul.py:104`` (Pallas body
``_segsum_kernel``): ``f32[S, d]``, the rows of ``vals`` added up by their
unsorted segment ids, ids outside ``[0, S)`` dropped. In the reference
GraphSAGE aggregates through ``jax.ops.segment_sum`` and only the tests
call the Pallas kernel; in the port B4 is the aggregation itself (the
neighbour sums and degree counts of ``models/gnn.py``, the gathers'
gradients). Its source (``csrc/segment_sum.cu``) is a sorted,
load-balanced reduction with no float atomics instead of the TPU's
one-hot GEMM: it reads a :class:`SegmentPlan` (:func:`segment_plan`, the
ids' stable sort, built once per graph and reused by every layer and
backward pass), walks fixed tiles of sorted positions and adds the tiles'
partial rows in a fixed order (:func:`segment_tiles`), so its sums are
bitwise reproducible and equal, bit for bit, to the plain mirror
``ref.segment_sum_tiled``. :func:`segment_sum_bound_ms` counts its bytes.

The gradients (``kernels/ops.py`` wires them into autograd):
:func:`matmul_grads` is B5 twice on transposed operands (``da = dc @
b^T``, ``db = a^T @ dc``), and :func:`segment_gather` is B4's gradient, a
gather of the output gradient's rows by the same ids (its kernel sits in
``csrc/segment_sum.cu``; no atomics, so it is bitwise reproducible).

Dispatch is by the tensors' device: CUDA tensors launch the kernels (built
with nvcc at first use, loaded with ctypes), CPU tensors take the plain
versions ``ref.matmul``, ``ref.segment_sum``, ``ref.matmul_grads`` and
``ref.segment_gather`` (a plan's ids where a plan is given). There is no
fallback: a missing nvcc, a failed build, an operand a kernel does not
take or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from . import ref
from ._args import count_launch, plain, cuda_only, int32_vector
from ._build import build_cuda
from .contracts import (ANY_FLOAT, ANY_INT, BF16, F32, ArraySpec,
                        kernel_contract)

_SRC = Path(__file__).resolve().parent / "csrc" / "matmul.cu"
_SEGSUM_SRC = Path(__file__).resolve().parent / "csrc" / "segment_sum.cu"

#: H100 SXM peaks (NVIDIA's data sheet, dense): the bound's denominators
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
SM_COUNT = 132

#: (BM, BN, BK) of each route's tile in csrc/matmul.cu (the skinny route
#: takes 16 token rows up to M = 16, else 64; f32 takes 128 x 48 tiles for
#: N <= 48)
ROUTE_TILES = {"wgmma": (128, 256, 64), "skinny": (16, 128, 64),
               "masked": (128, 128, 32), "f32": (64, 128, 16)}
SKINNY_MAX_M = 64
#: the f32 route's blocks in flight on the card (three blocks of 128
#: threads an SM: its 384-thread launch bound) and the least K steps of a
#: split (256 of K), for its split-K
F32_FILL = 3 * SM_COUNT
F32_SPLIT_STEPS = 16
#: bf16 elements in 16 bytes: TMA needs 16-byte aligned bases and rows
TMA_ALIGN = 8
#: csrc/matmul.cu's shared memory: the TMA routes' K tile and B box, the
#: stages of each TMA route's ring (``launch_tma``), the masked route's
#: block (``MK_SMEM``) and the wgmma probe's (three boxes)
TMA_BK, TMA_BOX_BYTES = 64, 64 * 64 * 2
TMA_STAGES = {"wgmma": 4, "skinny": 8}
MASKED_SMEM = 27_136
PROBE_SMEM = 3 * TMA_BOX_BYTES + 1024


class Plan(NamedTuple):
    """How one product launches: its route, tile ``(BM, BN, BK)``, and K
    cut into ``splits`` ranges of ``k_split`` (a multiple of BK)."""
    route: str
    tile: tuple[int, int, int]
    splits: int
    k_split: int


class TensorMap(NamedTuple):
    """A 2-D TMA layout, innermost first: the tensor's ``(inner, outer)``
    extent, the outer dimension's stride in bytes and the box copied."""
    dims: tuple[int, int]
    row_bytes: int
    box: tuple[int, int]


@functools.cache
def _library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("matmul", [_SRC], deps=[_SRC.with_name("sm90.cuh")])
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    longs = ctypes.POINTER(ctypes.c_longlong)
    for name, args in (
            ("matmul_tma_launch", [ptr] * 3 + [i32] * 7 + [longs] * 2 + [ptr]),
            ("matmul_masked_launch", [ptr] * 3 + [i32] * 5 + [ptr]),
            ("splitk_reduce_launch", [ptr, ptr, ctypes.c_longlong, i32, ptr]),
            ("matmul_f32_launch", [ptr] * 3 + [i32] * 7 + [ptr]),
            ("wgmma_probe_launch", [ptr] * 4)):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    return lib, so


def build() -> Path:
    """Build the kernel's library (if needed) and load it; returns its
    path. Lets a caller pay the build outside a timed region."""
    return _library()[1]


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, dtype: torch.dtype = torch.bfloat16,
         aligned: bool = True) -> Plan:
    """The launch of one ``(M, K) @ (K, N)``: f32 operands take ``"f32"``;
    bf16 ones ``"masked"`` unless K and N are multiples of 8 and the bases
    16-byte aligned (``aligned``), else ``"skinny"`` for M <= 64 and
    ``"wgmma"`` above. When a TMA route's output has fewer tiles than the
    card has SMs, K is split (each split at least 4 K steps) so that the
    splits fill it; the masked route splits below two tiles per SM; the
    f32 route below one tile per SM, into at most :data:`F32_FILL` blocks
    of at least :data:`F32_SPLIT_STEPS` K steps each."""
    if dtype == torch.float32:
        tile = (128, 48, 16) if N <= 48 else ROUTE_TILES["f32"]
        tiles = math.ceil(M / tile[0]) * math.ceil(N / tile[1])
        steps = math.ceil(K / 16)
        splits = 1
        if tiles < SM_COUNT:
            splits = max(1, min(F32_FILL // tiles, steps // F32_SPLIT_STEPS))
        k_split = math.ceil(steps / splits) * 16
        return Plan("f32", tile, math.ceil(K / k_split) if K else 1,
                    k_split)
    if not (aligned and K % TMA_ALIGN == 0 and N % TMA_ALIGN == 0):
        route = "masked"
    else:
        route = "skinny" if M <= SKINNY_MAX_M else "wgmma"
    bm, bn, bk = ROUTE_TILES[route]
    if route == "skinny" and M > 16:
        bm = 64
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    steps = math.ceil(K / bk)
    fill = 2 * SM_COUNT if route == "masked" else SM_COUNT
    splits = 1
    if tiles < fill:
        splits = max(1, min(fill // tiles, steps // 4))
    k_split = math.ceil(steps / splits) * bk
    return Plan(route, (bm, bn, bk), math.ceil(K / k_split), k_split)


def smem_bytes(p: Plan) -> int:
    """Dynamic shared memory of one block of a launch on ``p``'s route:
    on the TMA routes the ring of ``TmaCfg<BM, BN>`` (stages of one A tile
    of BM x 64 and BN / 64 B boxes, 1 KB for alignment), the masked
    route's WMMA tiles and scratch, nothing on the f32 route (its tiles
    are static) or in the split-K reduction."""
    bm, bn, _ = p.tile
    if p.route in TMA_STAGES:
        stage = bm * TMA_BK * 2 + (bn // 64) * TMA_BOX_BYTES
        return TMA_STAGES[p.route] * stage + 1024
    return MASKED_SMEM if p.route == "masked" else 0


def _matmul_smem(v: dict) -> int:
    """The shared memory of :func:`matmul`'s launch on its arguments."""
    a, b = v["a"], v["b"]
    (M, K), N = a.shape, b.shape[1]
    if not (M and N and K):
        return 0
    dt = operand_dtype(a.dtype, b.dtype)
    aligned = all(t.dtype != dt or t.data_ptr() % 16 == 0 for t in (a, b))
    return smem_bytes(plan(M, N, K, dt, aligned))


def tensor_maps(M: int, N: int, K: int, tile: tuple[int, int, int]
                ) -> tuple[TensorMap, TensorMap]:
    """TMA layouts of a bf16 product on a TMA route with ``tile``: A
    (M x K, K contiguous) as boxes of (BK, BM), B (K x N, N contiguous: the
    weight as it is) as boxes of 64 columns x BK rows. Raises unless both
    row strides are multiples of 16 bytes."""
    bm, _, bk = tile
    a = TensorMap((K, M), 2 * K, (bk, bm))
    b = TensorMap((N, K), 2 * N, (64, bk))
    for name, m in (("A", a), ("B", b)):
        if m.row_bytes % 16:
            raise ValueError(f"TMA needs {name}'s rows in multiples of 16 "
                             f"bytes, got {m.row_bytes}")
    return a, b


def bound_ms(M: int, N: int, K: int, dtype: torch.dtype = torch.bfloat16
             ) -> float:
    """Least time of one ``(M, K) @ (K, N)`` on an H100: ``2MNK``
    operations at the peak of ``dtype`` (bf16 tensor cores, or f32 FMA),
    or each operand read once and the f32 output written once at
    3.35 TB/s, whichever is larger."""
    item = torch.tensor([], dtype=dtype).element_size()
    flops = 2.0 * M * N * K
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    nbytes = (M * K + K * N) * item + 4 * M * N
    return max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims disagree: a is (?, {a.shape[1]}), b is "
                         f"({b.shape[0]}, ?)")
    if not (a.is_floating_point() and b.is_floating_point()):
        raise TypeError(f"matmul takes float operands, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")


@functools.lru_cache(maxsize=4096)
def _tma_args(M: int, N: int, K: int, p: Plan) -> tuple:
    """The TMA launch's grid (work units, at most one block per SM) and
    its two tensor maps as the library takes them: cached per shape, so a
    decode step's host time stays what it was."""
    bm, bn, _ = p.tile
    units = math.ceil(M / bm) * math.ceil(N / bn) * p.splits
    return (min(units, SM_COUNT),
            *((ctypes.c_longlong * 5)(*m.dims, m.row_bytes, *m.box)
              for m in tensor_maps(M, N, K, p.tile)))


def operand_dtype(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """The dtype both operands take on the card: their promotion
    (``torch.promote_types``), with f16 promoted to f32 (exact: every f16
    value is an f32 value) and f64 computed in f32 (as the reference
    computes it with x64 off). Raises unless that is bf16 or f32: the
    kernels' two operand types."""
    dt = torch.promote_types(a, b)
    if dt in (torch.float16, torch.float64):
        dt = torch.float32
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the matmul kernel takes bf16, f16, f32 and f64 "
                        f"operands, got {a} and {b}")
    return dt


@kernel_contract(
    in_specs={"a": ArraySpec(("M", "K"), ANY_FLOAT),
              "b": ArraySpec(("K", "N"), ANY_FLOAT)},
    out_specs=ArraySpec(("M", "N"), F32),
    smem_bound=_matmul_smem)
def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32[M, N] = a @ b with f32 accumulation (a new tensor).

    On the card both operands are first cast to :func:`operand_dtype` (a
    bf16 activation times an f32 weight multiplies in f32), which leaves
    every value as it was but f64's, rounded to f32 as the plain version
    and the reference (x64 off) round them: the result is the
    f32-accumulated product of the promoted operands, ``ref.matmul``. They must be
    contiguous. ``matmul.launches`` counts kernel launches (one per call
    that launches; CPU calls and empty outputs launch nothing), and
    ``matmul.routes`` the same launches by :func:`plan`'s route."""
    _check(a, b)
    if plain(a.device):
        return ref.matmul(a, b)
    cuda_only(a.device, "matmul")
    dt = operand_dtype(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the matmul kernel takes contiguous operands")
    (M, K), N = a.shape, b.shape[1]
    if max(M, N, K) >= 2**31:
        raise ValueError(f"the matmul kernel takes dims below 2**31, got "
                         f"({M}, {K}) @ ({K}, {N})")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    p = plan(M, N, K, a.dtype,
             a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    lib = _library()[0]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        dst = out if p.splits == 1 else torch.empty(
            (p.splits, M, N), dtype=torch.float32, device=a.device)
        if p.route == "f32":
            rc = lib.matmul_f32_launch(
                a.data_ptr(), b.data_ptr(), dst.data_ptr(), M, N, K,
                p.k_split, p.splits, p.tile[1],
                int(N % 4 == 0 and b.data_ptr() % 16 == 0), stream)
        else:
            if p.route == "masked":
                rc = lib.matmul_masked_launch(
                    a.data_ptr(), b.data_ptr(), dst.data_ptr(), M, N, K,
                    p.k_split, p.splits, stream)
            else:
                grid, map_a, map_b = _tma_args(M, N, K, p)
                rc = lib.matmul_tma_launch(
                    a.data_ptr(), b.data_ptr(), dst.data_ptr(), M, N, K,
                    p.k_split, p.splits,
                    p.tile[0] if p.route == "skinny" else 0, grid, map_a,
                    map_b, stream)
        if not rc and p.splits > 1:
            rc = lib.splitk_reduce_launch(dst.data_ptr(), out.data_ptr(),
                                          M * N, p.splits, stream)
    if rc:
        raise RuntimeError(f"matmul launch failed ({p.route} route): CUDA "
                           f"error {rc}")
    count_launch(matmul, p.route)
    return out


def reset_counts() -> None:
    """Set ``matmul.launches``, every count of ``matmul.routes`` and
    ``matmul_grads.launches`` to 0."""
    matmul.launches = 0
    matmul.routes = dict.fromkeys(ROUTE_TILES, 0)
    matmul_grads.launches = 0


@kernel_contract(
    in_specs={"a": ArraySpec((64, 16), BF16),
              "b": ArraySpec((16, 128), BF16)},
    out_specs=ArraySpec((64, 128), F32),
    smem_bound=lambda v: PROBE_SMEM)
def wgmma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m64n128k16 wgmma on the card: f32[64, 128] = a @ b for bf16
    ``a`` (64 x 16) and ``b`` (16 x 128), loaded by TMA with the 128-byte
    swizzle and read through the descriptors of the TMA routes (``a``
    K-major, ``b`` MN-major). A descriptor or swizzle mistake shows here as
    wrong numbers on a single tile. Not counted in ``matmul.launches``."""
    cuda_only(a.device, "wgmma probe")
    if (a.shape, b.shape) != ((64, 16), (16, 128)) or not (
            a.dtype == b.dtype == torch.bfloat16 and a.is_contiguous()
            and b.is_contiguous() and b.device == a.device):
        raise ValueError("the wgmma probe takes contiguous bf16 (64, 16) and "
                         "(16, 128) operands on one card")
    out = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _library()[0].wgmma_probe_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"wgmma probe launch failed: CUDA error {rc}")
    return out


@functools.cache
def _segsum_library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("segment_sum", [_SEGSUM_SRC])
    lib = ctypes.CDLL(str(so))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.segment_gather_launch.restype = ctypes.c_int
    lib.segment_gather_launch.argtypes = [ptr] * 3 + [i64] * 3 + [ptr]
    lib.segment_sum_launch.restype = ctypes.c_int
    lib.segment_sum_launch.argtypes = [ptr] * 8 + [i64] * 6 + [
        ctypes.POINTER(ctypes.c_int64), i64, ptr]
    return lib, so


def build_segment_sum() -> Path:
    """Build B4's library (if needed) and load it; returns its path."""
    return _segsum_library()[1]


class SegmentPlan(NamedTuple):
    """B4's bookkeeping for one id vector, built once per graph by
    :func:`segment_plan` and read by every :func:`segment_sum` (and its
    gradients) over those ids. All int32, on the ids' device:

    * ``ids`` (E,): the ids as given;
    * ``num_segments``: S;
    * ``perm`` (E,): the stable argsort of ``ids`` (ties in row order);
    * ``sorted_ids`` (E,): ``ids[perm]``; negative ids come first, ids of
      S or above last;
    * ``offsets`` (S + 1,): ``offsets[s]`` is the first sorted position of
      segment s (``searchsorted`` on the left), so segment s is
      ``[offsets[s], offsets[s + 1])``, empty where the two are equal, and
      the in-range ids begin at ``offsets[0]`` and end at ``offsets[S]``.
    """
    ids: torch.Tensor
    num_segments: int
    perm: torch.Tensor
    sorted_ids: torch.Tensor
    offsets: torch.Tensor


_COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()


def _counters(n: int, device: torch.device, stream: int) -> torch.Tensor:
    """B4's arrival counters for one stream: at least ``n`` int32 zeros,
    made once and grown as needed. The kernel leaves them zero (the last
    arrival at each resets it), and launches on one stream run in order,
    so every launch on that stream finds them zero."""
    key = (device, stream)
    with _COUNTERS_LOCK:
        buf = _COUNTERS.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
            _COUNTERS[key] = buf
        return buf


def _num_segments(num_segments) -> int:
    S = int(num_segments)
    if not 0 <= S < 2**31:
        raise ValueError(f"num_segments must lie in [0, 2**31), got {S}")
    return S


def segment_plan(ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of an integer id vector (cast to int32) and
    S segments: a stable sort and a ``searchsorted``, integer bookkeeping
    only (every float add of the sum is the kernel's). The same torch
    calls build it on either device. ``segment_plan.builds`` counts plans
    built on the card."""
    ids = int32_vector("ids", ids)
    S = _num_segments(num_segments)
    if ids.shape[0] >= 2**31:
        raise ValueError(f"a segment plan takes fewer than 2**31 ids, got "
                         f"{ids.shape[0]}")
    sorted_ids, perm = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(S + 1, dtype=torch.int32, device=ids.device),
        out_int32=True)
    if ids.device.type == "cuda":
        count_launch(segment_plan, attr="builds")
    return SegmentPlan(ids, S, perm.to(torch.int32), sorted_ids, offsets)


segment_plan.builds = 0


def segment_plan_bytes(E: int, S: int) -> int:
    """Bytes a plan holds beside its ids: ``perm`` and ``sorted_ids`` (4 *
    E each) and ``offsets`` (4 * (S + 1)); the sort that makes them reads
    and writes more."""
    return 8 * E + 4 * (S + 1)


def plan_ids(ids) -> torch.Tensor:
    """The id vector of ``ids``: a plan's ``ids``, or ``ids`` itself."""
    return ids.ids if isinstance(ids, SegmentPlan) else ids


#: chunks of a level-1 block (its rows of threads); the chunks a row walks
#: in a step above level 1, and at most in the last step
#: (csrc/segment_sum.cu)
SEGSUM_ROWS = 8
SEGSUM_STEP = 8
SEGSUM_LAST_STEP = 32


def segment_tiles(E: int, d: int) -> tuple[int, tuple[int, ...]]:
    """B4's schedule for ``E`` rows of width ``d``: ``(tile, fans)``, the
    chunks of each level (``ref.segment_sum_tiled``'s arguments). Level 0
    cuts the sorted positions into chunks of ``tile``: 16 where ``E * d``
    is below 2**22 (latency-bound: the most chunks), 64 for rows of 256 or
    more (cut into column slices, which multiply the blocks), else 256 (a
    block's fixed work spread over the most rows). Level 1 takes
    ``fans[0]`` = F = :data:`SEGSUM_ROWS` chunks a block (a row of at most
    32 column lanes each). Above, each step takes groups of ``a * F``
    chunks, which the group's last block to finish walks as two levels,
    ``fans = (F, a1, F, a2, F, ...)``: a of them per row of the block, then
    the F rows' slots; ``a`` is :data:`SEGSUM_STEP`, or in the last step
    as few as cover what is left (at most :data:`SEGSUM_LAST_STEP`). A
    function of ``(E, d)`` alone: the order of every add, and so the
    output's bits, depend on nothing else."""
    tile = 16 if E * d < 2**22 else 64 if d >= 256 else 256
    return tile, _segment_fans(E, d, tile)


def _segment_fans(E: int, d: int, tile: int) -> tuple[int, ...]:
    """The fans of :func:`segment_tiles` for a level-0 ``tile``."""
    F = SEGSUM_ROWS
    fans = [F]
    n = -(-(-(-E // tile)) // F)
    while n > 1:
        a = -(-n // F) if n <= F * SEGSUM_LAST_STEP else SEGSUM_STEP
        fans += [a, F]
        n = -(-n // (a * F))
    return tuple(fans)


def _segment_slots(E: int, tile: int, fans: tuple[int, ...],
                   slices: int = 1) -> tuple[int, int]:
    """``(slots, counters)`` the steps above level 1 use: two slots per
    chunk of each level a step reads, rounded up to whole groups of ``a *
    F`` chunks (the kernel lays a group's slots out by row), and per
    column slice of each step one arrival counter per ``a`` chunks and one
    per group."""
    F = fans[0]
    n = -(-(-(-E // tile)) // F)
    slots = counters = 0
    for a in fans[1::2]:
        groups = -(-n // (a * F))
        slots += 2 * groups * a * F
        counters += (-(-n // a) + groups) * slices
        n = groups
    return slots, counters


def segment_sum_bound_ms(E: int, d: int, S: int) -> float:
    """Least time of one ``segment_sum`` of ``E`` rows of width ``d`` into
    ``S`` segments on an H100: f32 ``vals`` and int32 ``ids`` read once and
    the f32 output written once, over the memory rate (the ``E * d`` adds
    take far less at the f32 peak)."""
    return (4 * E * d + 4 * E + 4 * S * d) / HBM_BYTES_PER_S * 1e3


@kernel_contract(
    in_specs={"vals": ArraySpec(("E", "D"), ANY_FLOAT),
              "ids": ArraySpec(("E",), ANY_INT)},
    out_specs=ArraySpec(("num_segments", "D"), F32),
    smem_bound=lambda v: 0,
    views={"ids": plan_ids})
def segment_sum(vals: torch.Tensor, ids, num_segments: int) -> torch.Tensor:
    """B4: f32[num_segments, d], row ``s`` the sum of the rows ``vals[i]``
    with ``ids[i] == s`` (a new tensor); ids outside ``[0, num_segments)``
    add nothing. ``vals`` (E, d) of any float dtype is cast to f32, as the
    reference casts it; ``ids`` is an integer vector of length E, or its
    :class:`SegmentPlan` (of ``num_segments`` segments).

    On the card the f32 ``vals`` must be contiguous; an id vector gets a
    plan built here (counted in ``segment_plan.builds``). The sums are
    bitwise reproducible: their order is fixed by the ids, the values and
    :func:`segment_tiles`. ``segment_sum.launches`` counts kernel launches
    (one per call that launches: one kernel for every level; CPU calls and
    empty shapes launch nothing)."""
    if vals.dim() != 2:
        raise ValueError(f"segment_sum takes (E, d) values, got shape "
                         f"{tuple(vals.shape)}")
    if not vals.is_floating_point():
        raise TypeError(f"segment_sum takes float values, got {vals.dtype}")
    S = _num_segments(num_segments)
    plan = ids if isinstance(ids, SegmentPlan) else None
    if plan is not None and plan.num_segments != S:
        raise ValueError(f"the plan has {plan.num_segments} segments, the "
                         f"call {S}")
    ids = int32_vector("ids", plan_ids(ids), vals.shape[0], vals.device)
    if plain(vals.device):
        return ref.segment_sum(vals, ids, S)
    cuda_only(vals.device, "segment_sum")
    vals = vals.float()
    if not vals.is_contiguous():
        raise ValueError("the segment_sum kernel takes contiguous values")
    E, d = vals.shape
    out = torch.empty((S, d), dtype=torch.float32, device=vals.device)
    if S == 0 or d == 0:
        return out
    if E == 0:
        return out.zero_()
    if plan is None:
        plan = segment_plan(ids, S)
    ptr = vals.data_ptr()
    vec = (4 if d % 4 == 0 and ptr % 16 == 0 else
           2 if d % 2 == 0 and ptr % 8 == 0 else 1)
    lanes = min(32, 1 << (d // vec - 1).bit_length())
    tile, fans = segment_tiles(E, d)
    slots, counters = _segment_slots(E, tile, fans,
                                     -(-(d // vec) // lanes))
    slot_val = torch.empty((slots, d), dtype=torch.float32, device=vals.device)
    slot_key = torch.empty(slots, dtype=torch.int32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _segsum_library()[0].segment_sum_launch(
            ptr, plan.perm.data_ptr(), plan.sorted_ids.data_ptr(),
            plan.offsets.data_ptr(), out.data_ptr(), slot_val.data_ptr(),
            slot_key.data_ptr(),
            _counters(counters, vals.device, stream).data_ptr(), E, d, S,
            vec, lanes, tile, (ctypes.c_int64 * len(fans))(*fans), len(fans),
            stream)
    if rc:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {rc}")
    count_launch(segment_sum)
    return out


segment_sum.launches = 0


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """(bags, k) ids -> (bags, d): the rows of ``table`` by ``ids``
    (``jnp.take``'s rules), times ``weights`` where given, summed over each
    bag. The counterpart of the reference's ``embedding_bag`` of this
    module (``src/repro/kernels/segment_matmul.py:126``), which is an XLA
    gather and a sum, no Pallas kernel: so this is ``ref.embedding_bag``
    on the tensors' device, and launches nothing. ``ops.embedding_bag``
    is the differentiable one (its gradient is B4)."""
    return ref.embedding_bag(table, ids, weights)


def matmul_grads(a: torch.Tensor, b: torch.Tensor, dc: torch.Tensor,
                 need_a: bool = True, need_b: bool = True, mm=None):
    """B5's gradient: ``(da, db)`` of ``c = a @ b`` given ``dc`` (M, N),
    ``da = dc @ b^T`` and ``db = a^T @ dc``, each one product ``mm`` (f32
    accumulation) rounded to its operand's dtype, None where not needed.
    ``dc`` is rounded to bf16 for a bf16 product (:func:`operand_dtype`:
    the type the card multiplies it in; the models round its f32 output
    to bf16 at once, so the rounding is exact there). The transposed
    operands are contiguous copies (the kernel reads its operands as they
    lie): glm4's head, 1.24 GB, is copied once a step.

    ``mm`` is :func:`matmul` by default, and CPU tensors then take
    ``ref.matmul_grads``; ``kernels.ops`` passes its differentiable
    ``ops.matmul``, on either device, so that a gradient taken with
    ``create_graph=True`` is differentiable through B5 again.
    ``matmul_grads.launches`` counts the B5 launches made here (also
    counted in ``matmul.launches``)."""
    if mm is None:
        if plain(a.device):
            return ref.matmul_grads(a, b, dc, need_a, need_b)
        mm = matmul
    if operand_dtype(a.dtype, b.dtype) == torch.bfloat16:
        dc = dc.to(torch.bfloat16)
    dc = dc.contiguous()
    counted = a.device.type == "cuda"
    da = db = None
    if need_a:
        da = mm(dc, b.t().contiguous()).to(a.dtype)
        if counted:
            count_launch(matmul_grads)
    if need_b:
        db = mm(a.t().contiguous(), dc).to(b.dtype)
        if counted:
            count_launch(matmul_grads)
    return da, db


def segment_gather_bound_ms(E: int, d: int, rows: int) -> float:
    """Least time of one :func:`segment_gather` on an H100: the ``rows``
    distinct f32 rows of width ``d`` it reads (the in-range ids' rows),
    each once, the int32 ids and the ``E`` output rows written once, over
    the memory rate."""
    return (4 * rows * d + 4 * E + 4 * E * d) / HBM_BYTES_PER_S * 1e3


@kernel_contract(
    in_specs={"dout": ArraySpec(("S", "D"), ANY_FLOAT),
              "ids": ArraySpec(("E",), ANY_INT)},
    out_specs=ArraySpec(("E", "D"), ANY_FLOAT),
    smem_bound=lambda v: 0)
def segment_gather(dout: torch.Tensor, ids: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B4's gradient (a new tensor): row ``e`` of the (E, d) result is
    ``dout[ids[e]]`` where ``0 <= ids[e] < S`` (the rows of ``dout``), else
    0, gathered in f32 and cast to ``dtype`` (the values' dtype of the
    segment sum it differentiates). Deterministic: every element is
    written once. ``segment_gather.launches`` counts kernel launches (CPU
    calls, which take ``ref.segment_gather``, and empty shapes launch
    nothing)."""
    if dout.dim() != 2:
        raise ValueError(f"segment_gather takes (S, d) gradients, got shape "
                         f"{tuple(dout.shape)}")
    ids = int32_vector("ids", ids, device=dout.device)
    if plain(dout.device):
        return ref.segment_gather(dout, ids, dtype)
    cuda_only(dout.device, "segment_gather")
    dout = dout.float().contiguous()
    S, d = dout.shape
    E = ids.shape[0]
    out = torch.empty((E, d), dtype=torch.float32, device=dout.device)
    if E == 0 or d == 0:
        return out.to(dtype)
    if S == 0:
        return out.zero_().to(dtype)
    if d > 65535 * 128:
        raise ValueError(f"the segment_gather kernel takes rows of at most "
                         f"8,388,480 values, got {d}")
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _segsum_library()[0].segment_gather_launch(
            dout.data_ptr(), ids.data_ptr(), out.data_ptr(), E, d, S, stream)
    if rc:
        raise RuntimeError(f"segment_gather launch failed: CUDA error {rc}")
    count_launch(segment_gather)
    return out.to(dtype)


segment_gather.launches = 0
reset_counts()
