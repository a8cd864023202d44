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
fills the card when the output has too few tiles; ragged edges are
masked in the kernel, nothing is padded. :func:`tensor_maps` gives the TMA
layouts the wrapper hands to the library. :func:`bound_ms` is the least
time on an H100: operations at the tensor-core (or f32) peak, or bytes at
3.35 TB/s, whichever is larger.

B4 :func:`segment_sum` replaces the TPU kernel ``segment_sum`` of
``src/repro/kernels/segment_matmul.py:104`` (Pallas body
``_segsum_kernel``): ``f32[S, d]``, the rows of ``vals`` added up by their
unsorted segment ids, ids outside ``[0, S)`` dropped. In the reference
GraphSAGE aggregates through ``jax.ops.segment_sum`` and only the tests
call the Pallas kernel; in the port B4 is the aggregation itself (the
neighbour sums and the degree counts of ``models/gnn.py``). Its source
(``csrc/segment_sum.cu``) is a scatter-reduce with a run-merged atomic
flush instead of the TPU's one-hot GEMM; its float atomics make the sums'
order, and so their last bits, change from run to run.
:func:`segment_sum_bound_ms` counts its bytes.

The gradients (``kernels/ops.py`` wires them into autograd):
:func:`matmul_grads` is B5 twice on transposed operands (``da = dc @
b^T``, ``db = a^T @ dc``), and :func:`segment_gather` is B4's gradient, a
gather of the output gradient's rows by the same ids (its kernel sits in
``csrc/segment_sum.cu``; no atomics, so it is bitwise reproducible).

Dispatch is by the tensors' device: CUDA tensors launch the kernels (built
with nvcc at first use, loaded with ctypes), CPU tensors take the plain
versions ``ref.matmul``, ``ref.segment_sum``, ``ref.matmul_grads`` and
``ref.segment_gather``. There is no fallback: a missing nvcc, a failed
build, an operand a kernel does not take or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from . import ref
from ._args import count_launch, cuda_only, int32_vector
from ._build import build_cuda

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
#: bf16 elements in 16 bytes: TMA needs 16-byte aligned bases and rows
TMA_ALIGN = 8


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
            ("matmul_f32_launch", [ptr] * 3 + [i32] * 5 + [ptr]),
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
    splits fill it; the masked route splits below two tiles per SM."""
    if dtype == torch.float32:
        tile = (128, 48, 16) if N <= 48 else ROUTE_TILES["f32"]
        return Plan("f32", tile, 1, math.ceil(K / 16) * 16)
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
    if a.device.type == "cpu":
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
        if p.route == "f32":
            rc = lib.matmul_f32_launch(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                p.tile[1], int(N % 4 == 0 and b.data_ptr() % 16 == 0), stream)
        else:
            dst = out if p.splits == 1 else torch.empty(
                (p.splits, M, N), dtype=torch.float32, device=a.device)
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
    for name in ("segment_sum_launch", "segment_gather_launch"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
    return lib, so


def build_segment_sum() -> Path:
    """Build B4's library (if needed) and load it; returns its path."""
    return _segsum_library()[1]


def segment_sum_bound_ms(E: int, d: int, S: int) -> float:
    """Least time of one ``segment_sum`` of ``E`` rows of width ``d`` into
    ``S`` segments on an H100: f32 ``vals`` and int32 ``ids`` read once and
    the f32 output written once, over the memory rate (the ``E * d`` adds
    take far less at the f32 peak)."""
    return (4 * E * d + 4 * E + 4 * S * d) / HBM_BYTES_PER_S * 1e3


def segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """B4: f32[num_segments, d], row ``s`` the sum of the rows ``vals[i]``
    with ``ids[i] == s`` (a new tensor); ids outside ``[0, num_segments)``
    add nothing. ``vals`` (E, d) of any float dtype is cast to f32, as the
    reference casts it; ``ids`` is an integer vector of length E.

    On the card the f32 ``vals`` must be contiguous. The sums' order, and
    so their last bits, change from run to run (float atomics).
    ``segment_sum.launches`` counts kernel launches (one per call that
    launches: a memset and the kernel; CPU calls and empty shapes launch
    nothing)."""
    if vals.dim() != 2:
        raise ValueError(f"segment_sum takes (E, d) values, got shape "
                         f"{tuple(vals.shape)}")
    if not vals.is_floating_point():
        raise TypeError(f"segment_sum takes float values, got {vals.dtype}")
    ids = int32_vector("ids", ids, vals.shape[0], vals.device)
    S = int(num_segments)
    if not 0 <= S < 2**31:
        raise ValueError(f"num_segments must lie in [0, 2**31), got {S}")
    if vals.device.type == "cpu":
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
    if d > 65535 * 128:                    # column chunks on the grid's y
        raise ValueError(f"the segment_sum kernel takes rows of at most "
                         f"8,388,480 values, got {d}")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _segsum_library()[0].segment_sum_launch(
            vals.data_ptr(), ids.data_ptr(), out.data_ptr(), E, d, S, stream)
    if rc:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {rc}")
    count_launch(segment_sum)
    return out


segment_sum.launches = 0


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
        if a.device.type == "cpu":
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
    if dout.device.type == "cpu":
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
