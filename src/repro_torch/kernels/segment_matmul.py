"""B5: the tiled GEMM ``f32[M, N] = a @ b``, as a hand-written CUDA kernel.

Replaces the TPU kernel ``matmul`` of ``src/repro/kernels/segment_matmul.py:52``
(Pallas body ``_matmul_kernel``): f32 or bf16 operands, f32 output with f32
accumulation. In the reference no model path calls it (the projections are
``x @ w``); in the port it is every dense projection of the LM
(``models/transformer.py``: wq/wk/wv/wo, the FFN's wi/wg/wo and the head),
with the weight in the reference's ``(d_in, d_out)`` layout, read as it is.

The CUDA source (``csrc/matmul.cu``) states the design: bf16 through the
tensor cores (WMMA, cp.async ring), 128 x 128 tiles for many rows and
16 x 128 tiles for M <= 64, split-K with a fixed-order reduction when the
output has too few tiles for the card, full-f32 FMA for f32; ragged edges
masked in the kernel, nothing padded. :func:`plan` chooses the tile and
the split (the same tile sizes as the source). :func:`bound_ms` is the
least time on an H100: operations at the tensor-core (or f32) peak, or
bytes at 3.35 TB/s, whichever is larger.

The reference module also holds B4 ``segment_sum``; it waits for the GNN
slice (ROADMAP queue B) and is not here yet.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (built
with nvcc at first use, loaded with ctypes), CPU tensors take the plain
version ``ref.matmul``. There is no fallback: a missing nvcc, a failed
build, an operand the kernel does not take or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from . import ref
from ._args import cuda_only
from ._build import build_cuda

_SRC = Path(__file__).resolve().parent / "csrc" / "matmul.cu"

#: H100 SXM peaks (NVIDIA's data sheet, dense): the bound's denominators
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
SM_COUNT = 132

#: (BM, BN, BK) of csrc/matmul.cu's bf16 tiles: 16 rows for M <= 64
SKINNY_TILE = (16, 128, 64)
WIDE_TILE = (128, 128, 32)
SKINNY_MAX_M = 64


@functools.cache
def _library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("matmul", [_SRC])
    lib = ctypes.CDLL(str(so))
    fn = lib.matmul_bf16_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    red = lib.splitk_reduce_launch
    red.restype = ctypes.c_int
    red.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_void_p]
    f32 = lib.matmul_f32_launch
    f32.restype = ctypes.c_int
    f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return lib, so


def build() -> Path:
    """Build the kernel's library (if needed) and load it; returns its
    path. Lets a caller pay the build outside a timed region."""
    return _library()[1]


def plan(M: int, N: int, K: int) -> tuple[bool, int, int]:
    """``(skinny, splits, k_split)`` of a bf16 launch: the 16-row tiles for
    M <= 64; when the output has fewer than two tiles per SM, K is split
    (each split at least 4 K steps) into ``splits`` ranges of ``k_split``
    (a multiple of the K step), none empty."""
    skinny = M <= SKINNY_MAX_M
    bm, bn, bk = SKINNY_TILE if skinny else WIDE_TILE
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    steps = math.ceil(K / bk)
    splits = 1
    if tiles < 2 * SM_COUNT:
        splits = max(1, min(math.ceil(2 * SM_COUNT / tiles), steps // 4))
    k_split = math.ceil(steps / splits) * bk
    return skinny, math.ceil(K / k_split), k_split


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


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32[M, N] = a @ b with f32 accumulation (a new tensor).

    On the card both operands must be contiguous and of one dtype, bf16
    or f32. ``matmul.launches`` counts kernel launches (one per call that
    launches; CPU calls and empty outputs launch nothing)."""
    _check(a, b)
    if a.device.type == "cpu":
        return ref.matmul(a, b)
    cuda_only(a.device, "matmul")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the matmul kernel takes two bf16 or two f32 "
                        f"operands, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the matmul kernel takes contiguous operands")
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    if M > 65535 * 64:            # row tiles of >= 64 rows on the grid's y
        raise ValueError(f"the matmul kernel takes at most 4,194,240 rows, "
                         f"got {M}")
    lib = _library()[0]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if a.dtype == torch.float32:
            rc = lib.matmul_f32_launch(a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), M, N, K, stream)
        else:
            skinny, splits, k_split = plan(M, N, K)
            vec = (K % 8 == 0 and N % 8 == 0 and a.data_ptr() % 16 == 0
                   and b.data_ptr() % 16 == 0)
            dst = out if splits == 1 else torch.empty(
                (splits, M, N), dtype=torch.float32, device=a.device)
            rc = lib.matmul_bf16_launch(a.data_ptr(), b.data_ptr(),
                                        dst.data_ptr(), M, N, K, k_split,
                                        splits, int(skinny), int(vec), stream)
            if not rc and splits > 1:
                rc = lib.splitk_reduce_launch(dst.data_ptr(), out.data_ptr(),
                                              M * N, splits, stream)
    if rc:
        raise RuntimeError(f"matmul launch failed: CUDA error {rc}")
    matmul.launches += 1
    return out


matmul.launches = 0
