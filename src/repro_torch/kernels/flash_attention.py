"""B6: blockwise online-softmax attention, as a hand-written CUDA kernel.

Replaces the TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py:96`` (Pallas body ``_flash_kernel``).
In the reference no model path calls it (``gqa_attention`` is inline
jnp); in the port it is the LM's attention (``models/transformer.py``):
causal over the prompt at prefill, and over the KV cache at decode with
``t_real = cache_len + 1``.

Semantics are the Pallas kernel's (``ref.flash_attention`` states them):
queries (B, S, H, dh), keys and values (B, T, Hkv, dh) with query head
``h`` on kv head ``h // (H // Hkv)``, the causal mask aligned at position
0, keys at or past ``t_real`` masked, output in q's dtype. Only ``o`` is
returned: the Pallas kernel's ``m``/``l``/``acc`` outputs exist for its
interpret mode alone.

The CUDA source (``csrc/flash_attention.cu``) states the design: the G
query heads of one kv head share a block (at decode the 16 heads of a
glm4 group fill one 16-row tile, so each cache tile is read once per
group), mma.sync for QK^T and PV with P rounded to bf16, the key range
split over blocks when there are too few (:func:`plan`). It takes bf16
and dh = 128, the LM's; anything else raises on the card.
:func:`bound_ms` is the least time on an H100: the attended (query, key)
pairs' operations at 989 TFLOP/s, or q, o and the first ``t_real`` keys
and values moved once at 3.35 TB/s, whichever is larger.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (built
with nvcc at first use, loaded with ctypes), CPU tensors take the plain
version ``ref.flash_attention``. There is no fallback: a missing nvcc, a
failed build, an input the kernel does not take or a refused launch
raises.
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

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: H100 SXM peaks (NVIDIA's data sheet, dense): the bound's denominators
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
SM_COUNT = 132

#: csrc/flash_attention.cu's head width, keys per tile and rows per warp
HEAD_DIM = 128
KV_TILE = 64
WARP_ROWS = 16


@functools.cache
def _library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("flash_attention", [_SRC])
    lib = ctypes.CDLL(str(so))
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    comb = lib.flash_combine_launch
    comb.restype = ctypes.c_int
    comb.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return lib, so


def build() -> Path:
    """Build the kernel's library (if needed) and load it; returns its
    path. Lets a caller pay the build outside a timed region."""
    return _library()[1]


def plan(B: int, S: int, H: int, Hkv: int, t_real: int, causal: bool
         ) -> tuple[int, int, int, int]:
    """``(nwq, q_tiles, splits, tiles_per_split)`` of a launch.

    A (b, kv head) pair has ``S * G`` rows. Up to 16 rows (decode) fit one
    warp's tile and the block's 4 warps split each k/v tile's keys
    (``nwq`` = 1); more rows take 64-row tiles, 16 per warp (``nwq`` = 4).
    When the rows fit one tile and the blocks are fewer than two per SM,
    the key range is split over ``splits`` blocks of ``tiles_per_split``
    k/v tiles each, none empty."""
    rows = S * (H // Hkv)
    nwq = 1 if rows <= WARP_ROWS else 4
    q_tiles = math.ceil(rows / (WARP_ROWS * nwq))
    n_tiles = math.ceil((min(t_real, S) if causal else t_real) / KV_TILE)
    blocks = q_tiles * B * Hkv
    splits, per = 1, n_tiles
    if q_tiles == 1 and blocks < 2 * SM_COUNT and n_tiles > 1:
        per = math.ceil(n_tiles / min(math.ceil(2 * SM_COUNT / blocks),
                                      n_tiles))
        splits = math.ceil(n_tiles / per)
    return nwq, q_tiles, splits, per


def attended_pairs(S: int, t_real: int, causal: bool) -> int:
    """(query position, key) pairs one head attends: ``S * t_real``, or
    under the causal mask ``sum over s of min(s + 1, t_real)``."""
    if not causal:
        return S * t_real
    full = min(S, t_real)                    # positions s < t_real
    return full * (full + 1) // 2 + (S - full) * t_real


def bound_ms(B: int, S: int, H: int, Hkv: int, t_real: int, causal: bool,
             dh: int = HEAD_DIM, itemsize: int = 2) -> float:
    """Least time of one call on an H100: ``4 * dh`` operations per
    attended (query, key) pair and head (QK^T and PV) at 989 TFLOP/s, or
    q and o plus the first ``t_real`` keys and values, each moved once,
    at 3.35 TB/s, whichever is larger."""
    flops = 4.0 * dh * B * H * attended_pairs(S, t_real, causal)
    nbytes = itemsize * dh * (2 * B * S * H + 2 * B * t_real * Hkv)
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


#: how far the kernel's output may lie from the plain version's, elementwise:
#: RTOL of |plain| for the two outputs' bf16 roundings (2^-8 relative apart),
#: plus ROW_ATOL of the largest |plain| in the element's row (one query
#: head's dh outputs) for the kernel's bf16 P (2^-9 relative per
#: probability, an error of that order of the row's spread). The row scale
#: follows the output's own size, which at decode over 32,768 random keys is
#: about 1e-2, so a dropped key tile or split shows in its rows.
RTOL, ROW_ATOL = 2e-2, 1e-2


def error_bound(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| around the plain version's
    (B, S, H, dh) output ``want``, in f32."""
    w = want.float().abs()
    return RTOL * w + ROW_ATOL * w.amax(-1, keepdim=True)


def _check(q, k, v, t_real):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, S, H, dh) queries and "
                         "(B, T, Hkv, dh) keys and values")
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if not 1 <= t_real <= T:
        raise ValueError(f"t_real must lie in [1, T = {T}], got {t_real}")
    if not (q.dtype == k.dtype == v.dtype and q.is_floating_point()):
        raise TypeError(f"q, k, v must share one float dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    t_real: int | None = None) -> torch.Tensor:
    """(B, S, H, dh) attention of ``q`` over the first ``t_real`` (default
    T) of ``k``, ``v`` (B, T, Hkv, dh), in q's dtype (a new tensor).

    ``flash_attention.launches`` counts kernel launches (one per call that
    launches; CPU calls and empty outputs launch nothing)."""
    t_real = k.shape[1] if t_real is None else int(t_real)
    _check(q, k, v, t_real)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
    cuda_only(q.device, "flash_attention")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash_attention kernel takes bf16, got "
                        f"{q.dtype}")
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if dh != HEAD_DIM:
        raise ValueError(f"the flash_attention kernel takes dh = {HEAD_DIM}, "
                         f"got {dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the flash_attention kernel takes contiguous, "
                             f"16-byte aligned inputs ({name} is not)")
    if B * Hkv > 65535:                   # the launch grid's y extent
        raise ValueError(f"B * Hkv = {B * Hkv} exceeds 65,535")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    nwq, q_tiles, splits, per = plan(B, S, H, Hkv, t_real, causal)
    part_acc = part_ml = None
    if splits > 1:
        rows = B * S * H
        part_acc = torch.empty((splits, rows, dh), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((splits, rows, 2), dtype=torch.float32,
                              device=q.device)
    lib = _library()[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            part_acc.data_ptr() if splits > 1 else None,
            part_ml.data_ptr() if splits > 1 else None,
            B, S, H, Hkv, T, t_real, int(causal), nwq, q_tiles, splits, per,
            stream)
        if not rc and splits > 1:
            rc = lib.flash_combine_launch(part_acc.data_ptr(),
                                          part_ml.data_ptr(), o.data_ptr(),
                                          B, S, H, Hkv, splits, stream)
    if rc:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
