"""B6: blockwise online-softmax attention, as hand-written CUDA kernels.

Replaces the TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py:96`` (Pallas body ``_flash_kernel``).
In the reference no model path calls it (``gqa_attention`` is inline
jnp); in the port it is the LM's attention (``models/transformer.py``):
causal over the prompt at prefill, and over the KV cache at decode with
``t_real = cache_len + 1``.

Semantics are the Pallas kernel's (``ref.flash_attention`` states them):
queries (B, S, H, dh), keys and values (B, T, Hkv, dh) with query head
``h`` on kv head ``h // (H // Hkv)``, the causal mask aligned at position
0, keys at or past ``t_real`` masked and never read, output in q's dtype.
Only ``o`` is returned: the Pallas kernel's ``m``/``l``/``acc`` outputs
exist for its interpret mode alone.

The CUDA source (``csrc/flash_attention.cu``, with the Hopper helpers of
``csrc/sm90.cuh``) states the design. :func:`plan` picks one of four
routes from the dtype and shape: ``"wgmma"`` (bf16 or f16, dh 64 or 128,
more than 16 rows per (b, kv head), G dividing 128: warp-specialised TMA +
wgmma over 128-row q tiles and 128-key k/v tiles, P in registers as the
PV product's A operand), ``"mma"`` (bf16 or f16, more than 16 rows, any
other dh up to 128: mma.sync over 64-row tiles), ``"split"`` (bf16 or
f16, at most 16 rows: decode; the same mma.sync kernel with the key range
split over blocks), ``"f32"`` (f32 inputs in plain f32 FMAs) and
``"wide"`` (any dtype at dh above 128: the f32 route's kernel looped over
128-column chunks, reading bf16 or f16 and rounding only the output). A
dh that is not a multiple of 8 is zero-padded to the next one, the scale
staying 1/sqrt(dh); f64 inputs are computed in f32 (as the reference
computes them with x64 off) and the output cast back. The G query heads
of one kv head share a block, so each k/v tile is read once per group. :func:`bound_ms` is the least time on an
H100: the attended (query, key) pairs' operations at the peak of the
dtype, or q, o and the first ``t_real`` keys and values moved once at
3.35 TB/s, whichever is larger.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (built
with nvcc at first use, loaded with ctypes), CPU tensors take the plain
version ``ref.flash_attention``. There is no fallback: a missing nvcc, a
failed build, an input the kernels do not take (another dtype, a view
that is not contiguous) or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from . import ref
from ._args import count_launch, cuda_only
from ._build import build_cuda

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: H100 SXM peaks (NVIDIA's data sheet, dense): the bound's denominators
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
SM_COUNT = 132
#: shared memory an SM gives its blocks (232,448 bytes a block at most)
SMEM_PER_SM = 233_472

#: csrc/flash_attention.cu's tiles: (rows, keys) of a block per route
ROUTE_TILES = {"wgmma": (128, 128), "mma": (64, 64), "split": (16, 64),
               "f32": (16, 32), "wide": (16, 32)}
#: the widest head of the tensor-core and f32 routes (wider: "wide"), and
#: the multiple the wrapper pads every head width to
WIDEST_HEAD, HEAD_STEP = 128, 8
#: head widths the mma.sync kernel is built for (dh is padded to the next)
MMA_WIDTHS = (16, 32, 64, 128)
WGMMA_WIDTHS = (64, 128)
#: the k/v ring of the mma and split routes (csrc: MMA_STAGES)
MMA_STAGES = 3
#: rows of a (b, kv head) up to which a launch takes the split route
WARP_ROWS = 16


class Plan(NamedTuple):
    """How one call launches: its route, the kernel's head width ``dhp``
    (dh padded on the mma and split routes), ``q_tiles`` row tiles per
    (b, kv head), and each block's key range cut into ``splits`` ranges
    of ``tiles_per_split`` k/v tiles."""
    route: str
    dhp: int
    q_tiles: int
    splits: int
    tiles_per_split: int


@functools.cache
def _library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("flash_attention", [_SRC],
                    deps=[_SRC.with_name("sm90.cuh")])
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args in (
            ("flash_attention_launch", [ptr] * 6 + [i32] * 15 + [ptr]),
            ("flash_attention_simt_launch", [ptr] * 4 + [i32] * 11 + [ptr]),
            ("flash_probe_launch", [ptr] * 6)):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args
    return lib, so


def build() -> Path:
    """Build the kernel's library (if needed) and load it; returns its
    path. Lets a caller pay the build outside a timed region."""
    return _library()[1]


def _mma_blocks_per_sm(dhp: int) -> int:
    """Blocks of the mma and split routes that fit an SM's shared memory
    (the k/v ring of csrc's ``MmaCfg<dhp>``, 1 KB reserved per block)."""
    ring = MMA_STAGES * 2 * ROUTE_TILES["split"][1] * (dhp + 8) * 2
    return SMEM_PER_SM // (ring + 1024)


@functools.lru_cache(maxsize=4096)
def plan(B: int, S: int, H: int, Hkv: int, t_real: int, causal: bool,
         dh: int = 128, dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The launch of one call, at the head width the kernel gets (a
    multiple of 8). dh above 128 takes ``"wide"``, f32 ``"f32"``. bf16 and
    f16 take ``"split"`` when a (b, kv head) pair has at most 16 rows
    (``S * G``; decode), else ``"wgmma"`` for dh of 64 or 128 with G
    dividing 128, else ``"mma"``. On the split and mma routes, when the
    rows fit one tile and the blocks do not fill the card, the key range is
    split over as many blocks as fit one wave, none empty."""
    G = H // Hkv
    rows = S * G
    keys = min(t_real, S) if causal else t_real
    if dh > WIDEST_HEAD:
        route, dhp = "wide", dh
    elif dtype == torch.float32:
        route, dhp = "f32", dh
    elif rows <= WARP_ROWS:
        route = "split"
    elif dh in WGMMA_WIDTHS and 128 % G == 0:
        route, dhp = "wgmma", dh
    else:
        route = "mma"
    if route in ("mma", "split"):
        dhp = next(w for w in MMA_WIDTHS if w >= dh)
    bq, bk = ROUTE_TILES[route]
    q_tiles = math.ceil(rows / bq)
    n_tiles = math.ceil(keys / bk)
    splits, per = 1, n_tiles
    if route in ("mma", "split") and q_tiles == 1 and n_tiles > 1:
        blocks = B * Hkv
        slots = _mma_blocks_per_sm(dhp) * SM_COUNT
        if blocks < slots:
            per = math.ceil(n_tiles / max(1, min(slots // blocks, n_tiles)))
            splits = math.ceil(n_tiles / per)
    return Plan(route, dhp, q_tiles, splits, per)


def attended_pairs(S: int, t_real: int, causal: bool) -> int:
    """(query position, key) pairs one head attends: ``S * t_real``, or
    under the causal mask ``sum over s of min(s + 1, t_real)``."""
    if not causal:
        return S * t_real
    full = min(S, t_real)                    # positions s < t_real
    return full * (full + 1) // 2 + (S - full) * t_real


def bound_ms(B: int, S: int, H: int, Hkv: int, t_real: int, causal: bool,
             dh: int = 128, itemsize: int = 2) -> float:
    """Least time of one call on an H100: ``4 * dh`` operations per
    attended (query, key) pair and head (QK^T and PV) at 989 TFLOP/s (67
    for f32 and f64, ``itemsize`` 4 or 8, computed in f32), or q and o
    plus the first ``t_real`` keys and values, each moved once, at 3.35
    TB/s, whichever is larger."""
    flops = 4.0 * dh * B * H * attended_pairs(S, t_real, causal)
    peak = F32_FLOP_PER_S if itemsize >= 4 else BF16_FLOP_PER_S
    nbytes = itemsize * dh * (2 * B * S * H + 2 * B * t_real * Hkv)
    return max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3


#: how far the kernel's output may lie from the plain version's, elementwise:
#: RTOL of |plain| for the two outputs' bf16 roundings (2^-8 relative apart),
#: plus ROW_ATOL of the largest |plain| in the element's row (one query
#: head's dh outputs) for the kernel's bf16 P (2^-9 relative per
#: probability, an error of that order of the row's spread). The row scale
#: follows the output's own size, which at decode over 32,768 random keys is
#: about 1e-2, so a dropped key tile or split shows in its rows. f32 outputs
#: are held to F32_TOL (tests/test_kernels.py's f32 flash tolerance).
RTOL, ROW_ATOL = 2e-2, 1e-2
F32_TOL = 2e-3
#: the keys the card check leaves out of the plain version to show that
#: error_bound sees a missing key range (fewer than any route's key tile)
CHECK_CUT_KEYS = 64


def error_bound(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| around the plain version's
    (B, S, H, dh) output ``want``, in f32: for f32 and f64 outputs (both
    computed in f32) ``F32_TOL`` of |plain| + ``F32_TOL``, else the
    bf16/f16 bound above."""
    w = want.float().abs()
    if want.dtype in (torch.float32, torch.float64):
        return F32_TOL * w + F32_TOL
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


def _kernel_check(q, k, v) -> None:
    """Raise unless the card's kernels take these inputs."""
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32,
                       torch.float64):
        raise TypeError(f"the flash_attention kernels take bf16, f16, f32 or "
                        f"f64, got {q.dtype}")
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the flash_attention kernel takes contiguous, "
                             f"16-byte aligned inputs ({name} is not)")
    if B * Hkv > 65535:                   # the launch grid's y extent
        raise ValueError(f"B * Hkv = {B * Hkv} exceeds 65,535")


def kernel_width(dh: int) -> int:
    """The head width the kernels get: dh zero-padded to a multiple of 8."""
    return -(-dh // HEAD_STEP) * HEAD_STEP


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    t_real: int | None = None) -> torch.Tensor:
    """(B, S, H, dh) attention of ``q`` over the first ``t_real`` (default
    T) of ``k``, ``v`` (B, T, Hkv, dh), in q's dtype (a new tensor).

    ``flash_attention.launches`` counts kernel launches (one per call that
    launches; CPU calls and empty outputs launch nothing), and
    ``flash_attention.routes`` the same launches by :func:`plan`'s
    route."""
    t_real = k.shape[1] if t_real is None else int(t_real)
    _check(q, k, v, t_real)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
    cuda_only(q.device, "flash_attention")
    _kernel_check(q, k, v)
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out_dtype = q.dtype
    if q.numel() == 0:
        return torch.empty_like(q)
    if out_dtype == torch.float64:
        q, k, v = q.float(), k.float(), v.float()
    dhk = kernel_width(dh)
    if dhk != dh:
        q, k, v = (torch.nn.functional.pad(x, (0, dhk - dh)) for x in (q, k, v))
    o = torch.empty_like(q)
    p = plan(B, S, H, Hkv, t_real, causal, dhk, q.dtype)
    lib = _library()[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if p.route in ("f32", "wide"):
            rc = lib.flash_attention_simt_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                (torch.float32, torch.bfloat16, torch.float16).index(q.dtype),
                B, S, H, Hkv, T, dhk, t_real, int(causal), p.q_tiles, dh,
                stream)
        else:
            part_acc = part_ml = None
            if p.splits > 1:
                rows = B * S * H
                part_acc = torch.empty((p.splits, rows, dhk),
                                       dtype=torch.float32, device=q.device)
                part_ml = torch.empty((p.splits, rows, 2),
                                      dtype=torch.float32, device=q.device)
            rc = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                part_acc.data_ptr() if p.splits > 1 else None,
                part_ml.data_ptr() if p.splits > 1 else None,
                int(q.dtype == torch.float16),
                ("wgmma", "mma", "split").index(p.route), p.dhp, B, S, H,
                Hkv, T, dhk, t_real, int(causal), p.q_tiles, p.splits,
                p.tiles_per_split, dh, stream)
    if rc:
        raise RuntimeError(f"flash_attention launch failed ({p.route} "
                           f"route): CUDA error {rc}")
    count_launch(flash_attention, p.route)
    if dhk != dh:
        o = o[..., :dh].contiguous()
    return o.to(out_dtype)


def reset_counts() -> None:
    """Set ``flash_attention.launches`` and every count of
    ``flash_attention.routes`` to 0."""
    flash_attention.launches = 0
    flash_attention.routes = dict.fromkeys(ROUTE_TILES, 0)


reset_counts()


def rs_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wgmma route's two products on one tile, on the card: bf16 ``q``
    (64, 128), ``k`` and ``v`` (128, 128) through the route's 4-D tensor
    maps; returns f32 ``(s, o)``, ``s = q @ k.T`` (SS wgmma from the
    TMA-loaded, 128-byte-swizzled tiles) and ``o`` the attention of ``q``
    over ``k``, ``v`` with P rounded to bf16 in registers (RS wgmma, ``v``
    MN-major), each (64, 128). A descriptor or layout mistake shows here as
    wrong numbers on a single tile. Not counted in ``launches``."""
    cuda_only(q.device, "flash_attention probe")
    if (q.shape, k.shape, v.shape) != ((64, 128), (128, 128), (128, 128)) \
            or not (q.dtype == k.dtype == v.dtype == torch.bfloat16
                    and all(t.is_contiguous() and t.device == q.device
                            for t in (q, k, v))):
        raise ValueError("the probe takes contiguous bf16 q (64, 128), k and "
                         "v (128, 128) on one card")
    s = torch.empty((64, 128), dtype=torch.float32, device=q.device)
    o = torch.empty_like(s)
    with torch.cuda.device(q.device):
        rc = _library()[0].flash_probe_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention probe failed: CUDA error {rc}")
    return s, o
