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
``o`` is returned, and with ``return_lse`` also the rows' log-sum-exp
(B, H, S) f32, which the backward reuses; the Pallas kernel's
``m``/``l``/``acc`` outputs exist for its interpret mode alone.

The CUDA source (``csrc/flash_attention.cu``, with the Hopper helpers of
``csrc/sm90.cuh``) states the design. :func:`plan` picks one of four
routes from the dtype and shape: ``"wgmma"`` (bf16 or f16, dh 64 or 128,
more than 16 rows per (b, kv head), G dividing 128: warp-specialised TMA +
wgmma over 128-row q tiles and 128-key k/v tiles, P in registers as the
PV product's A operand), ``"mma"`` (bf16 or f16, more than 16 rows, any
other dh up to 128: mma.sync over 64-row tiles), ``"split"`` (bf16 or
f16, at most 16 rows: decode; the same mma.sync kernel, its warps over
the output columns, with the key range split over blocks; a row it takes
in one block equals the ``"mma"`` route's row bit for bit), ``"f32"``
(f32 inputs in plain f32 FMAs) and
``"wide"`` (any dtype at dh above 128: the f32 route's kernel looped over
128-column chunks, reading bf16 or f16 and rounding only the output). A
dh that is not a multiple of 8 is zero-padded to the next one, the scale
staying 1/sqrt(dh); f64 inputs are computed in f32 (as the reference
computes them with x64 off) and the output cast back. The G query heads
of one kv head share a block, so each k/v tile is read once per group. :func:`bound_ms` is the least time on an
H100: the attended (query, key) pairs' operations at the peak of the
dtype, or q, o and the first ``t_real`` keys and values moved once at
3.35 TB/s, whichever is larger.

The gradient, :func:`flash_attention_bwd`, is a kernel of its own
(``csrc/flash_attention_bwd.cu`` states its design): FlashAttention-2's
recurrence from the forward's lse, on four routes that :func:`bwd_plan`
picks: ``"wgmma"`` (TMA + wgmma, the forward's conditions), ``"mma"``
(mma.sync for the other bf16 and f16 shapes), ``"f32"`` and ``"wide"``
(f32 FMAs; above 128 columns in 128-column chunks). A kv head's gradient
is summed over its query heads in a fixed order (no atomics, bitwise
reproducible). :func:`bwd_bound_ms` counts the five products the gradient
needs (seven, the routes' own floor, with ``products=7``),
:func:`bwd_error_bound` its tolerance.

Dispatch is by the tensors' device: CUDA tensors launch the kernel (built
with nvcc at first use, loaded with ctypes), CPU tensors take the plain
versions ``ref.flash_attention`` and ``ref.flash_attention_bwd``. There is
no fallback: a missing nvcc, a failed build, an input the kernels do not
take (another dtype, a view that is not contiguous) or a refused launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from . import ref
from ._args import count_launch, plain, cuda_only
from ._build import build_cuda
from .contracts import (ANY_FLOAT, BF16, F32, SMEM_PER_SM, ArraySpec,
                        kernel_contract)

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_BWD_SRC = _SRC.with_name("flash_attention_bwd.cu")

#: H100 SXM peaks (NVIDIA's data sheet, dense): the bound's denominators
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
SM_COUNT = 132

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
            ("flash_attention_launch", [ptr] * 7 + [i32] * 15 + [ptr]),
            ("flash_attention_simt_launch", [ptr] * 5 + [i32] * 11 + [ptr]),
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


def smem_bytes(p: Plan) -> int:
    """Dynamic shared memory of one block of a launch on ``p``'s route
    (csrc/flash_attention.cu): the wgmma route's q tile and two stages of
    k and v boxes (``WgCfg<dhp>``: 80 KB per 64 columns, 1 KB for
    alignment), the mma and split routes' k/v ring (``MmaCfg<dhp>``:
    ``MMA_STAGES`` tiles of 64 keys, rows padded by 8), nothing on the
    SIMT routes (static tiles) or in the splits' merge."""
    if p.route == "wgmma":
        return (p.dhp // 64) * 5 * ROUTE_TILES["wgmma"][0] * 128 + 1024
    if p.route in ("mma", "split"):
        return MMA_STAGES * 2 * ROUTE_TILES["split"][1] * (p.dhp + 8) * 2
    return 0


#: the probe's shared memory: ``WgCfg<128>``'s q tile and one k and one v
#: tile
PROBE_SMEM = 3 * 2 * ROUTE_TILES["wgmma"][0] * 128 + 1024


def _flash_smem(v: dict) -> int:
    """The shared memory of :func:`flash_attention`'s launch on its
    arguments."""
    q, k = v["q"], v["k"]
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    t_real = T if v["t_real"] is None else int(v["t_real"])
    dtype = torch.float32 if q.dtype == torch.float64 else q.dtype
    return smem_bytes(plan(B, S, H, Hkv, t_real, v["causal"],
                           kernel_width(dh), dtype))


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


@kernel_contract(
    in_specs={"q": ArraySpec(("B", "S", "H", "dh"), ANY_FLOAT),
              "k": ArraySpec(("B", "T", "Hkv", "dh"), ANY_FLOAT),
              "v": ArraySpec(("B", "T", "Hkv", "dh"), ANY_FLOAT)},
    out_specs=(ArraySpec(("B", "S", "H", "dh"), ANY_FLOAT),
               ArraySpec(("B", "H", "S"), F32)),
    smem_bound=_flash_smem)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, t_real: int | None = None,
                    return_lse: bool = False):
    """(B, S, H, dh) attention of ``q`` over the first ``t_real`` (default
    T) of ``k``, ``v`` (B, T, Hkv, dh), in q's dtype (a new tensor). With
    ``return_lse``, ``(o, lse)``: ``lse`` (B, H, S) f32 is each row's
    log-sum-exp of its scaled scores (natural log; +inf for a row that
    attends no key), written by the same launch, which
    :func:`flash_attention_bwd` takes. Without it the kernel writes none.

    ``flash_attention.launches`` counts kernel launches (one per call that
    launches; CPU calls and empty outputs launch nothing), and
    ``flash_attention.routes`` the same launches by :func:`plan`'s
    route."""
    t_real = k.shape[1] if t_real is None else int(t_real)
    _check(q, k, v, t_real)
    if plain(q.device):
        return ref.flash_attention(q, k, v, causal=causal, t_real=t_real,
                                   return_lse=return_lse)
    cuda_only(q.device, "flash_attention")
    _kernel_check(q, k, v)
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out_dtype = q.dtype
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.numel() == 0:
        return (torch.empty_like(q), lse) if return_lse else \
            torch.empty_like(q)
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
                lse.data_ptr() if return_lse else None,
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
                lse.data_ptr() if return_lse else None,
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
    o = o.to(out_dtype)
    return (o, lse) if return_lse else o


def reset_counts() -> None:
    """Set ``flash_attention.launches`` and every count of
    ``flash_attention.routes`` to 0."""
    flash_attention.launches = 0
    flash_attention.routes = dict.fromkeys(ROUTE_TILES, 0)


reset_counts()


@kernel_contract(
    in_specs={"q": ArraySpec((64, 128), BF16),
              "k": ArraySpec((128, 128), BF16),
              "v": ArraySpec((128, 128), BF16)},
    out_specs=(ArraySpec((64, 128), F32), ArraySpec((64, 128), F32)),
    smem_bound=lambda v: PROBE_SMEM)
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


# ----------------------------------------------------------------------
# the gradient (csrc/flash_attention_bwd.cu)
# ----------------------------------------------------------------------

#: the backward's routes (csrc/flash_attention_bwd.cu): "wgmma" (bf16 and
#: f16 at the forward's wgmma conditions), "mma" (the other bf16 and f16
#: shapes), "f32" (f32 and f64 inputs, dh <= 128), "wide" (dh > 128)
BWD_ROUTES = ("wgmma", "mma", "f32", "wide")
#: rows of a dK/dV q/do tile and keys of a dK/dV block on the wgmma route
#: (csrc: W_BR, 2 * W_BK)
BWD_ROW_TILE, BWD_KEYS = 64, 128
#: the fewest dK/dV blocks (one an SM) the wgmma route aims for by
#: splitting a kv head's query heads into head groups, each group's f32
#: partial summed in group order: about two waves. At glm4's causal 4,096
#: on an H100 four groups (256 blocks) ran 1% faster than eight (512;
#: their partials cost 0.03 ms to sum) and 1.5x faster than two (128
#: blocks, under one wave) (PERF.md)
BWD_KV_BLOCKS = 256


class BwdPlan(NamedTuple):
    """How one backward launches: its route, the kernels' head width
    ``dhp``, and on the wgmma route the head groups of the dK/dV blocks
    (``groups``; 1 writes dk and dv without partials)."""
    route: str
    dhp: int
    groups: int = 1


@functools.cache
def _bwd_library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("flash_attention_bwd", [_BWD_SRC],
                    deps=[_SRC.with_name("sm90.cuh")])
    lib = ctypes.CDLL(str(so))
    fn = lib.flash_attention_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    return lib, so


def build_bwd() -> Path:
    """Build the backward kernels' library (if needed) and load it; returns
    its path."""
    return _bwd_library()[1]


@functools.lru_cache(maxsize=4096)
def bwd_plan(B: int, S: int, H: int, Hkv: int, t_real: int, causal: bool,
             dh: int = 128, dtype: torch.dtype = torch.bfloat16) -> BwdPlan:
    """The backward's launch at the head width the kernels get (a multiple
    of 8): ``"wide"`` above 128, ``"f32"`` for f32 and f64, else
    ``"wgmma"`` where the forward takes it (dh 64 or 128, G dividing 128,
    more than 16 rows per (b, kv head)) and ``"mma"`` at the next of 16,
    32, 64, 128 otherwise. On the wgmma route the G query heads of a kv
    head split into the fewest head groups (a power of two of at most 64
    heads each) that give ``BWD_KV_BLOCKS`` dK/dV blocks over the keys
    some position attends (the first ``t_real``, under the causal mask at
    most S), or into G groups."""
    G = H // Hkv
    if dh > WIDEST_HEAD:
        return BwdPlan("wide", dh)
    if dtype in (torch.float32, torch.float64):
        return BwdPlan("f32", dh)
    if dh in WGMMA_WIDTHS and 128 % G == 0 and S * G > WARP_ROWS:
        keys = min(t_real, S) if causal else t_real
        tiles = math.ceil(keys / BWD_KEYS)
        groups = max(1, G // BWD_ROW_TILE)
        while groups < G and B * Hkv * groups * tiles < BWD_KV_BLOCKS:
            groups *= 2
        return BwdPlan("wgmma", dh, groups)
    return BwdPlan("mma", next(w for w in MMA_WIDTHS if w >= dh))


#: csrc/flash_attention_bwd.cu's SIMT routes: the larger of the dq and
#: dK/dV blocks' f32 tiles (``FCfg::KV_SMEM``)
BWD_SIMT_SMEM = 49_664


def bwd_smem_bytes(p: BwdPlan) -> int:
    """Dynamic shared memory of the largest block of a backward on ``p``'s
    route (csrc/flash_attention_bwd.cu): on the wgmma route the dK/dV
    block's k and v, two stages of q and do, and their lse and D
    (``DkvCfg<dhp>``, 64 KB per 64 columns + 2 KB; the dq block's
    ``DqCfg`` is 1 KB less), on the mma route the dK/dV block's
    (``BwdCfg<dhp>::KV_SMEM``), on the SIMT routes ``FCfg``'s."""
    if p.route == "wgmma":
        return (p.dhp // 64) * 65_536 + 2_048
    if p.route == "mma":
        return 512 * (p.dhp + 8) + 512
    return BWD_SIMT_SMEM


def _flash_bwd_smem(v: dict) -> int:
    """The shared memory of :func:`flash_attention_bwd`'s launch on its
    arguments (a forward it launches for a missing lse is counted as a
    call of :func:`flash_attention`)."""
    q, k = v["q"], v["k"]
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    t_real = T if v["t_real"] is None else int(v["t_real"])
    return bwd_smem_bytes(bwd_plan(B, S, H, Hkv, t_real, v["causal"],
                                   kernel_width(dh), q.dtype))


def bwd_bound_ms(B: int, S: int, H: int, Hkv: int, T: int, t_real: int,
                 causal: bool, dh: int = 128, itemsize: int = 2,
                 products: int = 5) -> float:
    """Least time of one backward on an H100: five products of ``2 * dh``
    operations per attended pair and head (q k^T recomputed, do v^T,
    P^T do, dS^T q, dS k) at 989 TFLOP/s (67 for f32 and f64), or q, o, do
    and the first ``t_real`` keys and values read once and dq, dk, dv
    written once at 3.35 TB/s, whichever is larger. ``products=7`` gives
    the routes' own floor: their dq and dk/dv kernels each recompute q k^T
    and do v^T."""
    flops = 2.0 * products * dh * B * H * attended_pairs(S, t_real, causal)
    peak = F32_FLOP_PER_S if itemsize >= 4 else BF16_FLOP_PER_S
    nbytes = itemsize * dh * (4 * B * S * H + 2 * B * (t_real + T) * Hkv)
    return max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3


#: how far the backward's dq, dk, dv may lie from the plain version's,
#: elementwise (:func:`bwd_error_bound`): RTOL of |plain| for the
#: outputs' rounding to bf16 or f16 (the forward's), BWD_ROUNDED of the
#: sum of the absolute terms whose first factor the kernels round to the
#: dtype before their products (P and dS: 2^-9 relative each, so 2^-7 has a
#: margin of 4), and BWD_NOISE of the sums with P (|dP| + |D|) in place of
#: |dS| (f32 rounding inside dP - D, which cancel exactly where a position
#: attends a single key; 2^-16 covers f32 sums of a few hundred terms).
#: The scales come from ``ref.flash_attention_bwd_scales``. f32 inputs are
#: rounded nowhere: BWD_F32_RTOL of |plain| and the noise term.
BWD_ROUNDED, BWD_NOISE = 2.0 ** -7, 2.0 ** -16
BWD_F32_RTOL = 1e-5


def bwd_error_bound(want: torch.Tensor, rounded: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| around one of the plain
    backward's gradients ``want``, in f32, given that gradient's two
    scales from ``ref.flash_attention_bwd_scales``."""
    w = want.float().abs()
    if want.dtype in (torch.float32, torch.float64):
        return BWD_F32_RTOL * w + BWD_NOISE * noise
    return RTOL * w + BWD_ROUNDED * rounded + BWD_NOISE * noise


@kernel_contract(
    in_specs={"q": ArraySpec(("B", "S", "H", "dh"), ANY_FLOAT),
              "k": ArraySpec(("B", "T", "Hkv", "dh"), ANY_FLOAT),
              "v": ArraySpec(("B", "T", "Hkv", "dh"), ANY_FLOAT),
              "o": ArraySpec(("B", "S", "H", "dh"), ANY_FLOAT),
              "do": ArraySpec(("B", "S", "H", "dh"), ANY_FLOAT),
              "lse": ArraySpec(("B", "H", "S"), ANY_FLOAT)},
    out_specs=(ArraySpec(("B", "S", "H", "dh"), ANY_FLOAT),
               ArraySpec(("B", "T", "Hkv", "dh"), ANY_FLOAT),
               ArraySpec(("B", "T", "Hkv", "dh"), ANY_FLOAT),
               ArraySpec(("B", "H", "S"), F32)),
    smem_bound=_flash_bwd_smem)
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = False, t_real: int | None = None,
                        lse: torch.Tensor | None = None):
    """B6's gradient: ``(dq, dk, dv, lse)`` of :func:`flash_attention`
    with output ``o`` (B, S, H, dh), given ``do`` of o's shape and the
    forward's row log-sum-exp ``lse`` (B, H, S) f32 (``return_lse``). dq,
    dk, dv come in their inputs' dtype, keys at or past ``t_real`` get 0;
    the lse used is returned. With ``lse=None`` it comes from one more
    forward launch (counted in ``flash_attention.launches``), or on the CPU
    from the plain version. Deterministic: a kv head's gradient is summed
    over its query heads in a fixed order.

    CPU tensors take ``ref.flash_attention_bwd``; CUDA tensors launch the
    kernels of ``csrc/flash_attention_bwd.cu`` on :func:`bwd_plan`'s route
    (f64 computed in f32, dh zero-padded to a multiple of 8) or raise.
    ``flash_attention_bwd.launches`` counts calls that launch (a D pass and
    the route's kernels each), ``flash_attention_bwd.routes`` the same by
    route."""
    t_real = k.shape[1] if t_real is None else int(t_real)
    _check(q, k, v, t_real)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if o.device != q.device or do.device != q.device:
        raise ValueError("o and do must lie on q's device")
    B, S, H, dh = q.shape
    if lse is not None and (lse.shape != (B, H, S) or lse.device != q.device
                            or not lse.is_floating_point()):
        raise ValueError(f"lse must be a float {(B, H, S)} tensor on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}")
    if plain(q.device):
        return ref.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                       t_real=t_real, lse=lse)
    cuda_only(q.device, "flash_attention backward")
    dtype = q.dtype
    o, do = o.to(dtype).contiguous(), do.to(dtype).contiguous()
    _kernel_check(q, k, v)
    T, Hkv = k.shape[1], k.shape[2]
    if o.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("the flash_attention backward takes 16-byte aligned "
                         "o and do")
    if B * H > 65535:                     # the launch grids' y extent
        raise ValueError(f"B * H = {B * H} exceeds 65,535")
    dev = q.device
    if q.numel() == 0:
        return (torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v),
                torch.empty((B, H, S), dtype=torch.float32, device=dev))
    if lse is None:
        lse = flash_attention(q, k, v, causal=causal, t_real=t_real,
                              return_lse=True)[1]
    lse = lse.float().contiguous()
    if dtype == torch.float64:
        q, k, v, o, do = (x.float() for x in (q, k, v, o, do))
    dhk = kernel_width(dh)
    p = bwd_plan(B, S, H, Hkv, t_real, causal, dhk, q.dtype)
    if dhk != dh:
        q, k, v, o, do = (torch.nn.functional.pad(x, (0, dhk - dh))
                          for x in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dsum = torch.empty_like(lse)
    dk_part = dv_part = None
    if p.route != "wgmma" or p.groups > 1:      # f32 partials per kv head
        parts = p.groups if p.route == "wgmma" else H // Hkv
        dk_part = torch.empty((B, T, Hkv * parts, dhk), dtype=torch.float32,
                              device=dev)
        dv_part = torch.empty_like(dk_part)
    route = {"wgmma": 0, "mma": 1}.get(p.route, 2)
    with torch.cuda.device(dev):
        rc = _bwd_library()[0].flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(),
            None if dk_part is None else dk_part.data_ptr(),
            None if dv_part is None else dv_part.data_ptr(),
            (torch.float32, torch.bfloat16, torch.float16).index(q.dtype),
            route, p.dhp, p.groups, B, S, H, Hkv, T, dhk,
            t_real, int(causal), dh, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention backward launch failed "
                           f"({p.route} route): CUDA error {rc}")
    count_launch(flash_attention_bwd, p.route)
    if dhk != dh:
        dq, dk, dv = (x[..., :dh].contiguous() for x in (dq, dk, dv))
    return dq.to(dtype), dk.to(dtype), dv.to(dtype), lse


def reset_bwd_counts() -> None:
    """Set ``flash_attention_bwd.launches`` and its route counts to 0."""
    flash_attention_bwd.launches = 0
    flash_attention_bwd.routes = dict.fromkeys(BWD_ROUTES, 0)


reset_bwd_counts()
