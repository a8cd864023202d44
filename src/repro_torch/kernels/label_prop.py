"""B1: one masked min-label propagation round, as a hand-written CUDA kernel.

Replaces the TPU kernel ``label_prop_round`` of
``src/repro/kernels/label_prop.py:70`` (Pallas body
``_label_prop_kernel``). The round is the loop body of the device query
plane's fixpoint (``core/batch_query._component_masks``):

    label[b, x] <- min(label[b, x], label[b, l(x)], label[b, r(x)],
                       label[b, p(x)])          (links masked per query)
    label[b, x] <- min(label[b, x], label_pre[b, label[b, x]])  (jump)

The CUDA source (``csrc/label_prop.cu``) gives one thread to each (b, x)
and reads one buffer while writing another; its header states the
design. It is bound by memory: each round reads 4 (label) + 1 (active)
bytes and writes 4 per element, and reads the 12 link bytes of an
active element only (an inactive one gathers no neighbour), so
``9 * B * N + 12 * active`` bytes over the H100's 3.35 TB/s
(:func:`bound_ms`) — at most 0.8 ms at the served shape B = 256,
N = 505k, when the in-row gathers hit L2.

Dispatch is by the tensors' device: CUDA tensors launch the kernel
(built from source with nvcc at first use, loaded with ctypes), CPU
tensors take the plain version in ``ref.py``. There is no fallback: a
missing nvcc, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from . import ref
from ._args import count_launch
from ._build import build_cuda

_SRC = Path(__file__).resolve().parent / "csrc" / "label_prop.cu"

#: H100 SXM device-memory rate, bytes/s (the bound's denominator)
HBM_BYTES_PER_S = 3.35e12


@functools.cache
def _library() -> tuple[ctypes.CDLL, Path]:
    so = build_cuda("label_prop", [_SRC])
    lib = ctypes.CDLL(str(so))
    fn = lib.label_prop_round_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
    return lib, so


def build() -> Path:
    """Build the kernel's library (if needed) and load it; returns its
    path. Lets a caller pay the build outside a timed region."""
    return _library()[1]


def bound_ms(B: int, N: int, n_active: int) -> float:
    """Least time one round can take on an H100: the bytes it must move
    over the memory rate. Each element's label and active flag are read
    once and its output written once (9 bytes); only the ``n_active``
    active elements need their three links (12 bytes), since an inactive
    one's output depends on its label alone. The ~12 integer operations
    per element are far below the compute roof, so bytes bound it."""
    return (9 * B * N + 12 * n_active) / HBM_BYTES_PER_S * 1e3


def _check(labels, link_l, link_r, link_p, active, changed):
    if labels.dim() != 2:
        raise ValueError(f"labels must be (B, N), got {tuple(labels.shape)}")
    for name, t, dtype in (("labels", labels, torch.int32),
                           ("link_l", link_l, torch.int32),
                           ("link_r", link_r, torch.int32),
                           ("link_p", link_p, torch.int32),
                           ("active", active, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != labels.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != labels "
                             f"{tuple(labels.shape)}")
        if t.device != labels.device:
            raise ValueError(f"{name} on {t.device}, labels on {labels.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (changed.dtype != torch.int32 or changed.shape != (1,)
            or changed.device != labels.device):
        raise ValueError("changed must be an int32[1] tensor on the labels' "
                         "device")


def label_prop_round(labels: torch.Tensor, link_l: torch.Tensor,
                     link_r: torch.Tensor, link_p: torch.Tensor,
                     active: torch.Tensor, *,
                     changed: torch.Tensor) -> torch.Tensor:
    """One (B, N) propagation + jump round; int32 out, a new tensor.

    ``changed`` (int32[1]) is set to 1 when any label changed and left
    untouched otherwise: the caller zeroes it before the round.
    ``label_prop_round.launches`` counts kernel launches (CPU calls
    launch nothing and count nothing)."""
    _check(labels, link_l, link_r, link_p, active, changed)
    if labels.device.type == "cpu":
        out = ref.label_prop_round(labels, link_l, link_r, link_p, active)
        if bool((out != labels).any()):
            changed.fill_(1)
        return out
    if labels.device.type != "cuda":
        raise ValueError(f"no label_prop kernel for device {labels.device}")
    B, N = labels.shape
    out = torch.empty_like(labels)
    if out.numel() == 0:
        return out
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library()[0].label_prop_round_launch(
            labels.data_ptr(), link_l.data_ptr(), link_r.data_ptr(),
            link_p.data_ptr(), active.data_ptr(), out.data_ptr(),
            changed.data_ptr(), B, N, stream)
    if rc:
        raise RuntimeError(f"label_prop_round launch failed: CUDA error {rc}")
    count_launch(label_prop_round)
    return out


label_prop_round.launches = 0
