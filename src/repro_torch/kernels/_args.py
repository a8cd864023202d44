"""Argument checks and launch counts shared by the kernel wrappers.

A wrapper hands raw device pointers to a kernel, so it checks what the
kernel assumes (dtype, rank, length, device, contiguity) and raises on
anything else instead of letting the kernel read out of bounds. After a
launch it adds one to its count through :func:`count_launch`.
"""

from __future__ import annotations

import threading

import torch

_COUNT_LOCK = threading.Lock()


def count_launch(fn, route: str | None = None,
                 attr: str = "launches") -> None:
    """Add one to ``fn.launches`` (or to the count ``attr``; and to
    ``fn.routes[route]``) under one lock. Several host threads launch
    kernels (the serving engine's batcher workers, the registry's build and
    refresh workers), and ``+= 1`` on an attribute is a read-modify-write
    that loses counts between threads."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)
        if route is not None:
            fn.routes[route] += 1


def int32_vector(name: str, t: torch.Tensor, length: int | None = None,
                 device: torch.device | None = None) -> torch.Tensor:
    """``t`` as a contiguous int32 vector: an integer tensor is cast (as
    the reference casts its operands), anything else raises."""
    if t.dtype == torch.bool or t.is_floating_point() or t.is_complex():
        raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")
    t = t.to(torch.int32)
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    if length is not None and t.shape[0] != length:
        raise ValueError(f"{name} has length {t.shape[0]}, expected {length}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def int32_array(name: str, t: torch.Tensor, shape: tuple,
                device: torch.device | None = None) -> torch.Tensor:
    """``t`` must be an int32 tensor of ``shape`` on ``device``: nothing
    is cast, since the kernel may write it in place."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    return t


def flag(changed: torch.Tensor, device: torch.device) -> None:
    """``changed`` must be an int32[1] tensor on ``device``."""
    if (changed.dtype != torch.int32 or changed.shape != (1,)
            or changed.device != device):
        raise ValueError(f"changed must be an int32[1] tensor on {device}")


def plain(device: torch.device) -> bool:
    """Whether tensors on ``device`` take a kernel's plain version: CPU
    tensors, where it computes, and ``meta`` tensors (shapes and dtypes
    only: the dry run's trace, ``launch/dryrun.py``), where it computes
    nothing and launches nothing. A CUDA tensor never does."""
    return device.type in ("cpu", "meta")


def cuda_only(device: torch.device, what: str) -> None:
    """Raise unless ``device`` is a CUDA device (CPU and meta tensors never
    get here: the wrappers send them to the plain version first)."""
    if device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {device}")
