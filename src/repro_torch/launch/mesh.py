"""Meshes of the port (``repro.launch.mesh``) and the H100's constants.

* :func:`make_production_mesh` describes the reference's production
  meshes, ``('data','model')`` = (16, 16) and ``('pod','data','model')`` =
  (2, 16, 16), as a :class:`MeshShape`: axis names and sizes, no devices
  and no process group. The partition-spec policies
  (``runtime.sharding``) and the dry run's per-device argument bytes read
  it.
* :func:`make_smoke_mesh` is the card's own mesh: a ``(1, 1)``
  ``DeviceMesh`` named ``('data','model')`` over a one-rank process group
  (NCCL on ``"cuda"``, gloo on ``"cpu"``, its rendezvous an in-memory
  ``HashStore``), made at the first call, never at import.
* :func:`make_mesh` joins ``world_size`` processes through a store (a
  ``FileStore`` in the tests) and gives their ``DeviceMesh``. On
  ``"cuda"`` rank r runs on ``cuda:r`` (set before the process group is
  made), one rank per card: more ranks than visible cards raises.

The backend follows the device, with no fallback between them: a CUDA
mesh without a card or without NCCL raises. Every process group gets a
timeout (:data:`COLLECTIVE_TIMEOUT_S`), so a collective that waits on a
lost peer raises instead of hanging.

``HW`` holds the constants of the card the roofline terms divide by
(``launch/roofline.py``): one H100 SXM (NVIDIA's data sheet, dense rates,
at its full power limit of 700 W), with the card's name and power limit
beside them. :func:`hardware` adds the memory that
``torch.cuda.get_device_properties`` reports where a card is present.
"""

from __future__ import annotations

import dataclasses
import datetime
import math

import torch
import torch.distributed as dist

#: seconds a collective (and the rendezvous) may wait before it raises
COLLECTIVE_TIMEOUT_S = 120

HW = {
    "card": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops_bf16": 989e12,     # dense bf16 tensor-core FLOP/s
    "hbm_bw": 3.35e12,             # bytes/s of HBM3
    "link_bw": 450e9,              # NVLink 4, bytes/s per direction
    "hbm_bytes": 80 * 2**30,       # bytes of device memory
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its axis names and sizes alone (no devices, no process
    group): what the spec policies and the argument-byte arithmetic read.
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
    does."""
    axis_names: tuple[str, ...]
    devices_shape: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices_shape))

    @property
    def size(self) -> int:
        return math.prod(self.devices_shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh, described: (16, 16) over
    ``('data','model')``, or (2, 16, 16) over ``('pod','data','model')``
    with ``multi_pod``."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def backend_for(device: str) -> str:
    """``"nccl"`` for ``"cuda"``, ``"gloo"`` for ``"cpu"``; a CUDA device
    without a card or without NCCL raises (no fallback to gloo)."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card; none is visible")
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL; this PyTorch has none")
        return "nccl"
    if device == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("a CPU mesh needs gloo; this PyTorch has none")
        return "gloo"
    raise ValueError(f"a mesh lives on 'cuda' or 'cpu', got {device!r}")


def init_process_group(device: str, store, rank: int,
                       world_size: int) -> None:
    """Join the default process group of ``world_size`` ranks through
    ``store``, on the backend of ``device`` (:func:`backend_for`). A group
    already made is kept if it has this backend and size, and raises
    otherwise."""
    backend = backend_for(device)
    if device == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(
            f"a CUDA mesh of {world_size} ranks puts one rank on each card "
            f"and {torch.cuda.device_count()} are visible: two ranks on one "
            "card would share it, which NCCL refuses (no fallback to gloo)")
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_world_size())
        if have != (backend, world_size):
            raise RuntimeError(f"this process already has a {have[0]} group "
                               f"of {have[1]} ranks; asked for {backend} "
                               f"over {world_size}")
        return
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *,
              device: str, store, rank: int):
    """The ``DeviceMesh`` of ``shape`` over ``axis_names`` on
    ``prod(shape)`` processes that meet through ``store`` (each calls this
    with its own ``rank``)."""
    from torch.distributed.device_mesh import init_device_mesh
    init_process_group(device, store, rank, math.prod(shape))
    return init_device_mesh(device, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


_SMOKE_MESHES: dict = {}


def make_smoke_mesh(device: str = "cuda"):
    """The ``(1, 1)`` mesh over ``('data','model')`` of this process alone
    (the card's mesh on ``"cuda"``; ``"cpu"`` in the tests), made once."""
    if device not in _SMOKE_MESHES:
        _SMOKE_MESHES[device] = make_mesh(
            (1, 1), ("data", "model"), device=device, store=dist.HashStore(),
            rank=0)
    return _SMOKE_MESHES[device]


def hardware() -> dict:
    """:data:`HW`, with ``hbm_bytes`` and ``card`` read from the card where
    one is present."""
    hw = dict(HW)
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        hw.update(hbm_bytes=props.total_memory, card=props.name)
    return hw
