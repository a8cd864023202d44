"""Clean kernel-contract usage — the negatives: none of this may be
flagged."""

import numpy as np
import torch

from repro_torch.kernels.contracts import ArraySpec, kernel_contract


class LayoutOverflow(OverflowError):
    pass


def _library():
    raise NotImplementedError


def _i32(a):
    """The checked caster: raises before it narrows."""
    a = np.asarray(a)
    if a.size and (a.max() > 2**31 - 1 or a.min() < -2**31):
        raise LayoutOverflow("does not fit int32")
    return a.astype(np.int32)


@kernel_contract(in_specs={"x": ArraySpec(("N",), ("int32",))},
                 smem_bound=lambda v: 0)
def launches(x, out):
    with torch.cuda.device(x.device):
        rc = _library()[0].degree_count_launch(x.data_ptr(), out.data_ptr())
    if rc:
        raise RuntimeError(f"degree_count launch failed: CUDA error {rc}")
    return out


@kernel_contract(in_specs={"a": ArraySpec(("M",), ("int32",))})
def launches_twice(a, split):
    lib = _library()[0]
    rc = lib.matmul_f32_launch(a.data_ptr())
    if not rc and split:
        rc = lib.splitk_reduce_launch(a.data_ptr())
    if rc:
        raise RuntimeError(f"matmul launch failed: CUDA error {rc}")
    return a


def casts_safely(k_index, n, u, ids):
    slot = _i32(k_index * n + u)             # through the checked caster
    small = ids.to(torch.int32)              # dtype unknown: no claim
    arange = torch.arange(n, dtype=torch.int32)
    return slot, small, arange


def good_layout(index):
    pad0 = np.zeros((1,), np.int32)
    padn = np.full((1,), -1, np.int32)
    return {
        "node_u": _i32(index.node_u),
        "node_v": _i32(index.node_v),
        "node_ct": _i32(index.node_ct) if index.node_ct.size else pad0,
        "live_from": pad0, "live_to": pad0, "row_ptr": pad0,
        "ent_ts": pad0, "ent_left": padn, "ent_right": padn,
        "ent_parent": padn, "vrow_ptr": pad0, "vent_ts": pad0,
        "vent_node": padn, "ver_ts_from": np.ones((1,), np.int32),
        "ver_ts_to": pad0, "ver_ct": pad0, "ver_src": pad0,
        "ver_k": np.full(3, 2, np.int32),
    }
