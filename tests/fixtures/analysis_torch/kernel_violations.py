"""Seeded kernel-contract violations — parsed by tests, never imported.

Expected findings:
  * launch-contract: a wrapper launching without @kernel_contract (1)
  * launch-rc: a bare launch statement, a code never tested, a code
    returned unbound (3)
  * int32-narrowing: a k_index * n + u product, an int64 cumsum
    narrowed back, an int64 tensor's .int(), an unguarded caster's call
    on a product (4)
  * layout-contract: a float64 node_u, an unprovable node_v, an
    undeclared bogus_plane, the missing arrays (4)
"""

import numpy as np
import torch

from repro_torch.kernels.contracts import ArraySpec, kernel_contract


def _library():
    raise NotImplementedError


def uncontracted(x, out):
    rc = _library()[0].label_prop_round_launch(x.data_ptr(), out.data_ptr())
    if rc:
        raise RuntimeError(f"launch failed: {rc}")
    return out


@kernel_contract(in_specs={"x": ArraySpec(("N",), ("int32",))})
def bare_launch(x):
    _library()[0].degree_count_launch(x.data_ptr())       # launch-rc
    return x


@kernel_contract(in_specs={"x": ArraySpec(("N",), ("int32",))})
def untested(x):
    rc = _library()[0].degree_count_launch(x.data_ptr())  # launch-rc
    print(rc)
    return x


@kernel_contract(in_specs={"x": ArraySpec(("N",), ("int32",))})
def returned(x):
    return _library()[0].degree_count_launch(x.data_ptr())  # launch-rc


def i32(a):
    return np.asarray(a, np.int32)           # an unguarded caster


def packs_slots(k_index, n, u, counts, deg):
    slot = torch.as_tensor(k_index * n + u, dtype=torch.int32)  # narrowing
    rows = np.cumsum(counts.astype(np.int64))
    ptr = rows.astype(np.int32)              # int32-narrowing
    wide = deg.to(torch.int64)
    small = wide.int()                       # int32-narrowing
    packed = i32(k_index * n)                # int32-narrowing
    return slot, ptr, small, packed


def bad_layout(index):
    return {
        "node_u": np.asarray(index.node_u, np.float64),   # layout-contract
        "node_v": index.node_v,                           # layout-contract
        "node_ct": np.zeros(4, np.int32),
        "bogus_plane": np.zeros(4, np.int32),             # layout-contract
    }                                        # + the missing arrays
