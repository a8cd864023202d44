"""ctypes loader for the native ECB forest engine (``_ecb_native.c``).

The stratified index plane builds |K| forests per cold build, and the
builder's zipper cascade is a scalar pointer chase that the Python
builders (`IncrementalBuilder`, `FastIncrementalBuilder`) execute at
interpreter speed. This module compiles the same algorithm — a
line-for-line port — with the host C compiler on first use into the
port's build directory (``kernels/_build.py``: keyed by a hash of source
and command, never shared with the reference package's cached library),
and exposes it behind :class:`NativeForestBuilder`, which duck-types the
slice of the builder surface ``pack_index`` consumes.

This is a host accelerator, not a device kernel: no C compiler or a
failed build degrades to ``available() -> False`` and the caller
(``build_stratified_index``) uses the Python fast builder. Output
equivalence is not a risk surface: ``pack_index`` canonicalizes entry
order, and tests assert the packed index is bit-identical across the
builders.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from ..kernels._build import build_library
from .core_time import CoreTimeTable
from .ecb_forest import ForestInvariantError
from .temporal_graph import TemporalGraph

_SRC = Path(__file__).resolve().parent / "_ecb_native.c"

_lock = threading.Lock()
_lib = None
_tried = False

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _compile_and_load():
    cc = os.environ.get("CC", "cc")
    so = build_library("ecb_native", [_SRC], [cc, "-O2", "-shared", "-fPIC"])
    lib = ctypes.CDLL(str(so))
    lib.ecb_run.restype = ctypes.c_int
    lib.ecb_run.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i32p,                      # esrc, edst
        _i64p, _i64p, _i64p,               # e_sorted, c_sorted, neg_ts
        _i32p, _i32p, _i32p, _i32p,        # n_edge, n_ct, n_u, n_v
        _i64p, _i32p, _i32p,               # n_rank, n_live_from, n_live_to
        _i32p, _i32p, _i32p, _u8p,         # n_parent, n_child0/1, n_in
        ctypes.c_int64, _i32p, _i32p, _i32p, _i32p, _i32p,   # ent buffers
        ctypes.c_int64, _i32p, _i32p, _i32p,                 # vent buffers
        _i64p,                             # out counters
    ]
    return lib


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        try:
            _lib = _compile_and_load()
        except (OSError, RuntimeError):   # no compiler / build or load failed
            _lib = None
        _tried = True
        return _lib


def available() -> bool:
    """True when the compiled engine is loadable on this host."""
    return _load() is not None


class NativeForestBuilder:
    """Builder facade over the native run; exposes exactly the state
    ``pack_index`` reads (plus parent/child arrays for invariant tests),
    with the same semantics as the Python builders after ``run()``."""

    def __init__(self, g: TemporalGraph, tab: CoreTimeTable):
        lib = _load()
        if lib is None:
            raise RuntimeError("native ECB engine unavailable "
                               "(no C compiler, or the build failed)")
        self._lib = lib
        self.g = g
        self.tab = tab
        self.num_nodes = 0

    def run(self) -> "NativeForestBuilder":
        g, tab = self.g, self.tab
        R = tab.num_versions
        order = np.lexsort((tab.edge_id, tab.ct, -tab.ts_to))
        e_sorted = np.ascontiguousarray(tab.edge_id[order], np.int64)
        c_sorted = np.ascontiguousarray(tab.ct[order], np.int64)
        neg_ts = np.ascontiguousarray(-tab.ts_to[order], np.int64)
        esrc = np.ascontiguousarray(g.src, np.int32)
        edst = np.ascontiguousarray(g.dst, np.int32)

        z32 = lambda size: np.zeros(max(size, 1), np.int32)
        self.n_edge, self.n_ct = z32(R), z32(R)
        self.n_u, self.n_v = z32(R), z32(R)
        self.n_rank = np.zeros(max(R, 1), np.int64)
        self.n_live_from, self.n_live_to = z32(R), z32(R)
        n_parent, n_child0, n_child1 = z32(R), z32(R), z32(R)
        n_in = np.zeros(max(R, 1), np.uint8)
        out = np.zeros(3, np.int64)

        ent_cap = 4 * R + 1024
        vent_cap = 2 * R + 2 * g.n + 1024
        for _ in range(2):  # second pass only if the size guess was low
            ent = [z32(ent_cap) for _ in range(5)]
            vent = [z32(vent_cap) for _ in range(3)]
            rc = self._lib.ecb_run(
                g.n, tab.t_max, np.int64(g.m + 1), R,
                esrc, edst, e_sorted, c_sorted, neg_ts,
                self.n_edge, self.n_ct, self.n_u, self.n_v,
                self.n_rank, self.n_live_from, self.n_live_to,
                n_parent, n_child0, n_child1, n_in,
                ent_cap, *ent, vent_cap, *vent, out)
            if rc != 1:
                break
            ent_cap, vent_cap = int(out[1]), int(out[2])
        if rc == 3:
            raise MemoryError("native ECB engine out of memory")
        if rc:
            raise ForestInvariantError(
                f"native ECB engine failed with code {rc}")
        N = int(out[0])
        self.num_nodes = N
        self.n_parent = n_parent
        self.n_child = np.stack([n_child0, n_child1], axis=1)
        self.n_in = n_in.astype(bool)
        ne, nv = int(out[1]), int(out[2])
        (self.ent_node, self.ent_ts, self.ent_l, self.ent_r,
         self.ent_p) = (a[:ne] for a in ent)
        self.vent_vert, self.vent_ts, self.vent_node = (a[:nv] for a in vent)
        return self
