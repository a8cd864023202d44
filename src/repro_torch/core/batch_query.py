"""Batched TCCS query engine on the GPU (device plane; DESIGN.md §3, §8).

PyTorch port of ``repro.core.batch_query``. Algorithm 1 answers one query
by chasing pointers on the host; the device plane answers a whole batch
``(u_b, ts_b, te_b)`` at once against the packed PECB arrays:

1. **Entry points** — the per-vertex lookup (Alg 1 line 3) becomes a
   vectorized lower-bound binary search over the per-vertex version CSR.
2. **Link resolution** — the per-node binary search (Alg 1 line 10)
   becomes a ``(B, N)`` vectorized lower bound over the per-node entry
   CSR: for every query b and forest node x, (left, right, parent) at
   ``ts_b``, all queries and nodes in parallel.
3. **Traversal** — BFS becomes masked min-label propagation with pointer
   jumping over the (<= 3-regular) forest links, iterated to a fixpoint.
   Each round is one launch of the hand-written CUDA kernel
   ``kernels.label_prop.label_prop_round`` (its plain version on CPU
   tensors); the kernel raises a device "changed" flag that the host loop
   reads once per round. :func:`run_sharded` runs one batch per shard
   (each on its own replica of the index, :func:`replicas_of`) in
   lockstep from one thread, each shard to its own fixpoint.

A node participates for query b iff ``live_from <= ts_b <= live_to`` and
``ct <= te_b``: the stale entries of expired nodes are masked explicitly.

Round semantics differ from the reference's inline jnp round, which jumps
from the post-round labels; the kernel jumps from the pre-round labels.
Both converge to the same labels (each node's label becomes the least id
reachable over its valid links), so the masks agree bit for bit while the
round counts may differ.

:func:`batch_query_full` / :func:`batch_query_full_mixed` also derive the
``(B, V)`` core-time version membership (the EDGES/SUBGRAPH payload), and
:func:`window_sweep` answers one vertex over W windows in one batch.
Entry points take a :class:`DeviceIndex` whose tensors live on the device
that runs the batch; query tensors must be int32 on that device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import contracts as kernel_contracts
from ..kernels.ops import label_prop_round
from .pecb_index import StratifiedPECB

NONE = -1

_I32_MIN = np.iinfo(np.int32).min
_I32_MAX = np.iinfo(np.int32).max


class LayoutOverflowError(OverflowError):
    """A device-layout value does not fit int32.

    The packed layout keeps every array int32 on device (half the
    transfer and memory footprint of int64), which is only sound while the
    global id/offset space — the stratified ``K*n+1`` row-pointer rows,
    the fused entry offsets, the ``k_index*n + u`` query slots — stays
    below 2**31. The layout builders compute in int64 and narrow through
    :func:`_i32`, which raises this at *build* time instead of letting
    the device index silently wrap."""


def _i32(a, what: str = "array") -> np.ndarray:
    """Checked int32 narrowing for layout arrays."""
    arr = np.asarray(a)
    if arr.size:
        mx, mn = int(arr.max()), int(arr.min())
        if mx > _I32_MAX or mn < _I32_MIN:
            raise LayoutOverflowError(
                f"{what}: value range [{mn}, {mx}] exceeds int32; the "
                "packed device layout cannot address this index — shard "
                "the workload or shrink the stratum set")
    return arr.astype(np.int32, copy=False)


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    """PECB arrays as int32 tensors on one device + static metadata."""

    n: int
    t_max: int
    node_u: torch.Tensor
    node_v: torch.Tensor
    node_ct: torch.Tensor
    live_from: torch.Tensor
    live_to: torch.Tensor
    row_ptr: torch.Tensor
    ent_ts: torch.Tensor
    ent_left: torch.Tensor
    ent_right: torch.Tensor
    ent_parent: torch.Tensor
    vrow_ptr: torch.Tensor
    vent_ts: torch.Tensor
    vent_node: torch.Tensor
    # core-time version arrays (EDGES/SUBGRAPH modes), padded to length
    # >= 1 with inert records (ts_from=1, ts_to=0)
    ver_ts_from: torch.Tensor
    ver_ts_to: torch.Tensor
    ver_ct: torch.Tensor
    ver_src: torch.Tensor
    ver_k: torch.Tensor       # per-version stratum k
    max_node_entries: int     # longest per-node entry list
    max_vert_entries: int     # longest per-vertex entry list
    num_versions: int         # true version count (pre-padding)

    @property
    def num_nodes(self) -> int:
        return int(self.node_u.shape[0])

    @property
    def device(self) -> torch.device:
        return self.node_u.device

    def nbytes(self) -> int:
        """Device bytes held by the index tensors."""
        return sum(getattr(self, f).nbytes for f in _ARRAY_FIELDS)


#: the tensors of a DeviceIndex, in the order of the declared layout
#: (``kernels.contracts.LAYOUT_CONTRACTS``: each int32, rank 1)
_ARRAY_FIELDS = tuple(kernel_contracts.LAYOUT_CONTRACTS)
_META_FIELDS = ("n", "t_max", "max_node_entries", "max_vert_entries",
                "num_versions")


def _host_layout(index):
    """(meta dict, name -> int32 host array) in the device layout,
    including the length->=1 inert padding of optional arrays.

    Accepts a per-k :class:`PECBIndex` or a whole :class:`StratifiedPECB`
    (routed to :func:`_host_layout_stratified`: all strata in one global
    id space, servable by the same batch functions)."""
    if isinstance(index, StratifiedPECB):
        return _host_layout_stratified(index)
    i32 = _i32
    seg = np.diff(index.row_ptr)
    vseg = np.diff(index.vrow_ptr)
    store = index.versions
    has_vers = store is not None and store.num_versions > 0
    pad0 = np.zeros((1,), np.int32)
    padn = np.full((1,), NONE, np.int32)
    arrays = {
        "node_u": i32(index.node_u),
        "node_v": i32(index.node_v),
        "node_ct": i32(index.node_ct),
        "live_from": i32(index.node_live_from),
        "live_to": i32(index.node_live_to),
        "row_ptr": i32(index.row_ptr),
        "ent_ts": i32(index.ent_ts) if index.ent_ts.size else pad0,
        "ent_left": i32(index.ent_left) if index.ent_left.size else padn,
        "ent_right": i32(index.ent_right) if index.ent_right.size else padn,
        "ent_parent": i32(index.ent_parent) if index.ent_parent.size else padn,
        "vrow_ptr": i32(index.vrow_ptr),
        "vent_ts": i32(index.vent_ts) if index.vent_ts.size else pad0,
        "vent_node": i32(index.vent_node) if index.vent_node.size else padn,
        "ver_ts_from": i32(store.ts_from) if has_vers else np.ones((1,), np.int32),
        "ver_ts_to": i32(store.ts_to) if has_vers else pad0,
        "ver_ct": i32(store.ct) if has_vers else pad0,
        "ver_src": i32(store.src) if has_vers else pad0,
        "ver_k": (np.full(store.num_versions, index.k, np.int32)
                  if has_vers else pad0),
    }
    meta = {
        "n": index.n,
        "t_max": index.t_max,
        "max_node_entries": int(seg.max()) if seg.size else 0,
        "max_vert_entries": int(vseg.max()) if vseg.size else 0,
        "num_versions": store.num_versions if has_vers else 0,
    }
    return meta, arrays


def _host_layout_stratified(sx: StratifiedPECB):
    """Device layout for a whole k-stratified index.

    The per-stratum blocks are fused into ONE global node/entry id space:
    node ids shift by ``knode_ptr[ki]``, the per-stratum CSRs re-base onto
    the concatenated entry arrays, and per-vertex lookup becomes a lookup
    on the *slot* ``ki * n + u`` (``vrow_ptr`` has ``|K|*n+1`` rows). The
    strata stay link-disjoint, so :func:`batch_query`'s min-label
    propagation serves a mixed-k batch unchanged — per-query k enters only
    as the host-computed entry slot, plus the ``ver_k == kq`` filter of
    :func:`batch_query_full_mixed` (the version arrays are the one place
    where records of different strata share an index space).
    """
    i32 = _i32
    K = len(sx.ks)
    n = sx.n
    Ntot = sx.num_nodes
    Etot = int(sx.ent_ts.shape[0])
    VEtot = int(sx.vent_ts.shape[0])

    row_ptr = np.empty(Ntot + 1, np.int64)
    vrow_ptr = np.empty(K * n + 1, np.int64)
    ent_l = sx.ent_left.astype(np.int64)
    ent_r = sx.ent_right.astype(np.int64)
    ent_p = sx.ent_parent.astype(np.int64)
    vent_node = sx.vent_node.astype(np.int64)
    for ki in range(K):
        s, e = int(sx.knode_ptr[ki]), int(sx.knode_ptr[ki + 1])
        row_ptr[s:e] = (sx.row_ptr[s + ki:e + ki].astype(np.int64)
                        + int(sx.kent_ptr[ki]))
        vrow_ptr[ki * n:(ki + 1) * n] = (
            sx.vrow_ptr[ki * (n + 1):ki * (n + 1) + n].astype(np.int64)
            + int(sx.kvent_ptr[ki]))
        off = int(sx.knode_ptr[ki])
        if off:
            for seg in (ent_l[int(sx.kent_ptr[ki]):int(sx.kent_ptr[ki + 1])],
                        ent_r[int(sx.kent_ptr[ki]):int(sx.kent_ptr[ki + 1])],
                        ent_p[int(sx.kent_ptr[ki]):int(sx.kent_ptr[ki + 1])],
                        vent_node[int(sx.kvent_ptr[ki]):
                                  int(sx.kvent_ptr[ki + 1])]):
                seg[seg >= 0] += off
    row_ptr[Ntot] = Etot
    vrow_ptr[K * n] = VEtot

    st = sx.strata
    V = int(st.num_versions) if st is not None else 0
    seg = np.diff(row_ptr)
    vseg = np.diff(vrow_ptr)
    pad0 = np.zeros((1,), np.int32)
    padn = np.full((1,), NONE, np.int32)
    arrays = {
        "node_u": i32(sx.node_u),
        "node_v": i32(sx.node_v),
        "node_ct": i32(sx.node_ct),
        "live_from": i32(sx.node_live_from),
        "live_to": i32(sx.node_live_to),
        "row_ptr": _i32(row_ptr, "fused entry row_ptr"),
        "ent_ts": i32(sx.ent_ts) if Etot else pad0,
        "ent_left": i32(ent_l) if Etot else padn,
        "ent_right": i32(ent_r) if Etot else padn,
        "ent_parent": i32(ent_p) if Etot else padn,
        "vrow_ptr": _i32(vrow_ptr, "fused K*n vertex row_ptr"),
        "vent_ts": i32(sx.vent_ts) if VEtot else pad0,
        "vent_node": i32(vent_node) if VEtot else padn,
        "ver_ts_from": i32(st.ts_from) if V else np.ones((1,), np.int32),
        "ver_ts_to": i32(st.ts_to) if V else pad0,
        "ver_ct": i32(st.ct) if V else pad0,
        "ver_src": i32(sx.ver_src) if V else pad0,
        "ver_k": (np.repeat(np.asarray(sx.ks, np.int32),
                            np.diff(st.kptr)).astype(np.int32)
                  if V else pad0),
    }
    meta = {
        "n": n,
        "t_max": sx.t_max,
        "max_node_entries": int(seg.max()) if seg.size else 0,
        "max_vert_entries": int(vseg.max()) if vseg.size else 0,
        "num_versions": V,
    }
    return meta, arrays


def device_index(meta: dict, arrays: dict, device="cuda") -> DeviceIndex:
    """A :class:`DeviceIndex` on ``device`` from a host layout (the meta
    dict and the name -> array dict of :func:`_host_layout`)."""
    device = torch.device(device)
    return DeviceIndex(
        **{f: int(meta[f]) for f in _META_FIELDS},
        **{f: torch.as_tensor(np.ascontiguousarray(_i32(arrays[f], f)),
                              device=device)
           for f in _ARRAY_FIELDS})


def _witness_layout(arrays: dict) -> None:
    """While the kernel witness is armed, check a host layout against the
    declared table (``kernels.contracts.check_layout``) before it is
    uploaded."""
    if kernel_contracts.witness_enabled():
        kernel_contracts.check_layout(arrays,
                                      witness=kernel_contracts.WITNESS)


def to_device(index, device="cuda") -> DeviceIndex:
    """Upload a :class:`PECBIndex` or a whole :class:`StratifiedPECB`
    (mixed-k servable) to ``device``."""
    meta, arrays = _host_layout(index)
    _witness_layout(arrays)
    return device_index(meta, arrays, device=device)


def refresh_device(prev_host, prev_dev: DeviceIndex,
                   new_host) -> tuple[DeviceIndex, dict]:
    """Refresh a device mirror across a streaming epoch, re-uploading only
    what changed.

    ``prev_host``/``new_host`` are the old and new :class:`PECBIndex` or
    :class:`StratifiedPECB`; ``prev_dev`` is the old mirror, whose device
    receives every upload. Per array (compared in the shared host layout,
    :func:`_host_layout`): if the new array equals the old one, the
    resident tensor itself is handed over (zero transfer, same storage);
    if the old array is a strict prefix of the new one (a pure suffix
    grow), only the suffix is uploaded and ``torch.cat``-ed to the old
    tensor on the device; otherwise the array is uploaded in full. The
    old mirror is never mutated, so batches still running on it stay
    exact. Always exact: the result equals ``to_device(new_host)`` array
    for array (test-asserted). The returned stats (``reused``/``suffix``/
    ``full`` counts, ``reused_bytes``, ``uploaded_bytes``) make the
    transfer observable; ``freed_bytes`` is the net device memory a swap
    returns (old mirror bytes minus new, 0 when the mirror grows), as in
    a retention epoch, whose shifted arrays all take the full path.
    """
    _, old_arrays = _host_layout(prev_host)
    meta, new_arrays = _host_layout(new_host)
    _witness_layout(new_arrays)
    return _refresh(meta, old_arrays, new_arrays, prev_dev)


def _refresh(meta: dict, old_arrays: dict, new_arrays: dict,
             prev_dev: DeviceIndex) -> tuple[DeviceIndex, dict]:
    """:func:`refresh_device` on host layouts already taken."""
    device = prev_dev.device
    stats = {"reused": 0, "suffix": 0, "full": 0,
             "reused_bytes": 0, "uploaded_bytes": 0, "freed_bytes": 0}
    old_total = sum(int(a.nbytes) for a in old_arrays.values())
    new_total = sum(int(a.nbytes) for a in new_arrays.values())
    stats["freed_bytes"] = max(0, old_total - new_total)
    arrays = {}
    for name in _ARRAY_FIELDS:
        old_np, new_np = old_arrays[name], new_arrays[name]
        old_dev = getattr(prev_dev, name)
        resident = tuple(old_dev.shape) == old_np.shape
        if (old_np.shape == new_np.shape and resident
                and np.array_equal(old_np, new_np)):
            arrays[name] = old_dev
            stats["reused"] += 1
            stats["reused_bytes"] += int(new_np.nbytes)
        elif (old_np.shape[0] < new_np.shape[0] and resident
              and np.array_equal(old_np, new_np[:old_np.shape[0]])):
            suffix = _i32(new_np[old_np.shape[0]:], name)
            arrays[name] = torch.cat([old_dev, torch.as_tensor(
                np.ascontiguousarray(suffix), device=device)])
            stats["suffix"] += 1
            stats["reused_bytes"] += int(old_np.nbytes)
            stats["uploaded_bytes"] += int(suffix.nbytes)
        else:
            arrays[name] = torch.as_tensor(
                np.ascontiguousarray(_i32(new_np, name)), device=device)
            stats["full"] += 1
            stats["uploaded_bytes"] += int(new_np.nbytes)
    return DeviceIndex(**{f: int(meta[f]) for f in _META_FIELDS},
                       **arrays), stats


def replicate(dix: DeviceIndex, device) -> DeviceIndex:
    """A copy of ``dix`` with its own storage on ``device`` (``dix``'s own
    device included): array for array equal to ``to_device`` there of the
    index ``dix`` mirrors. Card to card where both are cards, with no
    host round trip."""
    device = torch.device(device)
    return dataclasses.replace(
        dix, **{f: getattr(dix, f).to(device, copy=True)
                for f in _ARRAY_FIELDS})


def replicas_of(dix: DeviceIndex, devices) -> tuple[DeviceIndex, ...]:
    """One replica per shard of a sharded mirror: ``dix`` itself for the
    first device (which must be ``dix``'s) and a :func:`replicate` for
    each further entry of ``devices``, repeated devices included."""
    devices = [torch.device(d) for d in devices]
    if devices[0] != dix.device:
        raise ValueError(f"the first replica lives on {dix.device}, the "
                         f"first shard on {devices[0]}")
    return (dix, *(replicate(dix, d) for d in devices[1:]))


def refresh_replicas(prev_host, prev_replicas, new_host
                     ) -> tuple[tuple[DeviceIndex, ...], dict]:
    """:func:`refresh_device` for every replica of a sharded mirror, all
    made before any is returned, so that a caller swaps one epoch onto
    every shard at once.

    The first replica is refreshed. Each further one either gets the same
    refresh (it uploads only what changed and hands over its own
    unchanged tensors) or a :func:`replicate` of the new first replica,
    whichever moves fewer bytes: the refresh while it uploads less than
    the whole mirror, else the card-to-card copy. The byte counts sum over
    the replicas (``replicated_bytes``: the copies'); the counts of
    ``reused``/``suffix``/``full`` arrays are the first replica's."""
    _, old_arrays = _host_layout(prev_host)
    meta, new_arrays = _host_layout(new_host)
    _witness_layout(new_arrays)
    first, stats = _refresh(meta, old_arrays, new_arrays, prev_replicas[0])
    stats["replicated_bytes"] = 0
    out = [first]
    by_refresh = stats["uploaded_bytes"] < first.nbytes()
    for prev in prev_replicas[1:]:
        if by_refresh:
            rep, more = _refresh(meta, old_arrays, new_arrays, prev)
            for key in ("reused_bytes", "uploaded_bytes", "freed_bytes"):
                stats[key] += more[key]
        else:
            rep = replicate(first, prev.device)
            stats["replicated_bytes"] += rep.nbytes()
            stats["freed_bytes"] += max(0, prev.nbytes() - rep.nbytes())
        out.append(rep)
    return tuple(out), stats


def stratum_device(dix: DeviceIndex, sx: StratifiedPECB,
                   k: int) -> DeviceIndex:
    """Carve ONE stratum's block out of a fused stratified device mirror.

    A single-k batch (the window sweep) pays propagation cost on every
    forest node of the mirror it runs against — on the fused mixed-k
    mirror, every stratum's nodes. This slices the ``[knode_ptr[ki],
    knode_ptr[ki+1])`` node block plus its entry / vertex-entry / version
    segments into a standalone per-k :class:`DeviceIndex` (device slices,
    no host round trip), with forest-node links rebased into the block's
    local id space. Array-for-array equal to ``to_device(sx.slice_k(k))``
    (test-asserted); the ``max_*_entries`` meta keeps the fused mirror's
    values — a valid upper bound costing at most a few extra
    binary-search steps.
    """
    ki = sx.k_index(k)
    n = dix.n
    nlo, nhi = int(sx.knode_ptr[ki]), int(sx.knode_ptr[ki + 1])
    elo, ehi = int(sx.kent_ptr[ki]), int(sx.kent_ptr[ki + 1])
    vlo, vhi = int(sx.kvent_ptr[ki]), int(sx.kvent_ptr[ki + 1])
    st = sx.strata
    slo, shi = ((int(st.kptr[ki]), int(st.kptr[ki + 1]))
                if st is not None else (0, 0))
    dev = dix.device
    pad0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    padn = torch.full((1,), NONE, dtype=torch.int32, device=dev)

    def rebase(seg):
        # node links are global forest ids; -1 stays the no-link sentinel
        return torch.where(seg >= 0, seg - nlo, seg) if nlo else seg

    has_ent, has_vent, has_ver = ehi > elo, vhi > vlo, shi > slo
    return DeviceIndex(
        n=n, t_max=dix.t_max,
        node_u=dix.node_u[nlo:nhi],
        node_v=dix.node_v[nlo:nhi],
        node_ct=dix.node_ct[nlo:nhi],
        live_from=dix.live_from[nlo:nhi],
        live_to=dix.live_to[nlo:nhi],
        row_ptr=dix.row_ptr[nlo:nhi + 1] - elo,
        ent_ts=dix.ent_ts[elo:ehi] if has_ent else pad0,
        ent_left=rebase(dix.ent_left[elo:ehi]) if has_ent else padn,
        ent_right=rebase(dix.ent_right[elo:ehi]) if has_ent else padn,
        ent_parent=rebase(dix.ent_parent[elo:ehi]) if has_ent else padn,
        vrow_ptr=dix.vrow_ptr[ki * n:(ki + 1) * n + 1] - vlo,
        vent_ts=dix.vent_ts[vlo:vhi] if has_vent else pad0,
        vent_node=rebase(dix.vent_node[vlo:vhi]) if has_vent else padn,
        ver_ts_from=(dix.ver_ts_from[slo:shi] if has_ver
                     else torch.ones((1,), dtype=torch.int32, device=dev)),
        ver_ts_to=dix.ver_ts_to[slo:shi] if has_ver else pad0,
        ver_ct=dix.ver_ct[slo:shi] if has_ver else pad0,
        ver_src=dix.ver_src[slo:shi] if has_ver else pad0,
        ver_k=dix.ver_k[slo:shi] if has_ver else pad0,
        max_node_entries=dix.max_node_entries,
        max_vert_entries=dix.max_vert_entries,
        num_versions=shi - slo,
    )


def _lower_bound(ts_arr: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 target: torch.Tensor, steps: int) -> torch.Tensor:
    """Vectorized lower_bound: smallest i in [lo, hi) with ts_arr[i] >= target.

    ``lo``/``hi``/``target`` broadcast to one shape; returns hi when no
    element qualifies. ``steps`` must be >= ceil(log2(max segment))."""
    size = ts_arr.shape[0]
    for _ in range(max(steps, 1)):
        mid = (lo + hi) // 2
        go_right = (ts_arr[mid.clamp(0, size - 1)] < target) & (mid < hi)
        lo = torch.where(go_right & (lo < hi), mid + 1, lo)
        hi = torch.where(~go_right & (lo < hi), mid, hi)
    return lo


def _entry_steps(dix: DeviceIndex) -> tuple[int, int]:
    vsteps = int(np.ceil(np.log2(max(dix.max_vert_entries, 1) + 1))) + 1
    nsteps = int(np.ceil(np.log2(max(dix.max_node_entries, 1) + 1))) + 1
    return vsteps, nsteps


def _entry_nodes(dix: DeviceIndex, vlo, vhi, ts, te):
    """Resolve entry nodes given per-query vertex CSR bounds (Alg 1 line 3).
    Returns (e0_ok, e0c): validity mask + clipped entry node ids."""
    vsteps, _ = _entry_steps(dix)
    N = dix.num_nodes
    vi = _lower_bound(dix.vent_ts, vlo, vhi, ts, vsteps)
    has_entry = vi < vhi
    e0 = torch.where(has_entry,
                     dix.vent_node[vi.clamp(0, dix.vent_ts.shape[0] - 1)],
                     NONE)
    e0c = e0.clamp(0, N - 1)
    e0_ok = has_entry & (e0 >= 0) & (dix.node_ct[e0c] <= te)
    return e0_ok, e0c


def _resolve_links(dix: DeviceIndex, ts, te):
    """Steps 2-3: per-(query, node) links at ``ts_b`` and activity.
    Returns int32 (B, N) ``link_l, link_r, link_p`` and bool (B, N)
    ``active``, all contiguous: the operands of the propagation rounds."""
    B = ts.shape[0]
    N = dix.num_nodes
    _, nsteps = _entry_steps(dix)
    idx = _lower_bound(dix.ent_ts, dix.row_ptr[:-1].expand(B, N),
                       dix.row_ptr[1:].expand(B, N), ts[:, None], nsteps)
    idx = idx.clamp_(0, dix.ent_ts.shape[0] - 1)
    links = (dix.ent_left[idx], dix.ent_right[idx], dix.ent_parent[idx])
    active = ((dix.live_from[None, :] <= ts[:, None])
              & (ts[:, None] <= dix.live_to[None, :])
              & (dix.node_ct[None, :] <= te[:, None]))
    return (*links, active)


def _rounds(link_l, link_r, link_p, active):
    """Step 4 as a generator: min-label propagation to a fixpoint, one B1
    kernel launch per step. Each step yields the round's int32[1] change
    flag and is sent whether the flag was raised; once a round changed
    nothing, the generator returns the converged int32 labels."""
    N = active.shape[1]
    labels = torch.where(
        active,
        torch.arange(N, dtype=torch.int32, device=active.device)[None, :], N)
    changed = torch.zeros(1, dtype=torch.int32, device=active.device)
    # labels only fall, and each changing round brings every node's label
    # one hop closer to its component's least id: N + 1 rounds suffice
    for _ in range(N + 1):
        changed.zero_()
        labels = label_prop_round(labels, link_l, link_r, link_p, active,
                                  changed=changed)
        if not (yield changed):
            return labels
    raise RuntimeError(f"label propagation did not converge in {N + 1} "
                       "rounds: the round kernel is wrong")


def _drive(steps: list) -> tuple[list, list[int]]:
    """Run one step generator per shard in lockstep: round r is launched
    on every shard still changing before any of their flags is read, and
    each flag read is followed at once by that shard's next launch, so
    shards on different cards propagate concurrently. A shard whose flag
    stayed clear gets no further launch and finishes (members, version
    masks) while the others run on. Returns each shard's result and its
    rounds (= its B1 launches; 0 for a shard that did not propagate)."""
    results: list = [None] * len(steps)
    rounds = [0] * len(steps)
    flags: dict = {}
    for i, step in enumerate(steps):
        try:
            flags[i] = next(step)
            rounds[i] = 1
        except StopIteration as done:
            results[i] = done.value
    while flags:
        for i in list(flags):
            # repro: ignore[hot-path-transfer] — the one flag read per round and shard
            changed = bool(flags[i].item())
            try:
                flags[i] = steps[i].send(changed)
                rounds[i] += 1
            except StopIteration as done:
                results[i] = done.value
                del flags[i]
    return results, rounds


def _propagate(link_l, link_r, link_p, active) -> tuple[torch.Tensor, int]:
    """Step 4 on one batch: the converged int32 labels and the round
    count."""
    (labels,), (rounds,) = _drive([_rounds(link_l, link_r, link_p,
                                           active)])
    return labels, rounds


def _members(dix: DeviceIndex, labels, active, e0_ok, e0c) -> torch.Tensor:
    """Step 5: forest node x is a member of query b's component iff it is
    active and ``label[x] == label[entry_b]``; members mark their
    endpoints in the ``bool[B, n]`` vertex mask."""
    root = labels.gather(1, e0c.long()[:, None])
    member = active & (labels == root) & e0_ok[:, None]
    bi, xi = member.nonzero(as_tuple=True)
    out = torch.zeros((labels.shape[0], dix.n), dtype=torch.bool,
                      device=labels.device)
    out[bi, dix.node_u[xi].long()] = True
    out[bi, dix.node_v[xi].long()] = True
    return out


def _component_steps(dix: DeviceIndex, vlo, vhi, ts, te):
    """Steps 1-5 as a generator (see :func:`_rounds`): entry nodes from
    the per-query vertex CSR bounds, links, the rounds; returns the
    ``bool[B, n]`` vertex mask."""
    e0_ok, e0c = _entry_nodes(dix, vlo, vhi, ts, te)
    link_l, link_r, link_p, active = _resolve_links(dix, ts, te)
    labels = yield from _rounds(link_l, link_r, link_p, active)
    return _members(dix, labels, active, e0_ok, e0c)


def _version_member(dix: DeviceIndex, vertex_mask, ts, te):
    """bool[B, V] core-time version membership: version j is a member edge
    for query b iff its record covers ``ts_b``, ``ct_j <= te_b`` and its
    src endpoint is in the component (one gather over the vertex mask)."""
    return ((dix.ver_ts_from[None, :] <= ts[:, None])
            & (ts[:, None] <= dix.ver_ts_to[None, :])
            & (dix.ver_ct[None, :] <= te[:, None])
            & vertex_mask[:, dix.ver_src])


def _empty_masks(dix: DeviceIndex, B: int, full: bool):
    vmask = torch.zeros((B, dix.n), dtype=torch.bool, device=dix.device)
    if not full:
        return vmask
    return vmask, torch.zeros((B, dix.ver_src.shape[0]), dtype=torch.bool,
                              device=dix.device)


def _query_steps(dix: DeviceIndex, u, ts, te):
    if dix.num_nodes == 0:
        return _empty_masks(dix, u.shape[0], full=False)
    return (yield from _component_steps(dix, dix.vrow_ptr[u],
                                        dix.vrow_ptr[u + 1], ts, te))


def _full_steps(dix: DeviceIndex, u, ts, te):
    if dix.num_nodes == 0:
        return _empty_masks(dix, u.shape[0], full=True)
    vmask = yield from _component_steps(dix, dix.vrow_ptr[u],
                                        dix.vrow_ptr[u + 1], ts, te)
    return vmask, _version_member(dix, vmask, ts, te)


def _full_mixed_steps(dix: DeviceIndex, slot, ts, te, kq):
    if dix.num_nodes == 0:
        return _empty_masks(dix, slot.shape[0], full=True)
    vmask = yield from _component_steps(dix, dix.vrow_ptr[slot],
                                        dix.vrow_ptr[slot + 1], ts, te)
    return vmask, (_version_member(dix, vmask, ts, te)
                   & (dix.ver_k[None, :] == kq[:, None]))


def _sweep_steps(dix: DeviceIndex, u, ts, te):
    W = ts.shape[0]
    if dix.num_nodes == 0:
        return _empty_masks(dix, W, full=False)
    return (yield from _component_steps(dix, dix.vrow_ptr[u].expand(W),
                                        dix.vrow_ptr[u + 1].expand(W),
                                        ts, te))


#: the batch functions by name, each as its step generator
_STEPS = {"batch_query": _query_steps, "batch_query_full": _full_steps,
          "batch_query_full_mixed": _full_mixed_steps,
          "window_sweep": _sweep_steps}


def run_sharded(fn: str, calls) -> tuple[list, list[int]]:
    """The batch function named ``fn`` (``"batch_query"``,
    ``"batch_query_full"``, ``"batch_query_full_mixed"`` or
    ``"window_sweep"``) on every shard at once: ``calls`` holds one
    ``(dix, *operands)`` per shard, each shard's operands on its replica's
    device. The shards propagate in lockstep (:func:`_drive`), each to
    its own fixpoint. Returns the shards' outputs, in order, and their
    rounds (0 for a shard whose index has no nodes)."""
    return _drive([_STEPS[fn](*call) for call in calls])


def _one(fn: str, call: tuple, stats: dict | None):
    """One shard of :func:`run_sharded`; ``stats["rounds"]`` (when given)
    gets the batch's round count appended if it propagated."""
    (out,), (rounds,) = run_sharded(fn, [call])
    if stats is not None and rounds:
        stats.setdefault("rounds", []).append(rounds)
    return out


def batch_query(dix: DeviceIndex, u: torch.Tensor, ts: torch.Tensor,
                te: torch.Tensor, *, stats: dict | None = None) -> torch.Tensor:
    """bool[B, n] vertex-membership of each query's k-core component.
    On a stratified index ``u`` is the entry slot (:func:`mixed_slots`).
    ``stats["rounds"]`` (when given) gets the batch's propagation round
    count appended."""
    return _one("batch_query", (dix, u, ts, te), stats)


def batch_query_full(dix: DeviceIndex, u: torch.Tensor, ts: torch.Tensor,
                     te: torch.Tensor, *, stats: dict | None = None):
    """(bool[B, n] vertex mask, bool[B, V] version-membership mask) on a
    per-k index: the version mask is exactly the member edges of each
    query's component, the EDGES/SUBGRAPH payload."""
    return _one("batch_query_full", (dix, u, ts, te), stats)


def batch_query_full_mixed(dix: DeviceIndex, slot: torch.Tensor,
                           ts: torch.Tensor, te: torch.Tensor,
                           kq: torch.Tensor, *, stats: dict | None = None):
    """Mixed-k batch against a stratified :class:`DeviceIndex`.

    ``slot`` is the per-query entry slot ``k_index(k) * n + u``
    (:func:`mixed_slots`; strata are link-disjoint, so propagation needs
    no k mask) and ``kq`` the per-query k filtering the shared version
    arrays. Returns ``(bool[B, n] vertex mask, bool[B, V] version mask)``.
    """
    return _one("batch_query_full_mixed", (dix, slot, ts, te, kq), stats)


def mixed_slots(sx: StratifiedPECB,
                queries: list[tuple[int, int]]) -> np.ndarray:
    """Host-side slot computation for a mixed-k batch: ``(u, k) ->
    k_index(k) * n + u``. Raises ``KeyError`` for an unsupported k."""
    # int64 math first: k_index*n + u walks the fused slot space, which
    # outgrows int32 long before any single stratum does
    slots = np.asarray([sx.k_index(k) * sx.n + u for (u, k) in queries],
                       np.int64)
    return _i32(slots, "mixed-k entry slots")


def window_sweep(dix: DeviceIndex, u, ts: torch.Tensor, te: torch.Tensor,
                 *, stats: dict | None = None) -> torch.Tensor:
    """bool[W, n] vertex masks for ONE vertex over W windows, one batch.

    ``u`` (an int, a 0-d tensor, or a (W,) tensor of one repeated slot)
    picks the entry segment ``[vrow_ptr[u], vrow_ptr[u+1])``, resolved
    once and shared by every window."""
    return _one("window_sweep", (dix, u, ts, te), stats)


def _query_columns(queries, cols, device) -> list[torch.Tensor]:
    """int32 tensors on ``device`` of the given columns of ``queries``."""
    return [torch.as_tensor(np.asarray([q[c] for q in queries], np.int32),
                            device=device) for c in cols]


def batch_query_np(index, queries: list[tuple[int, int, int]],
                   device="cuda") -> list[set[int]]:
    """Host convenience wrapper returning vertex sets (for tests/benches):
    uploads ``index`` to ``device`` and answers ``(u, ts, te)`` queries."""
    dix = to_device(index, device)
    mask = batch_query(dix, *_query_columns(queries, (0, 1, 2), device))
    # repro: ignore[hot-path-transfer] — a host helper's result download
    return [set(np.flatnonzero(row).tolist()) for row in mask.cpu().numpy()]


def batch_query_edges_np(index, queries: list[tuple[int, int, int]],
                         device="cuda") -> list[set[int]]:
    """Host wrapper over :func:`batch_query_full` returning per-query member
    *edge id* sets (for tests/benches)."""
    store = index.versions
    if store is None:
        raise ValueError("index has no version store")
    dix = to_device(index, device)
    _, vermask = batch_query_full(dix, *_query_columns(queries, (0, 1, 2),
                                                       device))
    # repro: ignore[hot-path-transfer] — a host helper's result download
    vermask = vermask[:, :dix.num_versions].cpu().numpy()
    # repro: ignore[hot-path-transfer] — host numpy ids, no transfer
    return [set(store.edge_id[np.flatnonzero(row)].tolist())
            for row in vermask]


def _mixed_np(sx: StratifiedPECB, queries, device):
    """The mirror and the masks of a mixed-k ``(u, ts, te, k)`` batch."""
    dix = to_device(sx, device)
    slot = torch.as_tensor(mixed_slots(sx, [(u, k) for (u, _, _, k)
                                            in queries]), device=device)
    vmask, vermask = batch_query_full_mixed(
        dix, slot, *_query_columns(queries, (1, 2, 3), device))
    # repro: ignore[hot-path-transfer] — a host helper's result download
    return dix, vmask.cpu().numpy(), vermask


def batch_query_mixed_np(sx: StratifiedPECB,
                         queries: list[tuple[int, int, int, int]],
                         device="cuda") -> list[set[int]]:
    """Host wrapper: mixed-k ``(u, ts, te, k)`` batch -> vertex sets
    (tests/benches)."""
    _, mask, _ = _mixed_np(sx, queries, device)
    # repro: ignore[hot-path-transfer] — host numpy ids, no transfer
    return [set(np.flatnonzero(row).tolist()) for row in mask]


def batch_query_mixed_edges_np(sx: StratifiedPECB,
                               queries: list[tuple[int, int, int, int]],
                               device="cuda") -> list[set[int]]:
    """Host wrapper: mixed-k ``(u, ts, te, k)`` batch -> member *edge id*
    sets (tests/benches)."""
    if sx.strata is None:
        raise ValueError("index has no version store")
    dix, _, vermask = _mixed_np(sx, queries, device)
    # repro: ignore[hot-path-transfer] — a host helper's result download
    vermask = vermask[:, :dix.num_versions].cpu().numpy()
    eid = sx.strata.edge_id
    # repro: ignore[hot-path-transfer] — host numpy ids, no transfer
    return [set(eid[np.flatnonzero(row)].tolist()) for row in vermask]
