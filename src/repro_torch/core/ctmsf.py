"""CT-MSF (paper Def 4.6): minimum spanning forest under core-time weights.

Two constructions:

* :func:`kruskal_msf` — host oracle. Union-find over edges in ascending rank
  ``(ct, edge_id)``; the rank total order makes the MSF unique, which is what
  lets every structure in this repo (ECB forest, CTMSF baseline, Borůvka)
  agree edge-for-edge.

* :func:`boruvka_msf` — the data-parallel construction (DESIGN.md §3).
  Kruskal is pointer-sequential; Borůvka is O(log n) data-parallel rounds
  of per-component segment minima + pointer-jumping hook/compress, all
  torch ops on the tensors' device (the reference's is jnp, not Pallas, so
  this is its counterpart, not a kernel). With unique weights Borůvka
  selects exactly the Kruskal forest, so the two are tested for array
  equality.

Weights are packed as ``ct * (m+1) + edge_id`` in int32 so that the paper's
tie-break on edge id is preserved inside a single scalar key.

PyTorch port of ``repro.core.ctmsf``: the Kruskal oracle and
:func:`ct_msf_at` are copied; ``jax.ops.segment_min`` becomes
``scatter_reduce_(..., "amin")`` over a buffer of the int32 maximum (what
jax returns for an empty segment), ``.at[].max`` becomes
``scatter_reduce_(..., "amax")``, and the ``lax.while_loop`` a host loop
that reads one flag per round.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1


# ----------------------------------------------------------------------
# Host oracle
# ----------------------------------------------------------------------

def kruskal_msf(u: np.ndarray, v: np.ndarray, ct: np.ndarray, n: int) -> np.ndarray:
    """bool[m] mask of MSF edges; rank = (ct, index) ascending."""
    m = u.shape[0]
    order = np.lexsort((np.arange(m), ct))
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    keep = np.zeros(m, bool)
    for i in order:
        ra, rb = find(int(u[i])), find(int(v[i]))
        if ra != rb:
            parent[ra] = rb
            keep[i] = True
    return keep


# ----------------------------------------------------------------------
# Borůvka in torch ops (device path)
# ----------------------------------------------------------------------

def _pack_weight(ct: torch.Tensor, m: int) -> torch.Tensor:
    # int32 packing, as the reference's: requires (max_ct+1)*(m+1) < 2**31,
    # checked by the host wrapper
    eid = torch.arange(ct.shape[0], dtype=torch.int32, device=ct.device)
    return ct.to(torch.int32) * (m + 1) + eid


def _segment_min(w: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """int32[n] minimum of ``w`` per segment id; INT32_MAX where empty."""
    out = torch.full((n,), INT32_MAX, dtype=torch.int32, device=w.device)
    return out.scatter_reduce_(0, seg, w, "amin")


def boruvka_msf(u: torch.Tensor, v: torch.Tensor, ct: torch.Tensor, n: int,
                *, stats: dict | None = None) -> torch.Tensor:
    """bool[m] MSF mask, torch ops on the tensors' device.

    Each round: every component picks its minimum-weight outgoing edge
    (segment minimum over both endpoints' component labels), the picked
    edges are committed to the forest, components hook along them, and
    labels are compressed by pointer jumping. Unique weights guarantee no
    cycles among picks except mutual pairs, which the standard
    (min-endpoint wins) rule breaks. Rounds run while a label changed (one
    host read per round); ``stats["rounds"]``, when given, gets the round
    count appended.
    """
    m = int(u.shape[0])
    device = u.device
    if m == 0:
        return torch.zeros(0, dtype=torch.bool, device=device)
    u, v = u.long(), v.long()
    w = _pack_weight(ct, m)
    INF = torch.tensor(INT32_MAX, dtype=torch.int32, device=device)
    ids = torch.arange(n, dtype=torch.int64, device=device)
    jumps = int(math.ceil(math.log2(max(n, 2)))) + 1
    label = ids.clone()
    in_msf = torch.zeros(m, dtype=torch.bool, device=device)
    rounds = 0
    while True:
        rounds += 1
        cu, cv = label[u], label[v]
        cross = cu != cv
        ew = torch.where(cross, w, INF)
        # per-component minimum outgoing weight (weights are unique per edge)
        best = torch.minimum(_segment_min(ew, cu, n), _segment_min(ew, cv, n))
        has = best < INF
        # an edge joins the forest if it is the best of either endpoint's
        # component
        at_u, at_v = ew == best[cu], ew == best[cv]
        in_msf |= cross & (at_u | at_v)
        # hook: component -> the other endpoint's component along its best
        # edge
        minus1 = torch.full_like(cu, -1)
        partner = torch.full((n,), -1, dtype=torch.int64, device=device)
        partner.scatter_reduce_(0, cu, torch.where(at_u, cv, minus1), "amax")
        partner.scatter_reduce_(0, cv, torch.where(at_v, cu, minus1), "amax")
        partner = torch.where(partner >= 0, partner, ids)
        # mutual-pair tie break: if partner[partner[c]] == c, smaller id
        # wins as root
        par = torch.where(has, partner, ids)
        mutual = par[par] == ids
        par = torch.where(mutual & (ids < par), ids, par)
        # pointer jumping (log n doublings suffice)
        for _ in range(jumps):
            par = par[par]
        new_label = par[label]
        changed = bool((new_label != label).any())   # the host read
        label = new_label
        if not changed:
            break
    if stats is not None:
        stats.setdefault("rounds", []).append(rounds)
    return in_msf


def boruvka_msf_np(u: np.ndarray, v: np.ndarray, ct: np.ndarray, n: int, *,
                   device="cuda") -> np.ndarray:
    """Convenience host wrapper: uploads to ``device``, runs
    :func:`boruvka_msf` there and downloads the mask."""
    if u.shape[0] == 0:
        return np.zeros(0, bool)
    if (int(ct.max()) + 1) * (u.shape[0] + 1) >= 2**31:
        raise OverflowError(
            "int32 weight overflow: (max core time + 1) * (edges + 1) = "
            f"{(int(ct.max()) + 1) * (u.shape[0] + 1)} >= 2**31")
    u_t, v_t, ct_t = (torch.as_tensor(np.asarray(a, np.int32), device=device)
                      for a in (u, v, ct))
    return boruvka_msf(u_t, v_t, ct_t, int(n)).cpu().numpy()


def ct_msf_at(g, tab, ts: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(u, v, ct, msf_mask) of the CT-MSF for start time ``ts`` (host oracle).

    Versions active at ts with finite core times are the MSF candidate edges.
    """
    from .ecb_forest import active_versions

    e_ids, cts = active_versions(tab, ts)
    u = g.src[e_ids].astype(np.int64)
    v = g.dst[e_ids].astype(np.int64)
    keep = kruskal_msf(u, v, cts.astype(np.int64), g.n)
    return u, v, cts.astype(np.int64), keep
