"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth its hand-written kernel is
held to: the CPU tests run these against the JAX reference, and
``chip_smoke.py`` compares each kernel with its plain version on the card.
A wrapper calls the plain version only for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch


def label_prop_round(labels: torch.Tensor, link_l: torch.Tensor,
                     link_r: torch.Tensor, link_p: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """One min-label round over batched forest links (B, N) + jump.

    Counterpart of ``repro.kernels.ref.label_prop_round``: a link counts
    iff it is >= 0 and both of its ends are active, else it offers the
    sentinel ``N``; the pointer jump reads the PRE-round labels. int32
    labels and links, bool ``active``; returns int32 (B, N)."""
    B, N = labels.shape

    def nb(link):
        ok = (link >= 0) & active
        linkc = link.clamp(0, N - 1).long()
        lab = torch.gather(labels, 1, linkc)
        act = torch.gather(active, 1, linkc)
        return torch.where(ok & act, lab, N)

    new = torch.minimum(labels, torch.minimum(
        nb(link_l), torch.minimum(nb(link_r), nb(link_p))))
    jumped = torch.where(new < N,
                         torch.gather(labels, 1, new.clamp(0, N - 1).long()),
                         new)
    return torch.minimum(new, jumped)


def segmented_count_le(w: torch.Tensor, seg: torch.Tensor, thr: torch.Tensor,
                       n: int) -> torch.Tensor:
    """int32[n]: per segment ``v``, the number of slots ``i`` with
    ``seg[i] == v`` and ``w[i] <= thr[v]``.

    Counterpart of ``repro.kernels.segmented_select.segmented_count_le``:
    ``seg`` need not be sorted, and a slot whose id lies outside ``[0, n)``
    (the pad id -1, or an id >= n) counts nothing."""
    w, seg, thr = (t.to(torch.int32) for t in (w, seg, thr))
    if n == 0 or not w.numel():
        return torch.zeros(n, dtype=torch.int32, device=w.device)
    ok = (seg >= 0) & (seg < n)
    segc = seg.clamp(0, n - 1).long()
    hit = ok & (w <= thr[segc])
    return torch.bincount(segc[hit], minlength=n).to(torch.int32)


def degree_count(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
                 n: int) -> torch.Tensor:
    """int32[n] alive-weighted degree of every vertex, counting both
    endpoints of each edge (``repro.kernels.ref.degree_count``). ``alive``
    is a weight (bool or integer); an endpoint outside ``[0, n)`` counts
    nothing."""
    wgt = alive.to(torch.int64)
    deg = torch.zeros(n, dtype=torch.int64, device=src.device)
    for ends in (src, dst):
        ok = (ends >= 0) & (ends < n)
        deg.index_add_(0, ends[ok].long(), wgt[ok])
    return deg.to(torch.int32)


def peel_threshold(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
                   deg: torch.Tensor, k: int) -> torch.Tensor:
    """bool[m] new alive mask ``alive > 0 & deg[src] >= k & deg[dst] >= k``
    (the threshold half of ``repro.kernels.kcore_peel.peel_round``); an
    endpoint outside ``[0, len(deg))`` fails the threshold."""
    n = deg.shape[0]
    keep = alive > 0
    if n == 0:
        return torch.zeros_like(keep)
    ok = deg >= k
    for ends in (src, dst):
        keep = keep & (ends >= 0) & (ends < n) & ok[ends.clamp(0, n - 1).long()]
    return keep


def kcore_peel_round(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
                     n: int, k: int):
    """One peel round: drop every edge with an endpoint of alive degree
    < k. Returns ``(new_alive, changed)``, ``changed`` a 0-dim bool tensor
    (``repro.kernels.ref.kcore_peel_round``)."""
    new = peel_threshold(src, dst, alive, degree_count(src, dst, alive, n), k)
    return new, (new != (alive > 0)).any()


def kcore_fixpoint(src: torch.Tensor, dst: torch.Tensor, n: int, k: int,
                   alive0: torch.Tensor | None = None) -> torch.Tensor:
    """bool[m] k-core edge mask: peel rounds until none changes
    (``repro.kernels.ref.kcore_fixpoint``; ``alive0`` defaults to every
    edge alive). Parallel edges each count toward a degree."""
    alive = (torch.ones(src.shape, dtype=torch.bool, device=src.device)
             if alive0 is None else alive0)
    while True:
        new, changed = kcore_peel_round(src, dst, alive, n, k)
        if not bool(changed):
            return new
        alive = new


def _full_f32() -> None:
    """The plain versions' float32 products are full float32: TF32 off for
    cuBLAS (the PyTorch default, set here so a caller's setting cannot
    loosen the reference the kernels are held to)."""
    torch.backends.cuda.matmul.allow_tf32 = False


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32[M, N] = a @ b in float32 (``repro.kernels.ref.matmul``): both
    operands are cast to float32 first, so bf16 inputs multiply exactly
    and accumulate in float32."""
    _full_f32()
    return a.float() @ b.float()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    t_real: int | None = None) -> torch.Tensor:
    """(B, S, H, dh) attention over keys and values (B, T, Hkv, dh), in
    q's dtype, with the semantics of the Pallas kernel
    ``repro.kernels.flash_attention.flash_attention`` (not of
    ``repro.kernels.ref.flash_attention``, where the two differ):

    * query head ``h`` reads kv head ``h // (H // Hkv)`` (the reference
      model's GQA expansion), without materialising the expansion;
    * only the first ``t_real`` keys count (default T: the Pallas
      kernel's padding mask, and the model's decode mask
      ``arange(T) <= cache_len`` with ``t_real = cache_len + 1``);
    * the causal mask is ``qpos >= kpos`` aligned at position 0, also
      when S != T;
    * scores, softmax and ``p @ v`` in float32; the row sum is floored at
      1e-30 before the division.
    """
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    t_real = T if t_real is None else t_real
    G = H // Hkv
    _full_f32()
    qf = q.float().view(B, S, Hkv, G, dh)
    kf = k[:, :t_real].float()
    vf = v[:, :t_real].float()
    s = torch.einsum("bsngd,btnd->bngst", qf, kf) / float(dh) ** 0.5
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(t_real, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bngst,btnd->bsngd", p, vf)
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]       # (B, S, Hkv, G, 1)
    return (o / l.clamp_min(1e-30)).reshape(B, S, H, dh).to(q.dtype)
