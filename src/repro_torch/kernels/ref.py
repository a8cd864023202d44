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


def stratum_sweep(tuv: torch.Tensor, seg: torch.Tensor, vptr: torch.Tensor,
                  dst: torch.Tensor, ks: torch.Tensor, carry: torch.Tensor,
                  inf: int, out: torch.Tensor) -> torch.Tensor:
    """The k-stratified core-time sweep over one block of start times
    (``csrc/stratum_sweep.cu`` states the function). For stratum ``i``
    (``k = ks[i]``), from ``c = carry[i]``, for each row ``r`` of ``tuv``
    (R, E) in order: probe ``w = max(tuv[r], c[dst])`` (every vertex has
    ``count(w <= c_v) >= k`` or ``c_v >= inf``), else climb
    ``c <- min(max(c, kth_k(w)), inf)`` per CSR segment (``inf`` where a
    segment has fewer than k slots) and probe again; ``out[i, r] = c``.
    ``carry`` (|K|, n) and ``out`` (|K|, R, n) are updated in place.
    Returns int64 (|K|, 2): probes and climbs per stratum.

    The climb takes the k-th smallest from one sort of segment-packed keys
    (any exact selection gives the same update). Raises past ``n * inf + 1``
    probes of one (k, ts), which a right input never reaches."""
    R, E = tuv.shape
    n = carry.shape[1]
    segl, dstl, vptr = seg.long(), dst.long(), vptr.long()
    deg = vptr[1:] - vptr[:-1]
    packed = segl * (inf + 1)          # w <= inf: one sort orders each segment
    base = torch.arange(n, device=tuv.device) * (inf + 1)
    bound = n * inf + 1
    stats = torch.zeros((ks.shape[0], 2), dtype=torch.int64, device=tuv.device)
    for i, k in enumerate(ks.tolist()):
        c = carry[i].clone()
        probes = climbs = 0
        for r in range(R):
            for it in range(1, bound + 2):
                if it > bound:
                    raise RuntimeError(f"stratum k={k} did not converge in "
                                       f"{bound} probes")
                w = torch.maximum(tuv[r], c[dstl])
                hit = torch.cat([w.new_zeros(1, dtype=torch.int64),
                                 torch.cumsum((w <= c[segl]).long(), 0)])
                cnt = hit[vptr[1:]] - hit[vptr[:-1]]
                probes += 1
                if bool(((cnt >= k) | (c >= inf)).all()):
                    break
                climbs += 1
                kth = torch.full_like(c, inf)
                if E:
                    srt = torch.sort(packed + w).values
                    sel = srt[(vptr[:-1] + (k - 1)).clamp(max=E - 1)] - base
                    kth = torch.where(deg >= k, sel, inf).to(torch.int32)
                c = torch.clamp(torch.maximum(c, kth), max=inf)
            out[i, r] = c
        carry[i] = c
        stats[i, 0], stats[i, 1] = probes, climbs
    return stats


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
    # a degree counts at most the 2m edge ends (m < 2**31, as the kernel's
    # int32 counters take it)
    return deg.to(torch.int32)  # repro: ignore[int32-narrowing]


def peel_threshold(src: torch.Tensor, dst: torch.Tensor, alive: torch.Tensor,
                   deg: torch.Tensor, k: int) -> torch.Tensor:
    """bool[m] new alive mask ``alive > 0 & deg[src] >= k & deg[dst] >= k``
    (the threshold half of ``repro.kernels.kcore_peel.peel_round``); an
    endpoint outside ``[0, len(deg))`` fails the threshold. ``k`` is
    compared in int64, so a k past the int32 range is no degree's."""
    n = deg.shape[0]
    keep = alive > 0
    if n == 0:
        return torch.zeros_like(keep)
    ok = deg.long() >= max(min(int(k), 2**63 - 1), -2**63)
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
                   alive0: torch.Tensor | None = None,
                   rounds: torch.Tensor | None = None) -> torch.Tensor:
    """bool[m] k-core edge mask: peel rounds until none changes
    (``repro.kernels.ref.kcore_fixpoint``; ``alive0`` defaults to every
    edge alive). Parallel edges each count toward a degree. An integer
    ``alive0`` is a weight in round 1 only: each round returns bool, as the
    Pallas ``peel_round`` does (the jnp oracle keeps the integer and ands
    it bitwise, so it differs on weights >= 2). ``rounds`` (int32[1]),
    when given, receives the number of rounds, the last one (where nothing
    changes) included."""
    alive = (torch.ones(src.shape, dtype=torch.bool, device=src.device)
             if alive0 is None else alive0)
    count = 0
    while True:
        new, changed = kcore_peel_round(src, dst, alive, n, k)
        count += 1
        if not bool(changed):
            if rounds is not None:
                rounds.fill_(count)
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


def segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """f32[num_segments, d]: row ``s`` is the sum of the rows ``vals[i]``
    with ``ids[i] == s`` (``repro.kernels.segment_matmul.segment_sum``).
    ``vals`` (E, d) is cast to f32 first; ``ids`` need not be sorted, and a
    row whose id lies outside ``[0, num_segments)`` adds nothing (the Pallas
    kernel's one-hot never matches -1 or an id past its padded segments, and
    cuts the padded segments off). ``ids`` may be a segment plan
    (``segment_matmul.SegmentPlan``): its ``ids`` are taken."""
    ids = getattr(ids, "ids", ids)
    vals = vals.float()
    # the dropped rows go to a spare last row, cut off after: no mask
    # selects them, so the shapes never depend on the ids (a meta trace)
    out = torch.zeros((num_segments + 1, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    ok = (ids >= 0) & (ids < num_segments)
    dest = torch.where(ok, ids.long(), num_segments)
    return out.index_add_(0, dest, vals)[:num_segments]


def segment_sum_sorted(vals: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """The reference's oracle of the same name
    (``repro.kernels.ref.segment_sum_sorted``, ``jax.ops.segment_sum``):
    :func:`segment_sum`, the ids sorted or not, those outside ``[0,
    num_segments)`` dropped."""
    return segment_sum(vals, ids, num_segments)


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` in plain PyTorch: ``(*ids.shape,
    d)`` rows, an id in ``[-n, 0)`` wrapped to ``id + n``, any other id
    outside ``[0, n)`` a row of NaN."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    ok = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, max(n - 1, 0))]
    return torch.where(ok[..., None], rows, float("nan"))


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """(bags, k) ids -> (bags, d): :func:`take`, times ``weights`` where
    given, summed over each bag (``repro.kernels.ref.embedding_bag``)."""
    emb = take(table, ids)
    if weights is not None:
        emb = emb * weights[..., None]
    return emb.sum(dim=1)


def matmul_split_k(a: torch.Tensor, b: torch.Tensor,
                   k_split: int) -> torch.Tensor:
    """:func:`matmul` as B5's f32 route computes it when its plan splits K
    (``segment_matmul.plan``): one f32 product per range ``[z * k_split,
    (z + 1) * k_split)`` of K, the partials then added in the order z = 0,
    1, ... (``splitk_reduce``). The same sum as :func:`matmul` in another
    order: equal within f32 rounding, not bit for bit."""
    _full_f32()
    a, b = a.float(), b.float()
    out = None
    for k0 in range(0, max(a.shape[1], 1), k_split):
        part = a[:, k0:k0 + k_split] @ b[k0:k0 + k_split]
        out = part if out is None else out + part
    return out


def _tiled_level(vals, keys, group, span, key_at, out):
    """One level of :func:`segment_sum_tiled`: the items (``vals`` rows,
    ``keys``; -1 for none) in chunks of ``group``, chunk ``c`` covering the
    sorted positions ``[c * span, (c + 1) * span)``; each chunk walked in
    order with a running f32 sum (``acc + x``, from 0, a run at a time),
    vectorised over the chunks. A run whose id differs from the ids just
    outside the chunk's positions is a whole segment and goes to ``out``;
    the first run goes to the chunk's head slot when the id before the
    chunk is its own, else the last run to its tail slot when the id after
    is (a run through the chunk leaves its tail slot at 0). Returns the
    slots, ``(keys (2C,), rows (2C, d))``, head then tail per chunk."""
    n, d = vals.shape
    C = -(-n // group)
    pad = C * group - n
    kk = torch.cat([keys, keys.new_full((pad,), -1)]).view(C, group)
    vv = torch.cat([vals, vals.new_zeros((pad, d))]).view(C, group, d)
    q0 = torch.arange(C, device=vals.device, dtype=torch.int64) * span
    lk, rk = key_at(q0 - 1), key_at(q0 + span)
    cur = kk.new_full((C,), -1)
    acc = vals.new_zeros((C, d))
    hk, tk = kk.new_full((C,), -1), kk.new_full((C,), -1)
    hv, tv = vals.new_zeros((C, d)), vals.new_zeros((C, d))

    def flush(sel):
        k = torch.where(sel, cur, -1)
        whole = (k >= 0) & (k != lk) & (k != rk)
        out[k[whole].long()] = acc[whole]
        head = (k >= 0) & (k == lk)
        tail = (k >= 0) & (k != lk) & (k == rk)
        hk[head], hv[head] = k[head], acc[head]
        both = head & (k == rk)
        tk[both], tv[both] = k[both], 0.0
        tk[tail], tv[tail] = k[tail], acc[tail]

    for j in range(group):
        k = kk[:, j]
        change = k != cur
        flush(change)
        cur = torch.where(change, k, cur)
        acc = torch.where(change[:, None], 0.0, acc)
        acc = torch.where((k >= 0)[:, None], acc + vv[:, j], acc)
    flush(cur >= 0)
    return (torch.stack([hk, tk], 1).reshape(2 * C),
            torch.stack([hv, tv], 1).reshape(2 * C, d))


def segment_sum_tiled(vals: torch.Tensor, plan, tile: int,
                      fans) -> torch.Tensor:
    """:func:`segment_sum` by the card kernel's decomposition
    (``csrc/segment_sum.cu``), in its order of f32 adds, so that the
    kernel equals it bit for bit: the plan's sorted positions in chunks of
    ``tile`` (level 0: the rows ``vals[perm[p]]`` under the sorted ids,
    those outside ``[0, S)`` dropped), each chunk summed in order with
    whole segments written out and its first and last partial runs left as
    two slots; then level ``l`` walks the slots of ``fans[l - 1]`` chunks
    of the level below the same way (the last fan repeated) until one
    chunk is left. Segments with no row are 0. ``plan`` is a
    ``segment_matmul.SegmentPlan`` of the rows of ``vals`` (E, d)."""
    vals = vals.float()
    E, d = vals.shape
    S = plan.num_segments
    out = vals.new_zeros((S, d))
    if E == 0 or d == 0 or S == 0:
        return out
    sid = plan.sorted_ids.long()
    keys = torch.where((sid >= 0) & (sid < S), sid, -1)

    def key_at(p):
        inside = (p >= 0) & (p < E)
        return torch.where(inside, keys[p.clamp(0, E - 1)], -1)

    rows = vals[plan.perm.long()]
    span, fans = tile, list(fans)
    keys_l, rows_l = _tiled_level(rows, keys, tile, span, key_at, out)
    level = 0
    while keys_l.shape[0] > 2:
        fan = fans[min(level, len(fans) - 1)]
        span *= fan
        keys_l, rows_l = _tiled_level(rows_l, keys_l, 2 * fan, span, key_at,
                                      out)
        level += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, t_real: int | None = None,
                    return_lse: bool = False):
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

    With ``return_lse``, ``(o, lse)``: ``lse`` (B, H, S) f32 is each row's
    log-sum-exp of its scaled scores, ``max + log(sum)`` (natural log),
    and +inf for a row whose sum is 0 (no key attended: the floor above),
    so that the backward's ``P = exp(s - lse)`` is 0 there.
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
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bngst,btnd->bsngd", p, vf)
    rs = p.sum(dim=-1)                                      # (B, Hkv, G, S)
    l = rs.permute(0, 3, 1, 2)[..., None]                   # (B, S, Hkv, G, 1)
    o = (o / l.clamp_min(1e-30)).reshape(B, S, H, dh).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(rs > 0, m[..., 0] + torch.log(rs), float("inf"))
    return o, lse.reshape(B, H, S)


# ----------------------------------------------------------------------
# the backward functions: the gradients of matmul (B5), segment_sum (B4)
# and flash_attention (B6), written out as explicit formulas
# ----------------------------------------------------------------------

def _grad_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a backward formula computes in: f32, or f64 for f64 inputs
    (so that an f64 gradcheck holds the formula itself; the card computes
    f64 in f32, as its forward does)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def matmul_grads(a: torch.Tensor, b: torch.Tensor, dc: torch.Tensor,
                 need_a: bool = True, need_b: bool = True):
    """``(da, db)`` of ``c = a @ b`` given ``dc`` (M, N): ``da = dc @ b^T``
    and ``db = a^T @ dc``, each accumulated in f32 and rounded to its
    operand's dtype (None where not needed). For bf16 operands ``dc`` is
    first rounded to bf16, the type the card multiplies them in, as
    ``jax.grad`` of a bf16 ``x @ w`` hands the product a bf16 cotangent."""
    common = torch.promote_types(a.dtype, b.dtype)
    ct = _grad_dtype(common)
    if common == torch.bfloat16:
        dc = dc.to(torch.bfloat16)
    dc = dc.to(ct)
    da = (dc @ b.to(ct).t()).to(a.dtype) if need_a else None
    db = (a.to(ct).t() @ dc).to(b.dtype) if need_b else None
    return da, db


def segment_gather(dout: torch.Tensor, ids: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The gradient of :func:`segment_sum` with respect to ``vals``: row
    ``e`` is ``dout[ids[e]]`` where ``0 <= ids[e] < S`` (S rows of
    ``dout``), else 0; computed in f32 (f64 for f64) and cast to
    ``dtype``. ``ids`` may be a segment plan: its ``ids`` are taken."""
    ids = getattr(ids, "ids", ids)
    S = dout.shape[0]
    ok = (ids >= 0) & (ids < S)
    rows = dout.to(_grad_dtype(dtype))[ids.clamp(0, max(S - 1, 0)).long()] \
        if S else dout.new_zeros((ids.shape[0], dout.shape[1]))
    return torch.where(ok[:, None], rows, 0).to(dtype)


def _attention_terms(q, k, v, o, do, causal, t_real, ct, lse=None):
    """The backward's shared terms in the compute type ``ct``: q, k, do in
    the grouped layout, P, dP = do v^T and D = rowsum(do * o) (B, Hkv, G,
    S, 1), lse (B, Hkv, G, S) and sqrt(dh). ``lse`` (B, H, S), where given,
    is the forward's; else the scores' log-sum-exp, +inf where no key is
    attended (P = 0 there, as the forward's lse gives)."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    _full_f32()
    qf = q.to(ct).view(B, S, Hkv, G, dh)
    kf, vf = k[:, :t_real].to(ct), v[:, :t_real].to(ct)
    of, dof = (x.to(ct).view(B, S, Hkv, G, dh) for x in (o, do))
    scale = float(dh) ** 0.5
    s = torch.einsum("bsngd,btnd->bngst", qf, kf) / scale
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(t_real, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)                     # (B, Hkv, G, S)
        lse = lse.masked_fill(torch.isneginf(lse), float("inf"))
    else:
        lse = lse.to(ct).reshape(B, Hkv, G, S)
    p = torch.exp(s - lse[..., None])
    dsum = (dof * of).sum(-1).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bsngd,btnd->bngst", dof, vf)
    return qf, kf, vf, dof, p, dp, dsum, lse, scale


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = False, t_real: int | None = None,
                        lse: torch.Tensor | None = None):
    """``(dq, dk, dv, lse)``: the gradient of :func:`flash_attention` with
    output ``o``, given ``do``, as FlashAttention-2's recurrence in f32
    (f64 for f64 inputs), the semantics of the forward (GQA without the
    expansion, causal aligned at 0, keys at or past ``t_real`` masked):

    * ``lse = logsumexp(s)`` over the attended keys, ``s = q k^T / sqrt(dh)``
      (or the forward's ``lse`` (B, H, S), where given: see
      :func:`flash_attention`'s ``return_lse``);
    * ``D = rowsum(do * o)``;
    * ``P = exp(s - lse)``, ``dS = P * (do v^T - D)``;
    * ``dq = dS k / sqrt(dh)``, ``dk = dS^T q / sqrt(dh)`` and
      ``dv = P^T do``, the last two summed over the query heads of each kv
      head; keys at or past ``t_real`` get 0.

    dq, dk, dv in their inputs' dtype; ``lse`` (B, H, S) in the compute
    type."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    t_real = T if t_real is None else t_real
    ct = _grad_dtype(q.dtype)
    qf, kf, _, dof, p, dp, dsum, lse, scale = _attention_terms(
        q, k, v, o, do, causal, t_real, ct, lse)
    ds = p * (dp - dsum)
    dq = torch.einsum("bngst,btnd->bsngd", ds, kf) / scale
    dk = torch.zeros((B, T, Hkv, dh), dtype=ct, device=q.device)
    dv = torch.zeros_like(dk)
    dk[:, :t_real] = torch.einsum("bngst,bsngd->btnd", ds, qf) / scale
    dv[:, :t_real] = torch.einsum("bngst,bsngd->btnd", p, dof)
    return (dq.reshape(B, S, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype), lse.reshape(B, H, S))


def flash_attention_bwd_scales(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               do: torch.Tensor, *, causal: bool = False,
                               t_real: int | None = None) -> dict:
    """The magnitudes a backward's rounding errors scale with, per
    gradient element, in f32: ``{"dq": (rounded, noise), "dk": ...,
    "dv": ...}``. ``rounded`` sums the absolute terms whose first factor a
    kernel may round to the inputs' dtype before its product (``|dS| |k|``
    for dq, ``|dS|^T |q|`` for dk, ``P^T |do|`` for dv, times the scale);
    ``noise`` the same sums with ``P (|do| |v|^T + |D|)`` in place of
    ``|dS|`` (for dv ``P^T |do|`` again): f32 rounding inside ``dP - D``,
    which cancel exactly where a position attends one key, is relative to
    these. ``flash_attention.bwd_error_bound`` weighs the two."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    t_real = T if t_real is None else t_real
    qf, kf, vf, dof, p, dp, dsum, _, scale = _attention_terms(
        q, k, v, o, do, causal, t_real, torch.float32)
    rounded = (p * (dp - dsum)).abs()
    noise = p * (torch.einsum("bsngd,btnd->bngst", dof.abs(), vf.abs())
                 + dsum.abs())
    out = {}
    for name, m in (("rounded", rounded), ("noise", noise)):
        gq = torch.einsum("bngst,btnd->bsngd", m, kf.abs()) / scale
        gk = torch.zeros((B, T, Hkv, dh), device=q.device)
        gk[:, :t_real] = torch.einsum("bngst,bsngd->btnd", m,
                                      qf.abs()) / scale
        out[name] = (gq.reshape(B, S, H, dh), gk)
    gv = torch.zeros((B, T, Hkv, dh), device=q.device)
    gv[:, :t_real] = torch.einsum("bngst,bsngd->btnd", p, dof.abs())
    return {"dq": (out["rounded"][0], out["noise"][0]),
            "dk": (out["rounded"][1], out["noise"][1]),
            "dv": (gv, gv)}
