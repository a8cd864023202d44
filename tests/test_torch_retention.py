"""The port's retention plane (prefix expiry) and the whole epoch
lifecycle, run on the CPU, against the JAX reference (``repro.core``):
``expire_before``/``retain_last``, ``shrink_core_times``,
``shrink_pecb_index``, interleaved extend and shrink epochs per k and
k-stratified (``extend/shrink_stratified_core_times``,
``extend/shrink_stratified_index``), ``refresh_device`` across each
epoch, and the answers served after each one through
``batch_query_full_mixed`` against Algorithm 1's oracle.

Every output is an integer, so every comparison is exact, dtypes
included (tolerance 0)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batch_query as jax_bq  # noqa: E402
from repro.core import core_time as jax_ct  # noqa: E402
from repro.core import pecb_index as jax_pi  # noqa: E402
from repro.core import streaming as jax_st  # noqa: E402
from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core import carry  # noqa: E402
from repro_torch.core import core_time as ct  # noqa: E402
from repro_torch.core import streaming as st  # noqa: E402
from repro_torch.core.ecb_forest import ForestInvariantError  # noqa: E402
from repro_torch.core.kcore import tccs_oracle  # noqa: E402
from repro_torch.core.pecb_index import (build_pecb_index,  # noqa: E402
                                         build_stratified_index)
from repro_torch.core.query_api import TCCSQuery  # noqa: E402
from repro_torch.core.temporal_graph import (TemporalGraph,  # noqa: E402
                                             gen_temporal_graph)

from test_torch_streaming import (ENGINES, assert_fields_equal,  # noqa: E402
                                  assert_mirror_equal, assert_same_error,
                                  carried_epoch, fields, graphs, plain)


# ----------------------------------------------------------------------
# TemporalGraph.expire_before / retain_last
# ----------------------------------------------------------------------

def assert_graph_equal(got, want):
    assert (got.n, got.m, got.t_max) == (want.n, want.m, want.t_max)
    for f in ("src", "dst", "t"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("t_cut", [0, 1, 2, 7, 16, 17, 40])
def test_expire_before_matches_reference(t_cut):
    g, jg = graphs(n=30, m=240, t_max=16, seed=1)
    got = g.expire_before(t_cut)
    assert_graph_equal(got, jg.expire_before(t_cut))
    if t_cut <= 1:
        assert got is g
    cut = int(np.searchsorted(g.t, t_cut, side="left"))
    assert got.m == g.m - cut
    if got.m:
        assert np.array_equal(got.t, g.t[cut:] - (max(t_cut, 1) - 1))


def test_retain_last_and_shift_below_min_timestamp():
    g, jg = graphs(n=20, m=150, t_max=12, seed=3)
    for w in (1, 5, g.t_max, g.t_max + 3):
        assert_graph_equal(g.retain_last(w), jg.retain_last(w))
    assert g.retain_last(g.t_max) is g and g.retain_last(g.t_max + 3) is g
    assert_same_error(lambda: jg.retain_last(0), lambda: g.retain_last(0))
    h = TemporalGraph.from_edges(5, [(0, 1, 5), (1, 2, 6), (2, 3, 6)])
    h2 = h.expire_before(3)
    assert h2.m == h.m and h2.t_max == 4
    assert np.array_equal(h2.t, h.t - 2)
    e = g.expire_before(g.t_max + 1)
    assert e.m == 0 and e.t_max == 0 and e.n == g.n
    g3 = g.expire_before(6).extend([(0, 1, 8), (2, 3, 9)])
    assert g3.t_max == 9 and g3.m == g.expire_before(6).m + 2


# ----------------------------------------------------------------------
# shrink == the reference's shrink == a cold build, bit-identically
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("frac", [0.25, 0.6, 0.9])
def test_shrink_matches_reference_and_cold(seed, k, frac):
    g, jg = graphs(n=30, m=260, t_max=15, seed=seed)
    t_cut = max(2, int(g.t_max * frac))
    jtab0, jidx0, tab0, idx0 = carried_epoch(jg, k)
    g2, jg2 = g.expire_before(t_cut), jg.expire_before(t_cut)
    tab2 = ct.shrink_core_times(g2, k, tab0)
    jtab2 = jax_ct.shrink_core_times(jg2, k, jtab0)
    cold = ct.edge_core_times(g2, k, device="cpu")
    assert_fields_equal(tab2, jtab2, "table")
    assert_fields_equal(tab2, cold, "table vs cold")
    idx2 = st.shrink_pecb_index(g2, k, tab2, idx0)
    assert_fields_equal(idx2, jax_st.shrink_pecb_index(jg2, k, jtab2, jidx0))
    assert_fields_equal(idx2, build_pecb_index(g2, k, cold), "vs cold")


def test_all_expired_yields_empty_index():
    g, jg = graphs(n=20, m=150, t_max=10, seed=11)
    jtab0, jidx0, tab0, idx0 = carried_epoch(jg, 2)
    ge = g.expire_before(g.t_max + 1)
    tab2 = ct.shrink_core_times(ge, 2, tab0)
    assert tab2.num_versions == 0
    assert_fields_equal(tab2, jax_ct.shrink_core_times(
        jg.expire_before(jg.t_max + 1), 2, jtab0))
    idx2 = st.shrink_pecb_index(ge, 2, tab2, idx0)
    assert idx2.num_nodes == 0
    assert_fields_equal(idx2, build_pecb_index(ge, 2, device="cpu"))
    assert ct.shrink_core_times(g, 2, tab0) is tab0      # no cut
    assert st.shrink_pecb_index(g, 2, tab0, idx0) is idx0


@pytest.mark.parametrize("engine", ENGINES)
def test_interleaved_extend_and_shrink_epochs(engine):
    """The full lifecycle per k: grow, trim, grow, trim — every hop equal
    to the reference's hop and the last to a cold build."""
    full, jfull = graphs(n=35, m=700, t_max=40, seed=7)
    k, window = 3, 12
    cur, _ = full.split_at(window)
    jcur, _ = jfull.split_at(window)
    jtab, jidx, tab, idx = carried_epoch(jcur, k)
    offset, t_abs, hops = 0, window, 0
    while t_abs < full.t_max:
        t_hi = min(t_abs + 9, full.t_max)
        lo = int(np.searchsorted(full.t, t_abs, side="right"))
        hi = int(np.searchsorted(full.t, t_hi, side="right"))
        chunk = [(int(u), int(v), int(t) - offset) for u, v, t in
                 zip(full.src[lo:hi], full.dst[lo:hi], full.t[lo:hi])]
        cur, jcur = cur.extend(chunk), jcur.extend(chunk)
        tab = ct.extend_core_times(cur, k, tab, engine=engine, device="cpu")
        idx = st.extend_pecb_index(cur, k, tab, idx)
        jtab = jax_ct.extend_core_times(jcur, k, jtab)
        jidx = jax_st.extend_pecb_index(jcur, k, jtab, jidx)
        t_abs = t_hi
        g2 = cur.retain_last(window)
        if g2 is not cur:
            jg2 = jcur.retain_last(window)
            tab = ct.shrink_core_times(g2, k, tab)
            idx = st.shrink_pecb_index(g2, k, tab, idx)
            jtab = jax_ct.shrink_core_times(jg2, k, jtab)
            jidx = jax_st.shrink_pecb_index(jg2, k, jtab, jidx)
            offset += cur.t_max - g2.t_max
            cur, jcur = g2, jg2
            hops += 1
        assert_fields_equal(tab, jtab, f"table at {t_abs}")
        assert_fields_equal(idx, jidx, f"index at {t_abs}")
    assert hops >= 2
    cold = ct.edge_core_times(cur, k, device="cpu")
    assert_fields_equal(tab, cold, "table vs cold")
    assert_fields_equal(idx, build_pecb_index(cur, k, cold), "index vs cold")


def test_mismatched_inputs_raise_as_the_reference():
    g, jg = graphs(n=30, m=220, t_max=12, seed=12)
    jtab0, jidx0, tab0, idx0 = carried_epoch(jg, 2)
    g2, jg2 = g.expire_before(5), jg.expire_before(5)
    tab2 = ct.shrink_core_times(g2, 2, tab0)
    jtab2 = jax_ct.shrink_core_times(jg2, 2, jtab0)
    g_other, jg_other = graphs(n=30, m=220, t_max=12, seed=99)
    jother = jax_pi.build_pecb_index(jg_other, 2)
    other = carry.from_reference(plain(jother))
    for jargs, args in (((jg2, 3, jtab2, jidx0), (g2, 3, tab2, idx0)),
                        ((jg2, 2, jtab0, jidx0), (g2, 2, tab0, idx0)),
                        ((jg2, 2, jtab2, jother), (g2, 2, tab2, other))):
        assert_same_error(lambda: jax_st.shrink_pecb_index(*jargs),
                          lambda: st.shrink_pecb_index(*args))
    wider = TemporalGraph(g2.n + 1, g2.src, g2.dst, g2.t)
    jwider = type(jg)(jg2.n + 1, jg2.src, jg2.dst, jg2.t)
    for jargs, args in (((jg, 2, jtab2), (g, 2, tab2)),     # backwards
                        ((jwider, 2, jtab0), (wider, 2, tab0))):
        assert_same_error(lambda: jax_ct.shrink_core_times(*jargs),
                          lambda: ct.shrink_core_times(*args))
    # a table whose surviving record names an expired edge
    bad = dataclasses.replace(tab0, edge_id=np.where(
        tab0.ts_to >= 5, 0, tab0.edge_id).astype(np.int32))
    jbad = dataclasses.replace(jtab0, edge_id=bad.edge_id)
    assert_same_error(lambda: jax_ct.shrink_core_times(jg2, 2, jbad),
                      lambda: ct.shrink_core_times(g2, 2, bad))


def test_corrupt_index_raises_forest_invariant_error_as_the_reference():
    """A surviving entry that references an expired forest node is a
    corrupt index: both packages raise ``ForestInvariantError``."""
    g, jg = graphs(n=30, m=260, t_max=15, seed=2)
    t_cut = 6
    jtab0, jidx0, tab0, idx0 = carried_epoch(jg, 2)
    dead = np.flatnonzero(idx0.node_live_to < t_cut)
    node = np.repeat(np.arange(idx0.num_nodes), np.diff(idx0.row_ptr))
    kept = np.flatnonzero((idx0.node_live_to[node] >= t_cut)
                          & (idx0.ent_ts >= t_cut))
    assert dead.size and kept.size
    left = idx0.ent_left.copy()
    left[kept[0]] = dead[0]
    bad = dataclasses.replace(idx0, ent_left=left)
    jbad = dataclasses.replace(jidx0, ent_left=left)
    g2, jg2 = g.expire_before(t_cut), jg.expire_before(t_cut)
    tab2 = ct.shrink_core_times(g2, 2, tab0)
    jtab2 = jax_ct.shrink_core_times(jg2, 2, jtab0)
    assert_same_error(lambda: jax_st.shrink_pecb_index(jg2, 2, jtab2, jbad),
                      lambda: st.shrink_pecb_index(g2, 2, tab2, bad))
    with pytest.raises(ForestInvariantError):
        st.shrink_pecb_index(g2, 2, tab2, bad)


def test_shrunk_answers_and_mirror_match_oracle_and_reference():
    g, jg = graphs(n=30, m=300, t_max=14, seed=13)
    k, t_cut = 2, 6
    jtab0, jidx0, tab0, idx0 = carried_epoch(jg, k)
    g2, jg2 = g.expire_before(t_cut), jg.expire_before(t_cut)
    idx2 = st.shrink_pecb_index(g2, k, ct.shrink_core_times(g2, k, tab0),
                                idx0)
    jidx2 = jax_st.shrink_pecb_index(
        jg2, k, jax_ct.shrink_core_times(jg2, k, jtab0), jidx0)
    dix0 = bq.to_device(idx0, "cpu")
    dix2, stats = bq.refresh_device(idx0, dix0, idx2)
    assert_mirror_equal(dix2, bq.to_device(idx2, "cpu"))
    _, want = jax_bq.refresh_device(jidx0, jax_bq.to_device(jidx0), jidx2)
    assert stats == want and stats["freed_bytes"] > 0
    rng = np.random.default_rng(0)
    qs = []
    for _ in range(40):
        u = int(rng.integers(0, g2.n))
        ts = int(rng.integers(1, g2.t_max + 1))
        qs.append((u, ts, int(rng.integers(ts, g2.t_max + 1))))
    u, ts, te = (torch.as_tensor(np.asarray(c, np.int32)) for c in zip(*qs))
    masks = bq.batch_query(dix2, u, ts, te).numpy()
    for (qu, qts, qte), mask in zip(qs, masks):
        want_v = frozenset(tccs_oracle(g2, k, qu, qts, qte))
        assert idx2.answer(TCCSQuery(qu, qts, qte, k)).vertices == want_v
        assert frozenset(np.flatnonzero(mask).tolist()) == want_v


# ----------------------------------------------------------------------
# the k-stratified lifecycle (the serving plane's epochs)
# ----------------------------------------------------------------------

def mixed_answers_match_oracle(g, sx, dix, rng, n_q=24):
    """A mixed-k batch through ``batch_query_full_mixed`` on the CPU
    mirror, each answer equal to Algorithm 1's oracle."""
    qs = []
    for _ in range(n_q):
        u = int(rng.integers(0, g.n))
        ts = int(rng.integers(1, g.t_max + 1))
        te = int(rng.integers(ts, g.t_max + 1))
        qs.append((u, ts, te, int(rng.choice(sx.supported_ks))))
    slot = bq.mixed_slots(sx, [(u, k) for u, _, _, k in qs])
    cols = [torch.as_tensor(np.asarray(c, np.int32)) for c in
            (slot, [q[1] for q in qs], [q[2] for q in qs],
             [q[3] for q in qs])]
    vmask, _ = bq.batch_query_full_mixed(dix, *cols)
    for (u, ts, te, k), mask in zip(qs, vmask.numpy()):
        assert frozenset(np.flatnonzero(mask).tolist()) == \
            frozenset(tccs_oracle(g, k, u, ts, te)), (u, ts, te, k)


@pytest.mark.parametrize("engine", ENGINES)
def test_stratified_epoch_chain_matches_reference_and_cold(engine):
    """Interleaved extend/shrink epochs of the whole k-stratified index
    (tests/test_stratified.py's chain): every epoch's table, index and
    refreshed mirror equal the reference's epoch and a cold build, the
    refresh stats equal the reference's, and served answers equal
    Algorithm 1's."""
    rng = np.random.default_rng(23)
    cur, jcur = graphs(n=28, m=220, t_max=10, seed=23)
    jtab = jax_ct.stratified_core_times(jcur)
    jsx = jax_pi.build_stratified_index(jcur, strata=jtab)
    tab = carry.core_times_from_reference(fields(jtab))
    sx = carry.from_reference(plain(jsx))
    dix, jdix = bq.to_device(sx, "cpu"), jax_bq.to_device(jsx)
    plan = [("extend", 120), ("shrink", 4), ("extend", 90),
            ("shrink", 6), ("extend", 150), ("shrink", 5)]
    for step, (op, arg) in enumerate(plan):
        if op == "extend":
            suffix = [(int(rng.integers(0, cur.n)),
                       int(rng.integers(0, cur.n)),
                       int(cur.t_max + 1 + rng.integers(0, 5)))
                      for _ in range(arg)]
            cur, jcur = cur.extend(suffix), jcur.extend(suffix)
            ks = ct.default_ks(cur)
            tab = ct.extend_stratified_core_times(cur, tab, ks,
                                                  engine=engine,
                                                  device="cpu")
            sx2 = st.extend_stratified_index(cur, sx, ks, strata=tab,
                                             device="cpu")
            jtab = jax_ct.extend_stratified_core_times(jcur, jtab, ks)
            jsx2 = jax_st.extend_stratified_index(jcur, jsx, ks,
                                                  strata=jtab)
        else:
            cur, jcur = cur.expire_before(arg), jcur.expire_before(arg)
            ks = tuple(k for k in ct.default_ks(cur) if k in tab.ks)
            tab = ct.shrink_stratified_core_times(cur, tab, ks)
            sx2 = st.shrink_stratified_index(cur, sx, ks, strata=tab,
                                             device="cpu")
            jtab = jax_ct.shrink_stratified_core_times(jcur, jtab, ks)
            jsx2 = jax_st.shrink_stratified_index(jcur, jsx, ks,
                                                  strata=jtab)
        assert_fields_equal(sx2, jsx2, f"step {step} index")
        assert_fields_equal(sx2, build_stratified_index(cur, device="cpu"),
                            f"step {step} vs cold")
        dix2, stats = bq.refresh_device(sx, dix, sx2)
        jdix2, jstats = jax_bq.refresh_device(jsx, jdix, jsx2)
        assert stats == jstats, step
        assert_mirror_equal(dix2, bq.to_device(sx2, "cpu"))
        mixed_answers_match_oracle(cur, sx2, dix2,
                                   np.random.default_rng(100 + step))
        sx, dix, jsx, jdix = sx2, dix2, jsx2, jdix2


def test_stratified_extend_engines_agree_with_new_strata():
    """Appended edges raise k_max: the device engine sweeps the old and
    the added strata in one call, and equals the host engine and the
    reference, every field; without appended edges both return the old
    strata."""
    g, jg = graphs(n=30, m=200, t_max=10, seed=5)
    dense = [(u, v, g.t_max + 1) for u in range(8) for v in range(u + 1, 8)]
    jtab = jax_ct.stratified_core_times(jg)
    tab = carry.core_times_from_reference(fields(jtab))
    g1, jg1 = g.extend(dense), jg.extend(dense)
    ks = ct.default_ks(g1)
    assert set(ks) - set(tab.ks)
    want = jax_ct.extend_stratified_core_times(jg1, jtab, ks)
    for engine in ENGINES:
        got = ct.extend_stratified_core_times(g1, tab, ks, engine=engine,
                                              device="cpu")
        assert_fields_equal(got, want, engine)
        same = ct.extend_stratified_core_times(g, tab, engine=engine,
                                               device="cpu")
        assert_fields_equal(same, tab, f"{engine}, same epoch")
    assert_fields_equal(
        st.extend_stratified_index(g1, build_stratified_index(
            g, strata=tab, device="cpu"), ks, device="cpu"),
        build_stratified_index(g1, device="cpu"), "index")


def test_stratified_shrink_cannot_add_strata_as_the_reference():
    g, jg = graphs(n=28, m=220, t_max=10, seed=23)
    jtab = jax_ct.stratified_core_times(jg, ks=(2, 3))
    tab = carry.core_times_from_reference(fields(jtab))
    g2, jg2 = g.expire_before(3), jg.expire_before(3)
    assert_same_error(
        lambda: jax_ct.shrink_stratified_core_times(jg2, jtab, (2, 3, 4)),
        lambda: ct.shrink_stratified_core_times(g2, tab, (2, 3, 4)))
    assert_fields_equal(ct.shrink_stratified_core_times(g2, tab, (3,)),
                        jax_ct.shrink_stratified_core_times(jg2, jtab, (3,)))


def test_stratified_index_without_a_table_builds_cold():
    g = gen_temporal_graph(n=28, m=220, t_max=10, seed=23)
    sx = build_stratified_index(g, device="cpu")
    bare = dataclasses.replace(sx, strata=None, ver_src=None, ver_dst=None,
                               ver_t=None)
    g1 = g.extend([(0, 1, g.t_max + 1), (1, 2, g.t_max + 2)])
    assert_fields_equal(st.extend_stratified_index(g1, bare, device="cpu"),
                        build_stratified_index(g1, device="cpu"))
    g2 = g.expire_before(4)
    assert_fields_equal(st.shrink_stratified_index(g2, bare, device="cpu"),
                        build_stratified_index(g2, device="cpu"))
