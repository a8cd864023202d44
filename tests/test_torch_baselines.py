"""The port's baselines (A7) on the CPU against the JAX reference: the
from-scratch forest oracle (``ecb_forest.build_forest_at``,
``active_versions``), the CT-MSF (``ctmsf``: Kruskal, and Borůvka as torch
ops on CPU tensors), EF-Index and the CT-MSF index, and the k-core
routines' ``device=`` route (the peel fixpoint's plain version on CPU
tensors) against their numpy ground truth.

Both packages get the same seeded graphs. Every output is an integer, a
boolean or a set of them, so every comparison is exact (tolerance 0):
arrays by value and dtype, counts and byte totals by value, answers as
sets."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as hst  # noqa: E402

from repro.core import core_time as jax_ct  # noqa: E402
from repro.core import ctmsf as jax_msf  # noqa: E402
from repro.core import ecb_forest as jax_ef  # noqa: E402
from repro.core import kcore as jax_kc  # noqa: E402
from repro.core.ctmsf_index import CTMSFIndex as JaxCTMSF  # noqa: E402
from repro.core.ef_index import EFIndex as JaxEF  # noqa: E402
from repro.core.pecb_index import build_pecb_index as jax_pecb  # noqa: E402
from repro.core.temporal_graph import \
    gen_temporal_graph as jax_gen  # noqa: E402
from repro_torch.core import core_time as ct  # noqa: E402
from repro_torch.core import ctmsf, ecb_forest, kcore  # noqa: E402
from repro_torch.core.ctmsf_index import CTMSFIndex  # noqa: E402
from repro_torch.core.ef_index import EFIndex  # noqa: E402
from repro_torch.core.pecb_index import build_pecb_index  # noqa: E402
from repro_torch.core.query_api import (InvalidQueryError,  # noqa: E402
                                        ResultMode, TCCSBackend, TCCSQuery)
from repro_torch.core.temporal_graph import (TemporalGraph,  # noqa: E402
                                             bench_graph, gen_temporal_graph,
                                             random_queries)
from repro_torch.kernels import kcore_peel  # noqa: E402

FOREST_ARRAYS = ("vptr", "adj_node", "node_u", "node_v", "node_ct")
INDEX_ARRAYS = ("node_u", "node_v", "node_ct")


def graphs(seed: int, **shape):
    """The port's graph and the reference's, drawn from one seed."""
    return gen_temporal_graph(seed=seed, **shape), jax_gen(seed=seed, **shape)


def tables(g, jg, k):
    """The port's core-time table (host engine) and the reference's, held
    equal field for field."""
    tab, jtab = ct.edge_core_times(g, k, device="cpu"), jax_ct.edge_core_times(jg, k)
    for f in ("edge_id", "ts_from", "ts_to", "ct", "vertex_ct"):
        assert_array_same(getattr(tab, f), getattr(jtab, f), f)
    return tab, jtab


def assert_array_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b), what


def assert_ef_same(ef, jef):
    """Every array and count of EF-Index equal to the reference's."""
    assert_array_same(ef.ts_to_forest, jef.ts_to_forest, "ts_to_forest")
    assert len(ef.forests) == len(jef.forests)
    for i, (f, jf) in enumerate(zip(ef.forests, jef.forests)):
        for name in FOREST_ARRAYS:
            assert_array_same(getattr(f, name), getattr(jf, name),
                              f"forest {i}.{name}")
        assert f.nbytes == jf.nbytes
    assert ef.num_distinct_cores == jef.num_distinct_cores
    assert ef.enumerated_core_edges == jef.enumerated_core_edges
    assert ef.nbytes() == jef.nbytes()
    for f in dataclasses.fields(jef.versions):
        assert_array_same(getattr(ef.versions, f.name),
                          getattr(jef.versions, f.name), f.name)


def assert_ctmsf_same(cm, jcm):
    """Every array, list and byte count of the CT-MSF index equal to the
    reference's."""
    for name in INDEX_ARRAYS:
        assert_array_same(getattr(cm, name), getattr(jcm, name), name)
    assert cm.vlists == jcm.vlists
    assert cm.nbytes() == jcm.nbytes()


def windows(g, n_q, rng, beyond=False):
    out = []
    for _ in range(n_q):
        u = int(rng.integers(0, g.n))
        ts = int(rng.integers(1, g.t_max + 1))
        hi = 2 * g.t_max if beyond else g.t_max
        out.append((u, ts, int(rng.integers(ts, hi + 1))))
    return out


# ----------------------------------------------------------------------
# tests/test_system.py::TestQueries against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [2, 3])
def test_indexes_equal_reference_and_oracle(seed, k):
    """EF and CT-MSF built from the same table equal the reference's array
    for array and count for count, and all three indexes answer like the
    reference's and like ``tccs_oracle``."""
    g, jg = graphs(seed + 40, n=30, m=220, t_max=18)
    tab, jtab = tables(g, jg, k)
    ef, jef = EFIndex(g, k, tab), JaxEF(jg, k, jtab)
    cm, jcm = CTMSFIndex(g, k, tab), JaxCTMSF(jg, k, jtab)
    pecb = build_pecb_index(g, k, tab)
    assert_ef_same(ef, jef)
    assert_ctmsf_same(cm, jcm)
    assert pecb.nbytes() == jax_pecb(jg, k, jtab).nbytes()
    rng = np.random.default_rng(seed)
    for _ in range(120):
        u = int(rng.integers(0, g.n))
        ts = int(rng.integers(1, g.t_max + 1))
        te = int(rng.integers(ts, g.t_max + 1))
        want = kcore.tccs_oracle(g, k, u, ts, te)
        assert want == jax_kc.tccs_oracle(jg, k, u, ts, te)
        assert ef._component_vertices(u, ts, te) == want
        assert cm._component_vertices(u, ts, te) == want
        assert pecb._component_vertices(u, ts, te) == want
        assert jef._component_vertices(u, ts, te) == want
        assert jcm._component_vertices(u, ts, te) == want


@pytest.mark.parametrize("backend", ["ef", "ctmsf"])
def test_index_without_table_builds_on_the_given_device(backend):
    """With no ``tab`` the index builds the port's table on ``device``:
    the CPU here, equal to the one built from a given table."""
    g = gen_temporal_graph(n=25, m=160, t_max=12, seed=4)
    cls = EFIndex if backend == "ef" else CTMSFIndex
    same = assert_ef_same if backend == "ef" else assert_ctmsf_same
    tab = ct.edge_core_times(g, 2, device="cpu")
    same(cls(g, 2, device="cpu"), cls(g, 2, tab))


def test_cm_like_counts_equal_reference():
    """bench_paper's cm_like workload at its default k (0.7 of k_max):
    every EF, CT-MSF and PECB count equals the reference's."""
    g, jg = bench_graph("cm_like"), jax_gen(n=600, m=9000, t_max=190, seed=2)
    km = kcore.k_max(g)
    assert km == jax_kc.k_max(jg) == kcore.k_max(g, device="cpu")
    k = max(2, int(round(0.7 * km)))
    tab, jtab = tables(g, jg, k)
    assert_ef_same(EFIndex(g, k, tab), JaxEF(jg, k, jtab))
    assert_ctmsf_same(CTMSFIndex(g, k, tab), JaxCTMSF(jg, k, jtab))
    assert build_pecb_index(g, k, tab).nbytes() == \
        jax_pecb(jg, k, jtab).nbytes()


# ----------------------------------------------------------------------
# tests/test_system.py::TestMSF / TestECBForest against the reference
# ----------------------------------------------------------------------

def msf_cases(seed, step=4):
    g, jg = graphs(seed, n=40, m=300, t_max=25)
    tab, _ = tables(g, jg, 2)
    for ts in range(1, g.t_max + 1, step):
        e_ids, cts = ecb_forest.active_versions(tab, ts)
        if e_ids.size:
            yield g, ts, g.src[e_ids], g.dst[e_ids], cts


@pytest.mark.parametrize("seed", [0, 1])
def test_kruskal_equals_reference(seed):
    for g, ts, u, v, c in msf_cases(seed, step=1):
        u, v, c = (a.astype(np.int64) for a in (u, v, c))
        got = ctmsf.kruskal_msf(u, v, c, g.n)
        assert_array_same(got, jax_msf.kruskal_msf(u, v, c, g.n), ts)


@pytest.mark.parametrize("seed", [0, 1])
def test_boruvka_equals_kruskal_and_reference(seed):
    """Borůvka as torch ops on CPU tensors selects the Kruskal forest at
    every start time (int32 and int64 operands), as the reference's jnp
    Borůvka does on every fourth."""
    for g, ts, u, v, c in msf_cases(seed, step=1):
        want = ctmsf.kruskal_msf(u.astype(np.int64), v.astype(np.int64),
                                 c.astype(np.int64), g.n)
        for dt in (np.int32, np.int64):
            got = ctmsf.boruvka_msf_np(u.astype(dt), v.astype(dt),
                                       c.astype(dt), g.n, device="cpu")
            assert_array_same(got, want, (ts, dt))
        if ts % 4 == 1:
            assert_array_same(jax_msf.boruvka_msf_np(
                u.astype(np.int32), v.astype(np.int32), c.astype(np.int32),
                g.n), want, ts)


def test_boruvka_rounds_and_tensor_surface():
    """``boruvka_msf`` on tensors returns a bool tensor on their device,
    and reports its rounds: at most ceil(log2 n) + 1 hook rounds plus the
    one that finds nothing to change."""
    g, ts, u, v, c = next(msf_cases(0))
    stats = {}
    got = ctmsf.boruvka_msf(*(torch.as_tensor(a) for a in (u, v, c)), g.n,
                            stats=stats)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    assert_array_same(got.numpy(), ctmsf.kruskal_msf(u, v, c, g.n))
    (rounds,) = stats["rounds"]
    assert 2 <= rounds <= int(np.ceil(np.log2(g.n))) + 2


def test_boruvka_overflow_and_empty():
    u = np.array([0, 1], np.int32)
    v = np.array([1, 2], np.int32)
    big = np.array([2**30, 5], np.int32)
    for fn in (ctmsf.boruvka_msf_np, jax_msf.boruvka_msf_np):
        with pytest.raises(OverflowError, match="int32 weight overflow"):
            fn(u, v, big, 3)
    with pytest.raises(OverflowError) as got:
        ctmsf.boruvka_msf_np(u, v, big, 3, device="cpu")
    with pytest.raises(OverflowError) as want:
        jax_msf.boruvka_msf_np(u, v, big, 3)
    assert str(got.value) == str(want.value)
    z = np.zeros(0, np.int32)
    assert_array_same(ctmsf.boruvka_msf_np(z, z, z, 4, device="cpu"),
                      jax_msf.boruvka_msf_np(z, z, z, 4))
    empty = ctmsf.boruvka_msf(torch.zeros(0, dtype=torch.int32),
                              torch.zeros(0, dtype=torch.int32),
                              torch.zeros(0, dtype=torch.int32), 4)
    assert empty.shape == (0,) and empty.dtype == torch.bool
    assert_array_same(ctmsf.kruskal_msf(z, z, z, 4),
                      jax_msf.kruskal_msf(z, z, z, 4))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ct_msf_at_equals_reference(seed):
    g, jg = graphs(seed, n=30, m=200, t_max=15)
    tab, jtab = tables(g, jg, 2)
    for ts in range(1, g.t_max + 2):
        for a, b in zip(ctmsf.ct_msf_at(g, tab, ts),
                        jax_msf.ct_msf_at(jg, jtab, ts)):
            assert_array_same(a, b, ts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_forest_at_equals_reference(seed):
    """The from-scratch forest, field for field, and the reference test's
    binary bound and rank order."""
    g, jg = graphs(seed, n=30, m=200, t_max=15)
    tab, jtab = tables(g, jg, 2)
    for ts in range(0, g.t_max + 2):
        e, c = ecb_forest.active_versions(tab, ts)
        je, jc = jax_ef.active_versions(jtab, ts)
        assert_array_same(e, je)
        assert_array_same(c, jc)
        f, jf = ecb_forest.build_forest_at(g, tab, ts), \
            jax_ef.build_forest_at(jg, jtab, ts)
        assert f.version_key == jf.version_key
        for fld in dataclasses.fields(jf):
            if fld.name != "version_key":
                assert_array_same(getattr(f, fld.name),
                                  getattr(jf, fld.name), (ts, fld.name))
        child = np.zeros(f.ct.shape[0], int)
        for i in np.flatnonzero(f.in_forest):
            for c_ in (f.left[i], f.right[i]):
                if c_ >= 0:
                    child[i] += 1
                    assert (f.ct[c_], f.edge_id[c_]) < (f.ct[i], f.edge_id[i])
        assert (child <= 2).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_builder_live_set_equals_from_scratch(seed):
    """The port's builder's live node set at each ts equals the port's
    Def-4.9 from-scratch forest (tests/test_system.py's invariant)."""
    g = gen_temporal_graph(n=25, m=150, t_max=12, seed=seed)
    tab = ct.edge_core_times(g, 2, device="cpu")
    idx = build_pecb_index(g, 2, tab)
    for ts in range(1, g.t_max + 1):
        f = ecb_forest.build_forest_at(g, tab, ts)
        scratch = {(int(f.edge_id[i]), int(f.ct[i]))
                   for i in np.flatnonzero(f.in_forest)}
        inc = {(int(idx.node_edge[x]), int(idx.node_ct[x]))
               for x in range(idx.num_nodes)
               if idx.node_live_from[x] <= ts <= idx.node_live_to[x]}
        assert scratch == inc, ts


def test_vertex_centric_builder_clears_dirty_vertices():
    """The CT-MSF builder taps ``_dirty_verts`` before the port's
    ``flush``, which clears it: a vertex list is re-recorded only when it
    changed."""
    from repro_torch.core.ctmsf_index import _VertexCentricBuilder

    g = gen_temporal_graph(n=20, m=120, t_max=10, seed=6)
    tab = ct.edge_core_times(g, 2, device="cpu")
    b = _VertexCentricBuilder(g, tab).run()
    assert not b._dirty_verts
    for ent in b.vlists:
        assert all(a[1] != c[1] for a, c in zip(ent, ent[1:]))
        assert all(a[0] > c[0] for a, c in zip(ent, ent[1:]))


# ----------------------------------------------------------------------
# tests/test_query_api.py and tests/test_streaming.py: modes and shims
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def stack():
    g = gen_temporal_graph(n=35, m=280, t_max=16, seed=8)
    k = 2
    tab = ct.edge_core_times(g, k, device="cpu")
    return (g, k, build_pecb_index(g, k, tab), EFIndex(g, k, tab),
            CTMSFIndex(g, k, tab))


@pytest.mark.parametrize("name", ["ef", "ctmsf"])
def test_backend_protocol_and_invalid_specs(stack, name):
    g, k, _, ef, cm = stack
    backend = ef if name == "ef" else cm
    assert isinstance(backend, TCCSBackend)
    assert backend.backend_name == name
    for bad in (TCCSQuery(0, 9, 4, k), TCCSQuery(g.n + 7, 1, 4, k),
                TCCSQuery(0, 1, 4, 1)):
        with pytest.raises(InvalidQueryError):
            backend.answer(bad)
    with pytest.raises(InvalidQueryError, match="does not match"):
        backend.answer(TCCSQuery(0, 1, 4, k + 1))


@pytest.mark.parametrize("name", ["ef", "ctmsf"])
def test_answer_modes_match_oracle(stack, name):
    """VERTICES, EDGES, SUBGRAPH and COUNT equal the brute-force oracle
    (windows past t_max included) and the PECB's answers."""
    g, k, pecb, ef, cm = stack
    backend = ef if name == "ef" else cm
    rng = np.random.default_rng(0)
    for (u, ts, te) in windows(g, 25, rng, beyond=True):
        want_v = frozenset(kcore.tccs_oracle(g, k, u, ts, te))
        want_e = frozenset(kcore.tccs_oracle_edges(g, k, u, ts, te))
        assert backend.answer(TCCSQuery(u, ts, te, k)).vertices == want_v
        r = backend.answer(TCCSQuery(u, ts, te, k, ResultMode.EDGES))
        assert r.vertices == want_v
        assert r.edges.edge_ids() == want_e
        assert r.edges.vertex_projection() == want_v
        assert r.num_edges == len(want_e)
        rs = backend.answer(TCCSQuery(u, ts, te, k, ResultMode.SUBGRAPH))
        assert rs.subgraph.m == len(want_e)
        assert rs.edges.edge_ids() == want_e
        rc = backend.answer(TCCSQuery(u, ts, te, k, ResultMode.COUNT))
        assert rc.num_vertices == len(want_v)
        assert rc.vertices == frozenset()
        assert pecb.answer(TCCSQuery(u, ts, te, k)).vertices == want_v


@pytest.mark.parametrize("name", ["ef", "ctmsf"])
def test_query_shim_warns_and_agrees(stack, name):
    g, k, _, ef, cm = stack
    backend = ef if name == "ef" else cm
    rng = np.random.default_rng(1)
    for (u, ts, te) in windows(g, 10, rng):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            legacy = backend.query(u, ts, te)
        assert legacy == set(backend.answer(TCCSQuery(u, ts, te, k)).vertices)


def test_query_shims_warn_on_small_stack():
    """tests/test_streaming.py::TestDeprecationWarnings on the port."""
    g = gen_temporal_graph(n=20, m=140, t_max=8, seed=51)
    tab = ct.edge_core_times(g, 2, device="cpu")
    for b in (build_pecb_index(g, 2, tab), EFIndex(g, 2, tab),
              CTMSFIndex(g, 2, tab)):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            b.query(0, 1, 5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        EFIndex(g, 2, tab).answer(TCCSQuery(0, 1, 5, 2))


# ----------------------------------------------------------------------
# tests/test_property.py: EF and CT-MSF over the epoch planes' tables
# ----------------------------------------------------------------------

def assert_like_cold(g, k, tab, tab_cold, rng, n_q=12):
    """EF and CT-MSF over an epoch plane's table equal their cold builds
    and answer like ``tccs_oracle``."""
    for f in ("edge_id", "ts_from", "ts_to", "ct", "vertex_ct"):
        assert_array_same(getattr(tab, f), getattr(tab_cold, f), f)
    ef, cm = EFIndex(g, k, tab), CTMSFIndex(g, k, tab)
    assert_ef_same(ef, EFIndex(g, k, tab_cold))
    assert_ctmsf_same(cm, CTMSFIndex(g, k, tab_cold))
    for (u, ts, te) in windows(g, n_q, rng):
        want = frozenset(kcore.tccs_oracle(g, k, u, ts, te))
        q = TCCSQuery(u, ts, te, k)
        assert ef.answer(q).vertices == want
        assert cm.answer(q).vertices == want


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_baselines_over_extended_table_equal_cold(seed, k, engine):
    g = gen_temporal_graph(n=24, m=160, t_max=12, seed=seed + 60)
    g0, suffix = g.split_at(max(1, int(g.t_max * 0.6)))
    tab0 = ct.edge_core_times(g0, k, device="cpu")
    g1 = g0.extend(map(tuple, suffix.tolist()))
    tab1 = ct.extend_core_times(g1, k, tab0, engine=engine, device="cpu")
    assert_like_cold(g1, k, tab1, ct.edge_core_times(g, k, device="cpu"),
                     np.random.default_rng(seed))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("cut", [0.3, 0.7])
def test_baselines_over_shrunk_table_equal_cold(seed, k, cut):
    g = gen_temporal_graph(n=24, m=160, t_max=12, seed=seed + 70)
    tab = ct.edge_core_times(g, k, device="cpu")
    g2 = g.expire_before(max(2, int(g.t_max * cut)))
    tab2 = ct.shrink_core_times(g2, k, tab)
    assert_like_cold(g2, k, tab2, ct.edge_core_times(g2, k, device="cpu"),
                     np.random.default_rng(seed))


# ----------------------------------------------------------------------
# the k-core routines' device route (the fixpoint's plain version)
# ----------------------------------------------------------------------

@hst.composite
def multigraphs(draw, max_n=12, max_m=50, max_t=8):
    """A temporal multigraph built directly (``from_edges`` drops
    self-loops): self-loops and parallel edges are drawn on purpose."""
    n = draw(hst.integers(1, max_n))
    m = draw(hst.integers(0, max_m))
    t_max = draw(hst.integers(1, max_t))
    rows = sorted((draw(hst.integers(1, t_max)), draw(hst.integers(0, n - 1)),
                   draw(hst.integers(0, n - 1))) for _ in range(m))
    arr = np.asarray(rows, np.int32).reshape(-1, 3)
    return TemporalGraph(n, arr[:, 1].copy(), arr[:, 2].copy(),
                         arr[:, 0].copy())


@settings(max_examples=60, deadline=None)
@given(g=multigraphs(), k=hst.integers(-1, 8))
def test_distinct_kcore_device_route_equals_numpy(g, k):
    before = kcore_peel.kcore_fixpoint.launches
    want = kcore.distinct_kcore_edge_mask(g.src, g.dst, g.n, k)
    got = kcore.distinct_kcore_edge_mask(g.src, g.dst, g.n, k, device="cpu")
    assert_array_same(got, want)
    assert_array_same(want, jax_kc.distinct_kcore_edge_mask(g.src, g.dst,
                                                            g.n, k))
    assert kcore_peel.kcore_fixpoint.launches == before   # CPU: no launch


@settings(max_examples=40, deadline=None)
@given(g=multigraphs())
def test_k_max_and_default_ks_device_route_equal_numpy(g):
    km = kcore.k_max(g)
    assert kcore.k_max(g, device="cpu") == km == jax_kc.k_max(g)
    assert ct.default_ks(g, device="cpu") == ct.default_ks(g) == \
        jax_ct.default_ks(g)


@settings(max_examples=40, deadline=None)
@given(g=multigraphs(), k=hst.integers(1, 4), data=hst.data())
def test_window_oracles_device_route_equal_numpy(g, k, data):
    u = data.draw(hst.integers(0, g.n - 1))
    ts = data.draw(hst.integers(1, max(g.t_max, 1)))
    te = data.draw(hst.integers(ts - 1, g.t_max + 1))
    assert_array_same(kcore.temporal_kcore_edges(g, k, ts, te, device="cpu"),
                      kcore.temporal_kcore_edges(g, k, ts, te))
    assert kcore.tccs_oracle(g, k, u, ts, te, device="cpu") == \
        kcore.tccs_oracle(g, k, u, ts, te) == \
        jax_kc.tccs_oracle(g, k, u, ts, te)
    assert kcore.tccs_oracle_edges(g, k, u, ts, te, device="cpu") == \
        kcore.tccs_oracle_edges(g, k, u, ts, te) == \
        jax_kc.tccs_oracle_edges(g, k, u, ts, te)


def test_k_max_empty_graph_and_random_queries():
    z = np.zeros(0, np.int32)
    empty = TemporalGraph(5, z, z.copy(), z.copy())
    assert kcore.k_max(empty, device="cpu") == kcore.k_max(empty) == 1
    assert ct.default_ks(empty, device="cpu") == ()
    g = gen_temporal_graph(n=60, m=600, t_max=30, seed=5)
    assert kcore.k_max(g, device="cpu") == kcore.k_max(g) >= 2
    for (u, ts, te) in random_queries(g, 20, seed=3):
        assert kcore.tccs_oracle(g, 3, u, ts, te, device="cpu") == \
            kcore.tccs_oracle(g, 3, u, ts, te)


@pytest.mark.parametrize("engine", ["host", "device", "legacy"])
def test_build_k_range_by_engine(engine):
    """A build's default k range and ``k_max_graph`` come from the peel on
    the build's device for the device engine (the plain fixpoint here) and
    from numpy otherwise; every engine gives the reference's."""
    g, jg = graphs(9, n=40, m=300, t_max=14)
    assert ct.kcore_device(engine, "cpu") == ("cpu" if engine == "device"
                                              else None)
    stab = ct.stratified_core_times(g, engine=engine, device="cpu")
    assert stab.ks == jax_ct.default_ks(jg)
    from repro_torch.core.pecb_index import build_stratified_index
    sx = build_stratified_index(g, strata=stab, engine=engine, device="cpu")
    assert sx.k_max_graph == jax_kc.k_max(jg)
