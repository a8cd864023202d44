"""The port's streaming epoch plane (suffix appends), run on the CPU,
against the JAX reference (``repro.core``, host engine): graph epochs,
``extend_core_times`` with both of the port's engines (``"host"``, the
reference's frontier fixpoint, and ``"device"``, the stratum sweep's
plain version on CPU tensors), ``extend_pecb_index``,
``build_pecb_index(resume_from=)``, ``refresh_device``, and the answers
served after an epoch.

The reference's epoch-0 tables and indexes reach the port through
``carry.from_reference`` / ``carry.core_times_from_reference``, so both
packages extend the same inputs. Every output is an integer, so every
comparison is exact, dtypes included (tolerance 0)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batch_query as jax_bq  # noqa: E402
from repro.core import core_time as jax_ct  # noqa: E402
from repro.core import pecb_index as jax_pi  # noqa: E402
from repro.core import streaming as jax_st  # noqa: E402
from repro.core.temporal_graph import \
    gen_temporal_graph as jax_gen  # noqa: E402
from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core import carry  # noqa: E402
from repro_torch.core import core_time as ct  # noqa: E402
from repro_torch.core import streaming as st  # noqa: E402
from repro_torch.core.kcore import tccs_oracle  # noqa: E402
from repro_torch.core.pecb_index import build_pecb_index  # noqa: E402
from repro_torch.core.query_api import TCCSQuery  # noqa: E402
from repro_torch.core.temporal_graph import (TemporalGraph,  # noqa: E402
                                             gen_temporal_graph)

ENGINES = ("host", "device")


def fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def plain(obj):
    """A dataclass's fields as a plain dict, nested dataclasses too."""
    return {k: plain(v) if dataclasses.is_dataclass(v) else v
            for k, v in fields(obj).items()}


def assert_fields_equal(a, b, path="index"):
    """Dataclass equality, the port's against the reference's or its own:
    arrays by value and dtype, scalars by value, nested dataclasses by
    their fields."""
    fa, fb = fields(a), fields(b)
    assert fa.keys() == fb.keys(), path
    for name, va in fa.items():
        vb = fb[name]
        if dataclasses.is_dataclass(va):
            assert_fields_equal(va, vb, f"{path}.{name}")
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f"{path}.{name}"
            assert np.array_equal(va, vb), f"{path}.{name}"
        else:
            assert va == vb, f"{path}.{name}"


def graphs(**cfg):
    return gen_temporal_graph(**cfg), jax_gen(**cfg)


def split_epoch(g, frac):
    t_old = max(1, int(g.t_max * frac))
    g0, suffix = g.split_at(t_old)
    return g0, [tuple(e) for e in suffix.tolist()]


def carried_epoch(jg0, k):
    """The reference's epoch-0 table and index, and their port copies."""
    jtab0 = jax_ct.edge_core_times(jg0, k, engine="host")
    jidx0 = jax_pi.build_pecb_index(jg0, k, jtab0)
    return (jtab0, jidx0, carry.core_times_from_reference(fields(jtab0)),
            carry.from_reference(plain(jidx0)))


def assert_same_error(call_ref, call_port):
    """The reference and the port raise the same exception (by class name
    and message) for the same bad epoch."""
    with pytest.raises(Exception) as want:
        call_ref()
    with pytest.raises(Exception) as got:
        call_port()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------
# TemporalGraph.extend / split_at
# ----------------------------------------------------------------------

def test_suffix_append_roundtrips_split_as_the_reference():
    g, jg = graphs(n=30, m=240, t_max=16, seed=1)
    g0, suffix = split_epoch(g, 0.6)
    jg0, jsuffix = jg.split_at(max(1, int(jg.t_max * 0.6)))
    assert np.array_equal(np.asarray(suffix), jsuffix)
    g1 = g0.extend(suffix)
    j1 = jg0.extend([tuple(e) for e in jsuffix.tolist()])
    for f in ("src", "dst", "t"):
        assert np.array_equal(getattr(g1, f), getattr(g, f)), f
        assert getattr(g1, f).dtype == getattr(j1, f).dtype == np.int32
        assert np.array_equal(getattr(g1, f), getattr(j1, f)), f
    assert (g1.m, g1.t_max) == (j1.m, j1.t_max) == (g.m, g.t_max)


def test_extend_sorts_the_suffix_and_drops_self_loops():
    g, jg = graphs(n=20, m=100, t_max=10, seed=4)
    edges = [(7, 3, 13), (1, 2, 12), (4, 4, 12), (0, 9, 12), (2, 1, 11)]
    got, want = g.extend(edges), jg.extend(edges)
    for f in ("src", "dst", "t"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.m == g.m + 4 and got.t_max == 13


def test_extend_errors_and_no_ops_match_the_reference():
    g, jg = graphs(n=20, m=100, t_max=10, seed=2)
    for bad in ([(0, 1, g.t_max)], [(0, 1, 1), (2, 3, g.t_max + 5)],
                [(0, g.n, g.t_max + 1)], [(-1, 2, g.t_max + 1)]):
        assert_same_error(lambda: jg.extend(bad), lambda: g.extend(bad))
    assert g.extend([]) is g
    assert g.extend([(5, 5, g.t_max + 1)]) is g


# ----------------------------------------------------------------------
# extend == the reference's extend == a cold build, bit-identically
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("frac", [0.3, 0.7])
def test_extend_matches_reference_and_cold(seed, k, frac):
    g, jg = graphs(n=30, m=260, t_max=15, seed=seed)
    g0, suffix = split_epoch(g, frac)
    jg0, _ = jg.split_at(max(1, int(jg.t_max * frac)))
    jtab0, jidx0, tab0, idx0 = carried_epoch(jg0, k)
    assert_fields_equal(tab0, ct.edge_core_times(g0, k, device="cpu"))
    assert_fields_equal(idx0, build_pecb_index(g0, k, tab0))
    g1 = g0.extend(suffix)
    jtab1 = jax_ct.extend_core_times(jg, k, jtab0)
    jidx1 = jax_st.extend_pecb_index(jg, k, jtab1, jidx0)
    cold = ct.edge_core_times(g1, k, device="cpu")
    for engine in ENGINES:
        tab1 = ct.extend_core_times(g1, k, tab0, engine=engine, device="cpu")
        assert_fields_equal(tab1, jtab1, f"table ({engine})")
        assert_fields_equal(tab1, cold, f"table vs cold ({engine})")
    idx1 = st.extend_pecb_index(g1, k, tab1, idx0)
    assert_fields_equal(idx1, jidx1, "index")
    assert_fields_equal(idx1, build_pecb_index(g1, k, cold), "index vs cold")


@pytest.mark.parametrize("engine", ENGINES)
def test_chained_epochs_match_reference_and_cold(engine):
    g, jg = graphs(n=50, m=700, t_max=30, seed=7)
    k = 3
    cuts = [10, 18, 24, g.t_max]
    cur, _ = g.split_at(cuts[0])
    jcur, _ = jg.split_at(cuts[0])
    jtab, jidx, tab, idx = carried_epoch(jcur, k)
    for t_cut in cuts[1:]:
        gn, _ = g.split_at(t_cut)
        suffix = [tuple(e) for e in np.stack(
            [gn.src[cur.m:], gn.dst[cur.m:], gn.t[cur.m:]], axis=1).tolist()]
        cur, jcur = cur.extend(suffix), jcur.extend(suffix)
        tab = ct.extend_core_times(cur, k, tab, engine=engine, device="cpu")
        idx = st.extend_pecb_index(cur, k, tab, idx)
        jtab = jax_ct.extend_core_times(jcur, k, jtab)
        jidx = jax_st.extend_pecb_index(jcur, k, jtab, jidx)
        assert_fields_equal(tab, jtab, f"table at {t_cut}")
        assert_fields_equal(idx, jidx, f"index at {t_cut}")
    assert_fields_equal(idx, build_pecb_index(g, k, device="cpu"), "cold")


def test_same_epoch_returns_prev_and_empty_epoch_builds_cold():
    g = gen_temporal_graph(n=25, m=200, t_max=10, seed=5)
    tab = ct.edge_core_times(g, 2, device="cpu")
    for engine in ENGINES:
        assert ct.extend_core_times(g, 2, tab, engine=engine,
                                    device="cpu") is tab
    empty = TemporalGraph.from_edges(g.n, [])
    tab0 = ct.edge_core_times(empty, 2, device="cpu")
    cold = ct.edge_core_times(g, 2, device="cpu")
    for engine in ENGINES:
        assert_fields_equal(ct.extend_core_times(g, 2, tab0, engine=engine,
                                                 device="cpu"), cold)
    idx0 = build_pecb_index(empty, 2, tab0)
    assert_fields_equal(st.extend_pecb_index(g, 2, cold, idx0),
                        build_pecb_index(g, 2, cold))
    stab0 = ct.stratified_core_times(empty, (2, 3), device="cpu")
    stab = ct.stratified_core_times(g, (2, 3, 4), device="cpu")
    for engine in ENGINES:
        assert_fields_equal(ct.extend_stratified_core_times(
            g, stab0, (2, 3, 4), engine=engine, device="cpu"), stab)
        assert_fields_equal(ct.extend_stratified_core_times(
            g, stab, engine=engine, device="cpu"), stab)


def test_build_pecb_index_resume_from():
    g, jg = graphs(n=30, m=220, t_max=12, seed=11)
    g0, suffix = split_epoch(g, 0.5)
    tab0 = ct.edge_core_times(g0, 2, device="cpu")
    idx0 = build_pecb_index(g0, 2, tab0)
    g1 = g0.extend(suffix)
    tab1 = ct.extend_core_times(g1, 2, tab0, device="cpu")
    got = build_pecb_index(g1, 2, tab1, resume_from=idx0)
    assert_fields_equal(got, build_pecb_index(g, 2, device="cpu"))
    assert_fields_equal(got, jax_pi.build_pecb_index(jg, 2))
    with pytest.raises(ValueError, match="extend_core_times"):
        build_pecb_index(g1, 2, resume_from=idx0)


def test_mismatched_epoch_inputs_raise_as_the_reference():
    g, jg = graphs(n=30, m=220, t_max=12, seed=12)
    g0, suffix = split_epoch(g, 0.5)
    jg0, _ = jg.split_at(max(1, int(jg.t_max * 0.5)))
    jtab0, jidx0, tab0, idx0 = carried_epoch(jg0, 2)
    g1 = g0.extend(suffix)
    jtab1 = jax_ct.extend_core_times(jg, 2, jtab0)
    tab1 = ct.extend_core_times(g1, 2, tab0, device="cpu")
    g_other, jg_other = graphs(n=30, m=220, t_max=6, seed=99)
    other = build_pecb_index(g_other, 2, device="cpu")
    jother = jax_pi.build_pecb_index(jg_other, 2)
    # the index checks: wrong k, a table of another epoch, another graph
    cases = [((jg, 3, jtab1, jidx0), (g1, 3, tab1, idx0)),
             ((jg, 2, jtab0, jidx0), (g1, 2, tab0, idx0)),
             ((jg, 2, jtab1, jother), (g1, 2, tab1, other))]
    for jargs, args in cases:
        assert_same_error(lambda: jax_st.extend_pecb_index(*jargs),
                          lambda: st.extend_pecb_index(*args))
    # the table checks: vertex count, not a prefix, historical edges
    wider = TemporalGraph(g1.n + 1, g1.src, g1.dst, g1.t)
    jwider = type(jg)(jg.n + 1, jg.src, jg.dst, jg.t)
    hist = g0.extend([(0, 1, g0.t_max + 1)])
    hist = TemporalGraph(hist.n, hist.src, hist.dst,
                         np.where(np.arange(hist.m) == g0.m, g0.t_max,
                                  hist.t).astype(np.int32))
    jhist = type(jg)(hist.n, hist.src, hist.dst, hist.t)
    for jgx, gx, jprev, prev in ((jwider, wider, jtab0, tab0),
                                 (jg0, g0, jtab1, tab1),
                                 (jhist, hist, jtab0, tab0)):
        for engine in ENGINES:
            assert_same_error(
                lambda: jax_ct.extend_core_times(jgx, 2, jprev),
                lambda: ct.extend_core_times(gx, 2, prev, engine=engine,
                                             device="cpu"))
    with pytest.raises(ValueError, match="unknown engine"):
        ct.extend_core_times(g1, 2, tab0, engine="jax", device="cpu")
    with pytest.raises(ValueError, match="legacy"):
        ct.extend_core_times(g1, 2, tab0, engine="legacy", device="cpu")


def test_device_engine_needs_its_device():
    """No fallback that hides the device: ``engine="device"`` or
    ``device="cuda"`` on a machine without a card raises and never sweeps
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA launch would run")
    g = gen_temporal_graph(n=30, m=220, t_max=12, seed=13)
    g0, suffix = split_epoch(g, 0.5)
    tab0 = ct.edge_core_times(g0, 2, device="cpu")
    stab0 = ct.stratified_core_times(g0, device="cpu")
    g1 = g0.extend(suffix)
    for call in (lambda: ct.extend_core_times(g1, 2, tab0),
                 lambda: ct.extend_core_times(g1, 2, tab0, engine="device"),
                 lambda: ct.extend_stratified_core_times(g1, stab0),
                 lambda: ct.extend_stratified_core_times(
                     g1, stab0, engine="device", device="cuda")):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


def test_refresh_answers_match_oracle_on_new_windows():
    g = gen_temporal_graph(n=30, m=300, t_max=14, seed=13)
    k = 2
    g0, suffix = split_epoch(g, 0.6)
    tab0 = ct.edge_core_times(g0, k, device="cpu")
    idx0 = build_pecb_index(g0, k, tab0)
    g1 = g0.extend(suffix)
    idx1 = st.extend_pecb_index(
        g1, k, ct.extend_core_times(g1, k, tab0, device="cpu"), idx0)
    dix1, _ = bq.refresh_device(idx0, bq.to_device(idx0, "cpu"), idx1)
    rng = np.random.default_rng(0)
    qs = []
    for _ in range(40):
        u = int(rng.integers(0, g.n))
        ts = int(rng.integers(1, g.t_max + 1))
        qs.append((u, ts, int(rng.integers(ts, g.t_max + 1))))
    u, ts, te = (torch.as_tensor(np.asarray(c, np.int32)) for c in zip(*qs))
    masks = bq.batch_query(dix1, u, ts, te).numpy()
    for (qu, qts, qte), mask in zip(qs, masks):
        want = frozenset(tccs_oracle(g, k, qu, qts, qte))
        assert idx1.answer(TCCSQuery(qu, qts, qte, k)).vertices == want
        assert frozenset(np.flatnonzero(mask).tolist()) == want


# ----------------------------------------------------------------------
# device mirror refresh
# ----------------------------------------------------------------------

def assert_mirror_equal(got, want):
    for f in bq._ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == torch.int32, f
        assert a.device == b.device and torch.equal(a, b), f
    for f in bq._META_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_refresh_device_equals_fresh_upload_and_reference_stats():
    g, jg = graphs(n=30, m=260, t_max=14, seed=21)
    k = 2
    g0, suffix = split_epoch(g, 0.6)
    jg0, _ = jg.split_at(max(1, int(jg.t_max * 0.6)))
    jtab0, jidx0, tab0, idx0 = carried_epoch(jg0, k)
    g1 = g0.extend(suffix)
    idx1 = st.extend_pecb_index(
        g1, k, ct.extend_core_times(g1, k, tab0, device="cpu"), idx0)
    jidx1 = jax_st.extend_pecb_index(
        jg, k, jax_ct.extend_core_times(jg, k, jtab0), jidx0)
    dix0 = bq.to_device(idx0, "cpu")
    before = {f: getattr(dix0, f).clone() for f in bq._ARRAY_FIELDS}
    dix1, stats = bq.refresh_device(idx0, dix0, idx1)
    assert_mirror_equal(dix1, bq.to_device(idx1, "cpu"))
    _, want = jax_bq.refresh_device(jidx0, jax_bq.to_device(jidx0), jidx1)
    assert stats == want
    assert stats["reused"] + stats["suffix"] + stats["full"] == \
        len(bq._ARRAY_FIELDS)
    assert stats["suffix"] >= 1                 # ver_k grows by a suffix
    for f in bq._ARRAY_FIELDS:                  # the old mirror untouched
        assert torch.equal(getattr(dix0, f), before[f]), f


def test_noop_refresh_hands_over_every_tensor():
    g, jg = graphs(n=20, m=150, t_max=10, seed=22)
    jidx = jax_pi.build_pecb_index(jg, 2)
    idx = carry.from_reference(plain(jidx))
    dix = bq.to_device(idx, "cpu")
    dix2, stats = bq.refresh_device(idx, dix, idx)
    for f in bq._ARRAY_FIELDS:
        assert getattr(dix2, f) is getattr(dix, f), f
        assert getattr(dix2, f).data_ptr() == getattr(dix, f).data_ptr(), f
    _, want = jax_bq.refresh_device(jidx, jax_bq.to_device(jidx), jidx)
    assert stats == want
    assert stats["reused"] == len(bq._ARRAY_FIELDS)
    assert stats["full"] == stats["suffix"] == stats["uploaded_bytes"] == 0


def test_refresh_layout_overflow_is_checked():
    g = gen_temporal_graph(n=20, m=150, t_max=10, seed=24)
    idx = build_pecb_index(g, 2, device="cpu")
    dix = bq.to_device(idx, "cpu")
    big = dataclasses.replace(idx, node_ct=np.concatenate(
        [idx.node_ct.astype(np.int64), [2 ** 31]]))
    with pytest.raises(bq.LayoutOverflowError):
        bq.refresh_device(idx, dix, big)


# ----------------------------------------------------------------------
# the legacy engine, ct_at and the brute-force oracle
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [dict(n=14, m=60, t_max=6, seed=7),
                                 dict(n=18, m=70, t_max=7, seed=3)],
                         ids=["g14", "g18"])
def test_legacy_engine_and_naive_oracle_match_reference(cfg):
    g, jg = graphs(**cfg)
    for k in (2, 3):
        tab = ct.edge_core_times(g, k, engine="legacy", device="cpu")
        assert_fields_equal(tab, ct.edge_core_times(g, k, device="cpu"))
        assert_fields_equal(tab, jax_ct.edge_core_times(jg, k,
                                                        engine="legacy"))
        for ts in range(1, g.t_max + 1):
            naive = ct.edge_core_time_naive(g, k, ts)
            assert np.array_equal(naive,
                                  jax_ct.edge_core_time_naive(jg, k, ts))
            assert [tab.ct_at(e, ts) for e in range(g.m)] == naive.tolist()
            assert np.array_equal(ct.vertex_core_times(g, k, ts),
                                  jax_ct.vertex_core_times(jg, k, ts))
    stab = ct.stratified_core_times(g, engine="legacy", device="cpu")
    assert_fields_equal(stab, ct.stratified_core_times(g, device="cpu"))
