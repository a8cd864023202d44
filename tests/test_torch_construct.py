"""The construction plane with the device engine (one `stratum_sweep`
launch per t_uv block), run on the CPU through the sweep's plain version,
against the JAX reference: per-k core-time tables of the reference's ``"jax_pallas"``,
``"jax"`` and ``"host"`` engines, the stratified table, the packed index,
Algorithm 1, and reference tables carried into the port.

Every output is an integer, so equality is exact."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import core_time as jax_ct  # noqa: E402
from repro.core import pecb_index as jax_pecb  # noqa: E402
from repro.core.temporal_graph import \
    gen_temporal_graph as jax_gen  # noqa: E402
from repro_torch.core import carry, kcore  # noqa: E402
from repro_torch.core import core_time as ct  # noqa: E402
from repro_torch.core.pecb_index import (build_pecb_index,  # noqa: E402
                                         build_stratified_index)
from repro_torch.core.temporal_graph import (BENCH_WORKLOADS,  # noqa: E402
                                             TemporalGraph,
                                             gen_temporal_graph,
                                             random_queries)
from repro_torch.kernels import segmented_select as ss  # noqa: E402

G14 = dict(n=14, m=60, t_max=6, seed=7)       # tests/test_system.py
G18 = dict(n=18, m=70, t_max=7, seed=3)
G30 = dict(n=30, m=240, t_max=12, seed=5)
G40 = dict(n=40, m=420, t_max=18, seed=31)
FB_LIKE = BENCH_WORKLOADS["fb_like"]
#: t_max past TUV_BLOCK: two t_uv blocks, the carry crossing launches
T318 = dict(n=30, m=800, t_max=400, seed=9)    # 318 distinct times


def hub_graph(seed=11):
    """A graph whose vertex 0 has 1,100 distinct neighbours (a segment of
    more than 1,024 pair slots), around a denser random core."""
    rng = np.random.default_rng(seed)
    n = 1_101
    edges = [(0, v, int(rng.integers(1, 41))) for v in range(1, n)]
    a, b = rng.integers(1, 60, (2, 900))
    edges += [(int(u), int(v), int(t)) for u, v, t in
              zip(a, b, rng.integers(1, 41, 900))]
    return TemporalGraph.from_edges(n, edges)


def graphs(cfg):
    return gen_temporal_graph(**cfg), jax_gen(**cfg)


def fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_fields_equal(a, b, path):
    """Dataclass equality: arrays by value and dtype, scalars by value
    (the port's table against the reference's, or against its own)."""
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


@pytest.mark.parametrize("cfg", [G14, G30], ids=["g14", "g30"])
def test_device_engine_matches_reference_pallas_engine(cfg):
    g, jg = graphs(cfg)
    for k in ct.default_ks(g):
        stats = {}
        tab = ct.edge_core_times(g, k, engine="device", device="cpu",
                                 stats=stats)
        want = jax_ct.edge_core_times(jg, k, engine="jax_pallas")
        assert_fields_equal(tab, want, f"k={k}")
        # one probe per ts at least, a climb per unconverged probe
        assert stats["iterations"] >= g.t_max
        assert stats["iterations"] - stats["climbs"] == g.t_max


@pytest.mark.parametrize("cfg", [G18, G30, G40, FB_LIKE],
                         ids=["g18", "g30", "g40", "fb_like"])
def test_device_engine_matches_reference_jax_and_host_engines(cfg):
    g, jg = graphs(cfg)
    ks = ct.default_ks(g)
    if cfg is FB_LIKE:
        ks = (ks[0], ks[len(ks) // 2], ks[-1])
    for k in ks:
        tab = ct.edge_core_times(g, k, engine="device", device="cpu")
        assert_fields_equal(tab, jax_ct.edge_core_times(jg, k, engine="jax"),
                            f"jax k={k}")
        assert_fields_equal(tab, jax_ct.edge_core_times(jg, k, engine="host"),
                            f"host k={k}")
        assert np.array_equal(ct._sweep_device(g, k, device="cpu"),
                              jax_ct._sweep_jax(jg, k)), k


def test_stratified_device_engine_matches_reference_pallas_engine():
    g, jg = graphs(G18)
    got = ct.stratified_core_times(g, engine="device", device="cpu")
    assert_fields_equal(got, jax_ct.stratified_core_times(
        jg, engine="jax_pallas"), "strata")


def test_stratified_device_engine_matches_host_engine_on_fb_like():
    g = gen_temporal_graph(**FB_LIKE)
    stats = {}
    before = ss.segmented_count_le.launches
    dev = ct.stratified_core_times(g, engine="device", device="cpu",
                                   stats=stats)
    assert ss.segmented_count_le.launches == before   # CPU: no launch
    host = ct.stratified_core_times(g, device="cpu")
    assert_fields_equal(dev, host, "strata")
    for k in dev.ks:
        assert np.array_equal(dev.table_for(k).vertex_ct,
                              host.table_for(k).vertex_ct), k
    # each ts of each stratum ends on a passing probe: one probe more than
    # it climbs
    assert stats["iterations"] - stats["climbs"] == g.t_max * len(dev.ks)


def test_device_built_index_matches_reference_and_algorithm_1():
    g, jg = graphs(G30)
    sx = build_stratified_index(g, engine="device", device="cpu")
    jsx = jax_pecb.build_stratified_index(jg)
    assert_fields_equal(sx, jsx, "index")
    rng = np.random.default_rng(3)
    for u, ts, te in random_queries(g, 24, seed=3):
        k = int(rng.choice(sx.ks))
        assert sx.slice_k(k)._component_vertices(u, ts, te) == \
            kcore.tccs_oracle(g, k, u, ts, te), (u, ts, te, k)


def test_per_k_index_matches_reference():
    g, jg = graphs(G30)
    for k in (2, 4):
        got = build_pecb_index(g, k, engine="device", device="cpu")
        want = jax_pecb.build_pecb_index(jg, k)
        assert_fields_equal(got, want, f"k={k}")


def test_carried_reference_strata_build_the_reference_index():
    g, jg = graphs(G40)
    jstrata = jax_ct.stratified_core_times(jg)
    strata = carry.core_times_from_reference(fields(jstrata))
    assert isinstance(strata, ct.StratifiedCoreTable)
    assert_fields_equal(strata, ct.stratified_core_times(g, device="cpu"),
                        "carried strata")
    sx = build_stratified_index(g, strata=strata, device="cpu")
    assert_fields_equal(sx, jax_pecb.build_stratified_index(
        jg, strata=jstrata), "index")


def test_carried_reference_table_builds_the_reference_per_k_index():
    g, jg = graphs(G18)
    jtab = jax_ct.edge_core_times(jg, 3)
    tab = carry.core_times_from_reference(fields(jtab))
    assert isinstance(tab, ct.CoreTimeTable)
    assert_fields_equal(build_pecb_index(g, 3, tab),
                        jax_pecb.build_pecb_index(jg, 3, jtab), "index")


def test_engine_follows_the_device_argument():
    assert ct._engine("auto", "cuda") == "device"
    assert ct._engine("auto", torch.device("cuda", 0)) == "device"
    assert ct._engine("auto", "cpu") == "host"
    assert ct._engine("device", "cpu") == "device"
    assert ct._engine("legacy", "cuda") == "legacy"
    assert ct.ENGINES == ("auto", "host", "device", "legacy")
    with pytest.raises(ValueError, match="unknown engine"):
        ct._engine("jax", "cpu")
    with pytest.raises(ValueError, match="no construction engine"):
        ct._engine("auto", "meta")


def test_empty_graph_and_strata():
    g = gen_temporal_graph(n=5, m=0, t_max=1, seed=0)
    vct = ct._sweep_device(g, 2, device="cpu")
    assert vct.shape == (g.t_max + 1, 5) and (vct == g.t_max + 1).all()
    g = gen_temporal_graph(**G14)
    assert ct._sweep_device_stratified(g, (), device="cpu") == []


@pytest.mark.parametrize("cfg", [G14, G30], ids=["g14", "g30"])
def test_plain_sweep_rows_equal_reference_scans(cfg):
    """The device engine's rows through ``ref.stratum_sweep`` are the
    reference's ``_sweep_jax`` rows (jnp), and its ``"jax_pallas"`` ones
    (the Pallas counter in interpret mode), for every k."""
    g, jg = graphs(cfg)
    for k in ct.default_ks(g):
        got = ct._sweep_device(g, k, device="cpu")
        assert np.array_equal(got, jax_ct._sweep_jax(jg, k)), k
        assert np.array_equal(got, jax_ct._sweep_jax(jg, k, use_pallas=True)), k


@pytest.mark.parametrize("which", ["g14", "g18", "g30", "g40", "t318", "hub"])
def test_stratified_sweep_equals_host_build(which, monkeypatch):
    """Every field of the device engine's strata equals the host's fused
    sweep (which seeds each stratum from the one below: the rows are the
    same); each stratum's counts equal its per-k sweep's; one launch per
    t_uv block, the carry crossing blocks when t_max > TUV_BLOCK."""
    cfgs = {"g14": G14, "g18": G18, "g30": G30, "g40": G40, "t318": T318}
    g = hub_graph() if which == "hub" else gen_temporal_graph(**cfgs[which])
    if which == "hub":
        assert np.diff(ct._pair_csr(g).vptr).max() > 1_024
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return ss.stratum_sweep(*args, **kw)

    monkeypatch.setattr(ct, "stratum_sweep", counted)
    stats = {}
    dev = ct.stratified_core_times(g, engine="device", device="cpu",
                                   stats=stats)
    blocks = -(-g.t_max // ct.TUV_BLOCK)
    assert calls == [min(ct.TUV_BLOCK, g.t_max - b * ct.TUV_BLOCK)
                     for b in range(blocks)]
    assert (which == "t318") == (blocks == 2)
    assert_fields_equal(dev, ct.stratified_core_times(g, device="cpu"),
                        "strata")
    per = stats["strata"]
    assert per.shape == (len(dev.ks), 2) and per.dtype == np.int64
    assert (stats["iterations"], stats["climbs"]) == tuple(per.sum(0))
    assert stats["iterations"] - stats["climbs"] == g.t_max * len(dev.ks)
    for i, k in enumerate(dev.ks):
        st = {}
        ct._sweep_device(g, k, device="cpu", stats=st)
        assert (st["iterations"], st["climbs"]) == tuple(per[i]), k
