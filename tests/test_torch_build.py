"""The port's host build plane against the JAX reference's, array for
array: the seeded graph generator, the core-time sweeps, the stratified
core-time table, the ECB forest builders, the packed k-stratified index
and its device layout. Every output is integer, so equality is exact.
Also the query surface the two share: the deprecated ``PECBIndex.query``
shim and ``core``'s exports."""

import dataclasses
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import batch_query as jax_bq  # noqa: E402
from repro.core import core_time as jax_ct  # noqa: E402
import repro.core as jax_core  # noqa: E402
from repro.core import kcore as jax_kcore  # noqa: E402
from repro.core.pecb_index import \
    build_pecb_index as jax_build_k  # noqa: E402
from repro.core.pecb_index import \
    build_stratified_index as jax_build  # noqa: E402
from repro.core.temporal_graph import \
    gen_temporal_graph as jax_gen  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core import query_api  # noqa: E402
from repro_torch.core import core_time as ct  # noqa: E402
from repro_torch.core import ecb_native, kcore  # noqa: E402
from repro_torch.core.ecb_forest import (FastIncrementalBuilder,  # noqa: E402
                                         IncrementalBuilder)
from repro_torch.core.pecb_index import (build_pecb_index,  # noqa: E402
                                         build_stratified_index, pack_index)
from repro_torch.core.temporal_graph import (BENCH_WORKLOADS,  # noqa: E402
                                             gen_temporal_graph)

# the three graphs of tests/test_stratified.py, and the fb_like workload
GRAPHS = [dict(n=18, m=70, t_max=7, seed=3),
          dict(n=30, m=240, t_max=12, seed=5),
          dict(n=40, m=420, t_max=18, seed=31),
          BENCH_WORKLOADS["fb_like"]]
IDS = ["g18", "g30", "g40", "fb_like"]


def assert_fields_equal(a, b, path="index"):
    """Recursive dataclass equality: arrays by value and dtype."""
    assert dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        where = f"{path}.{f.name}"
        if dataclasses.is_dataclass(va):
            assert_fields_equal(va, vb, where)
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, where
            assert np.array_equal(va, vb), where
        else:
            assert va == vb, where


@pytest.fixture(scope="module", params=range(len(GRAPHS)), ids=IDS)
def built(request):
    """(port graph, reference graph, port index, reference index)."""
    cfg = GRAPHS[request.param]
    g, jg = gen_temporal_graph(**cfg), jax_gen(**cfg)
    return g, jg, build_stratified_index(g, device="cpu"), jax_build(jg)


def test_graph_generator_is_the_reference(built):
    g, jg, _, _ = built
    assert (g.n, g.m, g.t_max) == (jg.n, jg.m, jg.t_max)
    for f in ("src", "dst", "t"):
        assert np.array_equal(getattr(g, f), getattr(jg, f)), f


def test_kcore_oracles_match_reference(built):
    g, jg, sx, _ = built
    assert kcore.k_max(g) == jax_kcore.k_max(jg) == sx.k_max_graph
    rng = np.random.default_rng(g.n)
    for _ in range(6):
        u = int(rng.integers(0, g.n))
        ts = int(rng.integers(1, g.t_max + 1))
        te = int(rng.integers(ts, g.t_max + 1))
        k = int(rng.choice(sx.ks))
        assert kcore.tccs_oracle(g, k, u, ts, te) == \
            jax_kcore.tccs_oracle(jg, k, u, ts, te)
        assert kcore.tccs_oracle_edges(g, k, u, ts, te) == \
            jax_kcore.tccs_oracle_edges(jg, k, u, ts, te)
        assert sx.slice_k(k)._component_vertices(u, ts, te) == \
            kcore.tccs_oracle(g, k, u, ts, te), (u, ts, te, k)


def test_stratified_core_times_match_reference(built):
    g, jg, _, _ = built
    assert_fields_equal(ct.stratified_core_times(g, device="cpu"),
                        jax_ct.stratified_core_times(jg, engine="host"),
                        "strata")


def test_per_k_sweep_matches_reference_and_stratum(built):
    g, jg, sx, _ = built
    for k in (sx.ks[0], sx.ks[-1]):
        vct = ct._sweep_host(g, k)
        assert np.array_equal(vct, jax_ct._sweep_host(jg, k)), k
        assert np.array_equal(vct, sx.strata.table_for(k).vertex_ct), k


def test_stratified_index_matches_reference(built):
    _, _, sx, jsx = built
    assert_fields_equal(sx, jsx)
    for k in sx.ks:
        assert_fields_equal(sx.slice_k(k), jsx.slice_k(k), f"slice_k({k})")


def test_host_layout_matches_reference(built):
    _, _, sx, jsx = built
    meta, arrays = bq._host_layout(sx)
    jmeta, jarrays = jax_bq._host_layout(jsx)
    assert meta == jmeta
    assert arrays.keys() == jarrays.keys()
    for name, a in arrays.items():
        assert a.dtype == np.int32 and np.array_equal(a, jarrays[name]), name
    for k in sx.ks[:2]:
        meta, arrays = bq._host_layout(sx.slice_k(k))
        jmeta, jarrays = jax_bq._host_layout(jsx.slice_k(k))
        assert meta == jmeta
        for name, a in arrays.items():
            assert np.array_equal(a, jarrays[name]), (k, name)


def test_forest_builders_pack_identically():
    # the native C engine (when a C compiler exists) and both Python
    # builders produce the same packed index for every stratum
    g = gen_temporal_graph(**GRAPHS[1])
    strata = ct.stratified_core_times(g, device="cpu")
    for k in strata.ks:
        tab = strata.table_for(k)
        base = pack_index(g, k, IncrementalBuilder(g, tab).run())
        fast = pack_index(g, k, FastIncrementalBuilder(g, tab).run())
        assert_fields_equal(fast, base, f"fast k={k}")
        if ecb_native.available():
            native = pack_index(g, k,
                                ecb_native.NativeForestBuilder(g, tab).run())
            assert_fields_equal(native, base, f"native k={k}")


def test_native_library_lives_in_the_port_build_dir():
    if not ecb_native.available():
        pytest.skip("no C compiler on this host")
    from repro_torch.kernels._build import BUILD_DIR
    assert any(BUILD_DIR.glob("ecb_native_*.so"))
    assert BUILD_DIR.parent.name == "repro_torch"


# the inputs of tests/test_query_api.py's legacy-shim test (ten random
# windows) and tests/test_streaming.py's shim warning (one window)
SHIM_CASES = {
    "query_api": (dict(n=35, m=280, t_max=16, seed=8), 10),
    "streaming": (dict(n=20, m=140, t_max=8, seed=51), 0),
}


def shim_windows(g, n_q):
    """tests/test_query_api.py's ``random_windows(g, n_q, rng(1))``, or
    tests/test_streaming.py's ``(0, 1, 5)`` when ``n_q`` is 0."""
    if not n_q:
        return [(0, 1, 5)]
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n_q):
        u = int(rng.integers(0, g.n))
        ts = int(rng.integers(1, g.t_max + 1))
        out.append((u, ts, int(rng.integers(ts, g.t_max + 1))))
    return out


@pytest.mark.parametrize("case", sorted(SHIM_CASES))
def test_query_shim_warns_and_answers_as_the_reference(case):
    cfg, n_q = SHIM_CASES[case]
    g, jg = gen_temporal_graph(**cfg), jax_gen(**cfg)
    idx = build_pecb_index(g, 2, device="cpu")
    jidx = jax_build_k(jg, 2, jax_ct.edge_core_times(jg, 2))
    for (u, ts, te) in shim_windows(g, n_q):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            answer = idx.query(u, ts, te)
        with warnings.catch_warnings(record=True) as want:
            warnings.simplefilter("always")
            jax_answer = jidx.query(u, ts, te)
        assert answer == jax_answer == idx._component_vertices(u, ts, te)
        assert [(w.category, str(w.message)) for w in got] == [
            (w.category, str(w.message)) for w in want]
        assert got[0].category is DeprecationWarning
        assert got[0].filename == __file__          # stacklevel=2
    with pytest.warns(DeprecationWarning, match="deprecated"):
        idx.query(0, 1, g.t_max)


def test_core_exports_the_query_api_as_the_reference():
    assert port_core.__all__ == jax_core.__all__
    for name in port_core.__all__:
        assert getattr(port_core, name) is getattr(query_api, name)
