"""The port's serving engine (``repro_torch.serving``, ``device="cpu"``:
B1 through its plain version) against the JAX package's
(``repro.serving.ServingEngine``, JAX on the CPU) and against Algorithm 1:
the same seeded graph and query stream go through both engines, on the
device route (``host_threshold=0``) and the host route (``10**9``), in
every result mode, for one k, a mixed-k stream, k above the graph's k_max
(exactly empty) and an in-range k outside the strata policy
(``InvalidQueryError`` on the future). Tolerance 0: vertex sets, edge
sets, counts, canonical specs, routes and provenance fields (times
excluded) and the engines' counters must be equal.

Also the engine's own contracts: clamped and empty windows share one
cache key, cache hits re-stamped ``route="cache"``, window sweeps, the
deprecation shims, warmup with a non-power-of-two ``max_batch``, a cold
workload that does not block the submit path, LRU eviction, close
draining, ``store_dir`` raising, the default ``cuda`` device, the port's
compile accounting (kernel builds, not XLA compiles), and exact kernel
launch counts under threads."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.query_api import ResultMode as JaxMode  # noqa: E402
from repro.core.query_api import WindowSweep as JaxSweep  # noqa: E402
from repro.core.temporal_graph import \
    gen_temporal_graph as jax_gen  # noqa: E402
from repro.serving import EngineConfig as JaxConfig  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import TCCSQuery as JaxQuery  # noqa: E402
from repro_torch.core.kcore import tccs_oracle  # noqa: E402
from repro_torch.core.query_api import (EMPTY_WINDOW,  # noqa: E402
                                        InvalidQueryError, ResultMode,
                                        TCCSQuery, WindowSweep)
from repro_torch.core.temporal_graph import gen_temporal_graph  # noqa: E402
from repro_torch.kernels import _args  # noqa: E402
from repro_torch.serving import (EngineConfig, IndexRegistry,  # noqa: E402
                                 ServingEngine, executor)

GRAPH = dict(n=40, m=320, t_max=16, seed=11)
TIMEOUT = 60
#: counters the two engines keep differently by design: the reference
#: counts XLA compiles, the port kernel builds and propagation rounds
OWN_COUNTERS = ("jit_compile", "kernel_build", "propagation_rounds")


@pytest.fixture(scope="module")
def graphs():
    return gen_temporal_graph(**GRAPH), jax_gen(**GRAPH)


def port_engine(cfg=None, **kw):
    return ServingEngine(cfg or EngineConfig(), device="cpu", **kw)


def stream(g, n_q, ks, seed, mode=ResultMode.VERTICES):
    """(u, ts, te, k, mode) specs: in-range, clamped (ts < 1, te > t_max)
    and empty windows, each repeated once later (a cache hit)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_q):
        u = int(rng.integers(0, g.n))
        ts = int(rng.integers(1, g.t_max + 1))
        te = int(rng.integers(ts, g.t_max + 1))
        if i % 7 == 3:
            ts, te = -2, g.t_max + 5
        elif i % 11 == 5:
            ts, te = EMPTY_WINDOW
        out.append((u, ts, te, int(rng.choice(ks)), mode.value))
    return out + out[: n_q // 3]


def run_chunks(eng, cls, specs, chunk):
    """Submit ``specs`` chunk by chunk, waiting for each chunk's answers:
    a fixed batching, so both engines see the same batches. Returns each
    spec's result or exception."""
    out = []
    for i in range(0, len(specs), chunk):
        futs = eng.submit_specs("g", [cls(*s) for s in specs[i:i + chunk]])
        eng.flush()
        for f in futs:
            exc = f.exception(timeout=TIMEOUT)
            out.append(exc if exc is not None else f.result())
    eng.drain(timeout=TIMEOUT)
    return out


def prov_key(p):
    return (p.route, p.backend, p.index_key, p.batch_size, p.bucket)


def query_key(q):
    return (q.u, q.ts, q.te, q.k, q.mode.value)


def assert_result_equal(got, want):
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
        return
    assert query_key(got.query) == query_key(want.query)
    assert got.vertices == want.vertices
    assert (got.num_vertices, got.num_edges) == (want.num_vertices,
                                                 want.num_edges)
    assert prov_key(got.provenance) == prov_key(want.provenance)
    assert (got.edges is None) == (want.edges is None)
    if want.edges is not None:
        for f in ("u", "v", "t", "ct", "edge_id"):
            a, b = getattr(got.edges, f), getattr(want.edges, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.subgraph is None) == (want.subgraph is None)
    if want.subgraph is not None:
        assert got.subgraph.n == want.subgraph.n
        for f in ("src", "dst", "t"):
            assert np.array_equal(getattr(got.subgraph, f),
                                  getattr(want.subgraph, f)), f


def assert_alg1(g, spec, res):
    """One answer against Algorithm 1 (``kcore.tccs_oracle``)."""
    u, ts, te, k, mode = spec
    cq = TCCSQuery(u, ts, te, k).canonical(g.t_max)
    want = (set() if cq.is_empty_window
            else tccs_oracle(g, k, u, cq.ts, cq.te))
    assert res.num_vertices == len(want)
    if mode != "count":
        assert set(res.vertices) == want


def counters(eng):
    return {k: v for k, v in eng.metrics.snapshot()["counters"].items()
            if not k.startswith(OWN_COUNTERS)}


K_CASES = ("single", "mixed", "above_kmax", "outside_set_ks")


@pytest.mark.parametrize("kcase", K_CASES)
@pytest.mark.parametrize("mode", list(ResultMode), ids=lambda m: m.value)
@pytest.mark.parametrize("host_threshold", [0, 10**9],
                         ids=["device", "host"])
def test_engine_answers_equal_reference_and_alg1(graphs, host_threshold,
                                                 mode, kcase):
    g, jg = graphs
    cfg = dict(max_batch=16, flush_ms=500.0, min_bucket=8,
               host_threshold=host_threshold, cache_capacity=256)
    with port_engine(EngineConfig(**cfg)) as eng, \
            JaxEngine(JaxConfig(**cfg)) as jeng:
        for e, graph in ((eng, g), (jeng, jg)):
            if kcase == "outside_set_ks":
                e.registry.set_ks("g", (2, 3))
            e.register_graph("g", graph)
        h = eng.warmup("g")
        jeng.warmup("g")
        kmax = h.pecb.k_max_graph
        ks = {"single": [h.supported_ks[-1]],
              "mixed": list(h.supported_ks),
              "above_kmax": [kmax + 1, kmax + 4],
              "outside_set_ks": [2, 3, kmax]}[kcase]
        specs = stream(g, 30, ks, seed=len(kcase), mode=mode)
        got = run_chunks(eng, TCCSQuery, specs, chunk=12)
        want = run_chunks(jeng, JaxQuery,
                          [s[:4] + (JaxMode(s[4]),) for s in specs],
                          chunk=12)
        assert counters(eng) == counters(jeng)
    for spec, a, b in zip(specs, got, want):
        assert_result_equal(a, b)
        empty = TCCSQuery(*spec[:4]).canonical(g.t_max).is_empty_window
        if kcase == "outside_set_ks" and spec[3] not in (2, 3) and not empty:
            assert isinstance(a, InvalidQueryError)
        else:
            assert_alg1(g, spec, a)
    routes = {r.provenance.route for r in got if not isinstance(r, Exception)}
    if kcase == "above_kmax":       # answered host-side, then cached
        assert routes == {"trivial", "cache"}
    else:
        assert routes - {"trivial", "cache"} == {
            "device" if host_threshold == 0 else "host"}
        assert "cache" in routes


def test_clamped_and_empty_windows_share_one_cache_key(graphs):
    g, _ = graphs
    with port_engine(EngineConfig(flush_ms=500.0, host_threshold=0)) as eng:
        eng.register_graph("g", g)
        eng.warmup("g")
        first = eng.answer("g", TCCSQuery(3, -4, g.t_max + 9, 2),
                           timeout=TIMEOUT)
        again = eng.answer("g", TCCSQuery(3, 1, g.t_max, 2), timeout=TIMEOUT)
        assert (first.query.ts, first.query.te) == (1, g.t_max)
        assert first.provenance.route == "device"
        assert again.provenance.route == "cache"
        assert again.vertices == first.vertices
        empty = eng.answer("g", TCCSQuery(3, g.t_max + 1, g.t_max + 9, 2),
                           timeout=TIMEOUT)
        assert empty.provenance.route == "trivial" and not empty.vertices
        assert (empty.query.ts, empty.query.te) == EMPTY_WINDOW
        assert eng.cache.stats()["size"] == 1
        with pytest.raises(InvalidQueryError, match="ts > te"):
            eng.submit_spec("g", TCCSQuery(3, 9, 2, 2))


def test_cache_hit_is_restamped_on_a_copy(graphs):
    g, _ = graphs
    with port_engine(EngineConfig(flush_ms=500.0, host_threshold=0)) as eng:
        eng.register_graph("g", g)
        q = TCCSQuery(5, 2, 13, 2)
        first = eng.answer("g", q, timeout=TIMEOUT)
        hit = eng.answer("g", q, timeout=TIMEOUT)
        assert hit.provenance.route == "cache"
        assert hit.vertices == first.vertices
        assert hit.provenance.trace_id != first.provenance.trace_id
        hit.provenance.timings["x"] = 1
        stored = eng.cache.get(("g", q.cache_key()))
        assert stored.provenance.route == "device"
        assert "x" not in stored.provenance.timings
        assert eng.metrics.counter("cache_hits") == 1


@pytest.mark.parametrize("n_windows, host_threshold", [(40, 8), (5, 8)],
                         ids=["device", "host"])
def test_sweep_equals_reference_and_alg1(graphs, n_windows, host_threshold):
    g, jg = graphs
    wins = [(1 + d % g.t_max, min(1 + d % g.t_max + d % 7, g.t_max))
            for d in range(n_windows)]
    cfg = dict(max_batch=16, flush_ms=500.0, host_threshold=host_threshold)
    with port_engine(EngineConfig(**cfg)) as eng, \
            JaxEngine(JaxConfig(**cfg)) as jeng:
        eng.register_graph("g", g)
        jeng.register_graph("g", jg)
        k = eng.warmup("g").supported_ks[1]
        jeng.warmup("g")
        eng.answer("g", TCCSQuery(0, *wins[0], k), timeout=TIMEOUT)  # a hit
        jeng.answer("g", JaxQuery(0, *wins[0], k), timeout=TIMEOUT)
        got = eng.sweep("g", WindowSweep(0, k, wins))
        want = jeng.sweep("g", JaxSweep(0, k, wins))
        assert counters(eng) == counters(jeng)
    for (ts, te), a, b in zip(wins, got, want):
        assert_result_equal(a, b)
        assert_alg1(g, (0, ts, te, k, "vertices"), a)
    assert got[0].provenance.route == "cache"
    assert {r.provenance.route for r in got[1:]} == {
        "sweep" if n_windows > host_threshold else "host"}


def test_deprecation_shims_resolve_vertex_sets(graphs):
    g, jg = graphs
    qs = [(u, 2, 14) for u in range(6)] + [(1, 9, 3)]
    cfg = dict(flush_ms=500.0, host_threshold=0)
    with port_engine(EngineConfig(**cfg)) as eng, \
            JaxEngine(JaxConfig(**cfg)) as jeng:
        out = []
        for e, graph in ((eng, g), (jeng, jg)):
            e.register_graph("g", graph)
            with pytest.warns(DeprecationWarning, match="warmup"):
                e.warmup("g", 2)
            with pytest.warns(DeprecationWarning, match="submit_many"):
                many = e.submit_many("g", 3, qs)
            with pytest.warns(DeprecationWarning, match="submit"):
                one = e.submit("g", 2, 4, 1, 16)
            e.flush()
            with pytest.warns(DeprecationWarning, match="query"):
                q = e.query("g", 2, 7, 3, 12, timeout=TIMEOUT)
            with pytest.warns(DeprecationWarning, match="per-k registry"):
                assert ("g", 2) in e.registry
            with pytest.warns(DeprecationWarning, match="per-k registry"):
                e.registry.get("g", 2)
            out.append(([f.result(timeout=TIMEOUT) for f in many],
                        one.result(timeout=TIMEOUT), q))
    assert out[0] == out[1]
    assert all(isinstance(v, frozenset) for v in out[0][0])
    assert out[0][0][-1] == frozenset()      # lenient: ts > te is empty


def test_warmup_non_power_of_two_max_batch(graphs):
    g, _ = graphs
    cfg = EngineConfig(max_batch=24, min_bucket=8, flush_ms=500.0,
                       host_threshold=0)
    with port_engine(cfg) as eng:
        eng.register_graph("g", g)
        eng.warmup("g", sweep=True, full=True, sweep_ks=(2,))
        ex = eng.executor
        assert [ex.final_bucket(b, 8, 24) for b in (1, 9, 17, 24)] == [
            8, 16, 24, 24]
        specs = [TCCSQuery(u % g.n, 1, g.t_max, 2) for u in range(24)]
        futs = eng.submit_specs("g", specs)
        eng.flush()
        res = [f.result(timeout=TIMEOUT) for f in futs]
        assert {r.provenance.bucket for r in res} == {24}
        assert eng.metrics.counter("device_padded_slots") == 0


def test_cold_workload_does_not_block_submit(graphs, monkeypatch):
    g, _ = graphs
    gate = threading.Event()
    with port_engine(EngineConfig(flush_ms=1.0, host_threshold=0)) as eng:
        real = eng.registry._build

        def slow_build(key):
            assert gate.wait(TIMEOUT)
            return real(key)

        monkeypatch.setattr(eng.registry, "_build", slow_build)
        eng.register_graph("g", g)
        fut = eng.submit_spec("g", TCCSQuery(2, 1, g.t_max, 2))
        assert not fut.done()
        assert eng.registry.get_nowait("g", start_build=False) is None
        assert eng.metrics.counter("cold_submits") == 1
        gate.set()
        res = fut.result(timeout=TIMEOUT)
        assert res.vertices == frozenset(tccs_oracle(g, 2, 2, 1, g.t_max))
        assert eng.registry.get_nowait("g") is not None


def test_lru_eviction_at_registry_capacity(graphs):
    g, _ = graphs
    g2 = gen_temporal_graph(n=30, m=200, t_max=12, seed=4)
    cfg = EngineConfig(registry_capacity=1, flush_ms=500.0, host_threshold=0)
    with port_engine(cfg) as eng:
        eng.register_graph("a", g)
        eng.register_graph("b", g2)
        ra = eng.answer("a", TCCSQuery(1, 1, g.t_max, 2), timeout=TIMEOUT)
        assert "a" in eng.registry and len(eng.cache) == 1
        eng.answer("b", TCCSQuery(1, 1, g2.t_max, 2), timeout=TIMEOUT)
        st = eng.registry.stats()
        assert st["resident"] == ["b"] and st["evictions"] == 1
        assert "a" not in eng._batchers
        assert eng.metrics.counter("cache_purged") == 1
        again = eng.answer("a", TCCSQuery(1, 1, g.t_max, 2), timeout=TIMEOUT)
        assert again.vertices == ra.vertices
        assert again.provenance.route == "device"
        assert eng.registry.stats()["builds"] == 3


def test_close_drains_pending_work(graphs):
    g, _ = graphs
    eng = port_engine(EngineConfig(flush_ms=10_000.0, host_threshold=0))
    eng.register_graph("g", g)
    eng.warmup("g")
    futs = eng.submit_specs("g", [TCCSQuery(u, 2, 12, 2) for u in range(5)])
    eng.close()
    assert all(f.done() for f in futs)
    assert [f.result().vertices for f in futs] == [
        frozenset(tccs_oracle(g, 2, u, 2, 12)) for u in range(5)]
    assert eng.metrics.counter("flush_close") == 1
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit_spec("g", TCCSQuery(0, 1, 2, 2))
    eng.close()                                  # idempotent


def test_store_dir_raises_naming_a6(tmp_path):
    with pytest.raises(NotImplementedError, match="A6"):
        ServingEngine(EngineConfig(store_dir=str(tmp_path)), device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        IndexRegistry(store=object(), device="cpu")


def test_default_device_is_cuda_and_nothing_falls_back(graphs):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CPU-only contract")
    g, _ = graphs
    with ServingEngine(EngineConfig(flush_ms=1.0)) as eng:
        assert eng.executor.device == torch.device("cuda")
        assert eng.registry.device == torch.device("cuda")
        assert eng.executor.num_devices == 1
        eng.register_graph("g", g)
        with pytest.raises((RuntimeError, AssertionError)):
            eng.warmup("g")
        fut = eng.submit_spec("g", TCCSQuery(0, 1, 4, 2))
        with pytest.raises((RuntimeError, AssertionError)):
            fut.result(timeout=TIMEOUT)
        assert eng.registry.stats()["builds"] == 0
    assert IndexRegistry().device == torch.device("cuda")
    with pytest.raises(ValueError, match="builds on cpu"):
        ServingEngine(registry=IndexRegistry(device="cpu"))


def test_compile_count_counts_kernel_builds_once(graphs, monkeypatch):
    """The port compiles nothing per bucket: on CPU tensors nothing is
    built at all, and a kernel library loaded during a batch (simulated:
    B1's library count rises once) counts one ``kernel_builds`` with one
    ``"compile"`` span, and none after warmup."""
    g, _ = graphs
    cfg = EngineConfig(max_batch=64, flush_ms=500.0, host_threshold=0)
    with port_engine(cfg) as eng:
        eng.register_graph("g", g)
        assert eng.executor.compile_count() == 0
        eng.warmup("g")
        assert eng.executor.compile_count() == 0
        assert eng.metrics.counter("kernel_builds") == 0
        assert eng.metrics.counter("propagation_rounds") >= 4
        loads = iter([0, 1])
        monkeypatch.setattr(executor, "_loaded_libraries",
                            lambda: next(loads, 1))
        for b in (3, 9, 40):
            futs = eng.submit_specs("g", [TCCSQuery(u, 1, 9, 2)
                                          for u in range(b)])
            eng.flush()
            for f in futs:
                f.result(timeout=TIMEOUT)
        assert eng.metrics.counter("kernel_builds") == 1
        (span,) = eng.tracer.spans(name="kernel_build")
        assert span.cat == "compile" and span.attrs["library"] == "label_prop"
        assert eng.stats()["kernel_libraries"] == 1


def test_launch_counts_are_exact_under_threads():
    """``count_launch`` from several threads with a tiny switch interval:
    an unlocked ``+= 1`` would lose counts."""
    def fake():
        pass

    fake.launches, fake.routes = 0, {"a": 0, "b": 0}
    n, per = 4, 20_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda r=r: [
            _args.count_launch(fake, r) for _ in range(per)])
            for r in ("a", "b", "a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fake.launches == n * per
    assert fake.routes == {"a": 2 * per, "b": 2 * per}


def test_shared_registry_serves_two_engines(graphs):
    g, _ = graphs
    reg = IndexRegistry(capacity=2, device="cpu")
    reg.register_graph("g", g)
    cfg = EngineConfig(flush_ms=500.0, host_threshold=0)
    try:
        with ServingEngine(cfg, registry=reg, device="cpu") as e1, \
                ServingEngine(cfg, registry=reg, device="cpu") as e2:
            a = e1.answer("g", TCCSQuery(4, 2, 11, 3), timeout=TIMEOUT)
            b = e2.answer("g", TCCSQuery(4, 2, 11, 3), timeout=TIMEOUT)
            assert a.vertices == b.vertices
            assert reg.stats()["builds"] == 1
    finally:
        reg.close()
