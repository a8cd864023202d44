"""The port's serving engine across epochs (``ingest`` and ``retain``,
``device="cpu"``) against the JAX package's engine on the same graph and
edges: answers after each swap equal the reference engine's and
Algorithm 1, the swapped-in index equals a cold build of the epoch's
graph field for field (and the reference's), ``ResultCache.purge_window``
purges and rehomes the same keys, ``RetentionPolicy`` trims on the same
ingests (``slack``, ``every``), and a batch in flight on the old handle
stays exact across a swap. Tolerance 0: every compared value is an int,
an integer array (dtype included) or a vertex or edge set."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.temporal_graph import \
    gen_temporal_graph as jax_gen  # noqa: E402
from repro.serving import EngineConfig as JaxConfig  # noqa: E402
from repro.serving import ResultCache as JaxCache  # noqa: E402
from repro.serving import RetentionPolicy as JaxPolicy  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import TCCSQuery as JaxQuery  # noqa: E402
from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core.kcore import tccs_oracle  # noqa: E402
from repro_torch.core.pecb_index import build_stratified_index  # noqa: E402
from repro_torch.core.query_api import ResultMode, TCCSQuery  # noqa: E402
from repro_torch.core.temporal_graph import gen_temporal_graph  # noqa: E402
from repro_torch.serving import (EngineConfig, ResultCache,  # noqa: E402
                                 RetentionPolicy, ServingEngine)

GRAPH = dict(n=40, m=360, t_max=20, seed=5)
T_OLD = 16
TIMEOUT = 60


@pytest.fixture(scope="module")
def graphs():
    return gen_temporal_graph(**GRAPH), jax_gen(**GRAPH)


def days(g):
    """Epoch 0 (``g.split_at(T_OLD)``) and the suffix edges of each later
    day."""
    g0, suffix = g.split_at(T_OLD)
    return g0, [[tuple(e) for e in suffix[suffix[:, 2] == d].tolist()]
                for d in range(T_OLD + 1, g.t_max + 1)]


def fields_equal(a, b, path="index"):
    """Dataclass equality across the two packages or within the port:
    arrays by dtype and value, nested dataclasses by their fields."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            fields_equal(va, vb, f"{path}.{f.name}")
        elif isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), \
                f"{path}.{f.name}"
        else:
            assert va == vb, f"{path}.{f.name}"


def specs_for(g, ks, seed, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ts = int(rng.integers(1, g.t_max + 1))
        te = int(rng.integers(ts, g.t_max + 1))
        if i % 4 == 0:
            te = g.t_max                     # ends on the newest day
        mode = ResultMode.EDGES if i % 5 == 0 else ResultMode.VERTICES
        out.append((int(rng.integers(0, g.n)), ts, te, int(rng.choice(ks)),
                    mode.value))
    return out


def answer(eng, cls, specs):
    futs = eng.submit_specs("g", [cls(*s) for s in specs])
    eng.flush()
    return [f.result(timeout=TIMEOUT) for f in futs]


def assert_same_answers(g, specs, got, want):
    for (u, ts, te, k, mode), a, b in zip(specs, got, want):
        assert a.vertices == b.vertices
        assert a.provenance.route == b.provenance.route
        assert (a.query.ts, a.query.te) == (b.query.ts, b.query.te)
        if mode == "edges":
            assert a.edges.edge_ids() == b.edges.edge_ids()
        cq = TCCSQuery(u, ts, te, k).canonical(g.t_max)
        assert set(a.vertices) == (
            set() if cq.is_empty_window
            else tccs_oracle(g, k, u, cq.ts, cq.te))


def assert_cold_equal(h, jh, g):
    """The swapped-in handle equals a cold build of its graph, and the
    reference engine's handle, field for field; its mirror a fresh
    upload of the cold build."""
    cold = build_stratified_index(g, device="cpu")
    fields_equal(h.pecb, cold, "vs cold")
    fields_equal(h.pecb, jh.pecb, "vs reference")
    fields_equal(h.tab, cold.strata, "table vs cold")
    fresh = bq.to_device(cold, "cpu")
    for f in bq._ARRAY_FIELDS:
        assert torch.equal(getattr(h.device, f), getattr(fresh, f)), f


def engines(host_threshold, **kw):
    cfg = dict(max_batch=32, flush_ms=500.0, host_threshold=host_threshold,
               **kw)
    return (ServingEngine(EngineConfig(**cfg), device="cpu"),
            JaxEngine(JaxConfig(**cfg)))


@pytest.mark.parametrize("host_threshold", [0, 10**9],
                         ids=["device", "host"])
def test_ingest_days_equal_reference_and_cold_build(graphs, host_threshold):
    g, jg = graphs
    (g0, daily), (jg0, jdaily) = days(g), days(jg)
    assert daily == jdaily
    eng, jeng = engines(host_threshold)
    with eng, jeng:
        eng.register_graph("g", g0)
        jeng.register_graph("g", jg0)
        h = eng.warmup("g")
        jeng.warmup("g")
        warm = specs_for(g0, h.supported_ks, seed=0)
        assert_same_answers(g0, warm, answer(eng, TCCSQuery, warm),
                            answer(jeng, JaxQuery, warm))
        cur = g0
        for day, edges in enumerate(daily, T_OLD + 1):
            futs = eng.ingest("g", edges, wait=True, timeout=TIMEOUT)
            jeng.ingest("g", edges, wait=True, timeout=TIMEOUT)
            h = futs["g"].result(timeout=TIMEOUT)
            cur = cur.extend(edges)
            assert h.epoch == day - T_OLD and h.graph.t_max == day
            assert eng.registry.get_nowait("g") is h
            specs = specs_for(cur, h.supported_ks, seed=day)
            assert_same_answers(cur, specs, answer(eng, TCCSQuery, specs),
                                answer(jeng, JaxQuery, specs))
        # the warm working set survived every suffix epoch: all hits
        again = answer(eng, TCCSQuery, warm)
        assert_same_answers(g0, warm, again, answer(jeng, JaxQuery, warm))
        assert {r.provenance.route for r in again} == {"cache"}
        jh = jeng.registry.get_nowait("g")
        assert_cold_equal(h, jh, g)
        own = ("jit_", "kernel_", "propagation")   # kept only by one side
        assert ({k: v for k, v in eng.metrics.snapshot()["counters"].items()
                 if not k.startswith(own)}
                == {k: v for k, v in
                    jeng.metrics.snapshot()["counters"].items()
                    if not k.startswith(own)})
        assert eng.metrics.counter("cache_purged_targeted") == 0


def warm_cache(eng, cls, g, ks):
    specs = [(u, ts, min(ts + w, g.t_max), ks[(u + w) % len(ks)],
              "edges" if u % 4 == 0 else "vertices")
             for u in range(0, g.n, 3) for ts, w in ((2, 4), (9, 6),
                                                     (14, 5))]
    return specs, answer(eng, cls, specs)


@pytest.mark.parametrize("t_cut", [6, 11])
def test_retain_purges_rehomes_and_equals_cold_build(graphs, t_cut):
    g, jg = graphs
    eng, jeng = engines(0, cache_capacity=4096)
    with eng, jeng:
        eng.register_graph("g", g)
        jeng.register_graph("g", jg)
        h0 = eng.warmup("g")
        jeng.warmup("g")
        specs, _ = warm_cache(eng, TCCSQuery, g, h0.supported_ks)
        warm_cache(jeng, JaxQuery, jg, h0.supported_ks)
        futs = eng.retain("g", t_cut, wait=True, timeout=TIMEOUT)
        jeng.retain("g", t_cut, wait=True, timeout=TIMEOUT)
        h = futs["g"].result(timeout=TIMEOUT)
        g2 = g.expire_before(t_cut)
        assert h.graph.t_max == g2.t_max and h.epoch == 1
        assert eng.cache.stats() == jeng.cache.stats()
        assert eng.cache.stats()["rehomes"] > 0
        assert eng.cache.stats()["purges"] > 0
        assert list(eng.cache._data) == list(jeng.cache._data)
        for key, res in eng.cache._data.items():
            spec = key[1]
            assert (res.query.ts, res.query.te) == spec[1:3]
        assert_cold_equal(h, jeng.registry.get_nowait("g"), g2)
        after = specs_for(g2, h.supported_ks, seed=t_cut)
        assert_same_answers(g2, after, answer(eng, TCCSQuery, after),
                            answer(jeng, JaxQuery, after))
        assert eng.metrics.counter("cache_purged_retention") == \
            jeng.metrics.counter("cache_purged_retention")


def test_purge_window_equals_reference_cache():
    """The same puts and purges through both caches: equal counts, keys
    in the same LRU order, and the rehomed results' canonical specs."""
    caches = []
    for cache_cls, q_cls in ((ResultCache, TCCSQuery),
                             (JaxCache, JaxQuery)):
        c = cache_cls(capacity=64)
        for u in range(6):
            for ts, te in ((1, 3), (4, 9), (6, 9), (7, 12), (1, 0)):
                for mode in ("vertices", "edges"):
                    q = q_cls(u, ts, te, 2, mode)
                    c.put(("g", q.cache_key()), type("R", (), {})(),
                          epoch=0)
                    c.put(("h", q.cache_key()), q, epoch=0)
        n_suffix = c.purge_window("g", 10, 14)
        c.raise_floor("g", 1)
        c.put(("g", q_cls(0, 2, 5, 2).cache_key()), None, epoch=0)
        n_trim = c.purge_window("g", 1, 4, shift=4)
        caches.append((n_suffix, n_trim, c.stats(), list(c._data)))
    assert caches[0] == caches[1]
    assert caches[0][0] > 0 and caches[0][2]["rehomes"] > 0
    assert caches[0][2]["gated"] == 1


def test_retention_policy_slack_and_every(graphs):
    g, jg = graphs
    (g0, daily), (jg0, _) = days(g), days(jg)
    eng, jeng = engines(0)
    seen = []
    with eng, jeng:
        for e, graph, pol in ((eng, g0, RetentionPolicy),
                              (jeng, jg0, JaxPolicy)):
            e.register_graph("g", graph)
            e.warmup("g")
            e.set_retention("g", pol(window=10, slack=3, every=2))
            steps = []
            for edges in daily:
                e.ingest("g", edges, wait=True, timeout=TIMEOUT)
                h = e.registry.get_nowait("g")
                steps.append((h.epoch, h.graph.t_max, h.graph.m,
                              e.metrics.counter("auto_trims")))
            e.set_retention("g", None)
            assert e.retention_policy("g") is None
            seen.append(steps)
    assert seen[0] == seen[1]
    # set_retention trims at once (t_max 16 > 10 + 3), then every=2 and
    # the slack let only some of the four ingests trim again
    trims = [s[3] for s in seen[0]]
    assert trims[0] == 1 and 1 < trims[-1] < 1 + len(daily)
    with pytest.raises(ValueError):
        RetentionPolicy(window=5, every=0)


def test_inflight_batch_on_old_handle_stays_exact(graphs):
    """A device batch bound to epoch 0 is held inside the executor while an
    ingest swaps epoch 1 in; released, it answers epoch 0's windows from
    epoch 0's handle, whose tensors nothing wrote."""
    g, _ = graphs
    g0, daily = days(g)
    entered, release = threading.Event(), threading.Event()
    with ServingEngine(EngineConfig(flush_ms=500.0, host_threshold=0),
                       device="cpu") as eng:
        eng.register_graph("g", g0)
        h0 = eng.warmup("g")
        before = {f: getattr(h0.device, f).clone()
                  for f in bq._ARRAY_FIELDS}
        run = eng.executor.run

        def held(replicas, *args, **kw):
            if replicas is h0.replicas and not release.is_set():
                entered.set()
                assert release.wait(TIMEOUT)
            return run(replicas, *args, **kw)

        eng.executor.run = held
        specs = [TCCSQuery(u, 1, g0.t_max, 2) for u in range(12)]
        futs = eng.submit_specs("g", specs)
        eng.flush()
        assert entered.wait(TIMEOUT)
        edges = [e for day in daily for e in day]
        ing = eng.ingest("g", edges)
        for _ in range(TIMEOUT * 100):
            if eng.registry.get_nowait("g") is not h0:
                break
            threading.Event().wait(0.01)
        h1 = eng.registry.get_nowait("g")
        assert h1 is not h0 and h1.epoch == 1
        assert not any(f.done() for f in futs)
        release.set()
        got = [f.result(timeout=TIMEOUT) for f in futs]
        ing["g"].result(timeout=TIMEOUT)
        for q, r in zip(specs, got):
            assert set(r.vertices) == tccs_oracle(g0, 2, q.u, 1, g0.t_max)
        for f, t in before.items():
            assert torch.equal(getattr(h0.device, f), t), f
        new = eng.answer("g", TCCSQuery(3, 1, g.t_max, 2), timeout=TIMEOUT)
        assert set(new.vertices) == tccs_oracle(g, 2, 3, 1, g.t_max)
        assert new.provenance.route == "device"
