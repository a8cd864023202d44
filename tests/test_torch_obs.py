"""The port's observability plane (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU: latency histograms and metrics
snapshots from the same observations, Chrome trace events from the same
span trees and from the same engine traffic (names, categories, phases
and parent links; times are not compared), the slow-query log's gating,
and the port's lock witness over a live engine (concurrent submits and an
ingest) and a deliberate rank inversion. Tolerance 0: every compared
value is an int, a string or the same float computed the same way."""

import collections
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jax_obs  # noqa: E402
from repro.core.temporal_graph import \
    gen_temporal_graph as jax_gen  # noqa: E402
from repro.serving import EngineConfig as JaxConfig  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import TCCSQuery as JaxQuery  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.temporal_graph import gen_temporal_graph  # noqa: E402
from repro_torch.obs import locks  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving import TCCSQuery  # noqa: E402

GRAPH = dict(n=40, m=300, t_max=16, seed=21)
TIMEOUT = 60


@pytest.mark.parametrize("cap", [4, 64, 100_000])
@pytest.mark.parametrize("seed", [0, 3])
def test_histogram_summary_equals_reference(cap, seed):
    """Same samples, same reservoir seed: the reservoir keeps the same
    slots, so every percentile is the same float."""
    xs = np.random.default_rng(seed).exponential(0.01, 500).tolist()
    got, want = obs.LatencyHistogram(cap, seed), jax_obs.LatencyHistogram(
        cap, seed)
    for x in xs:
        got.add(x)
        want.add(x)
    assert got.summary() == want.summary()
    assert got._samples == want._samples
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert got.percentile(q) == want.percentile(q)


def test_histogram_threads_lose_nothing():
    h = obs.LatencyHistogram(cap=100_000)
    threads = [threading.Thread(target=lambda t=t: [
        h.add((t * 1000 + i) * 1e-6) for i in range(1000)]) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert h.count == 8000 and len(h._samples) == 8000


def feed_registry(reg):
    reg.count("queries", 5)
    reg.count("cache_hits")
    reg.count("queries")
    reg.gauge("devices", 1)
    reg.gauge("lazy", lambda: 7)
    for i in range(40):
        reg.observe("e2e", (i % 13) * 1e-3)
        reg.observe("queue_wait", (i % 5) * 2e-4)
    reg.register_source("cache", lambda: {"size": 3, "hits": 1})
    return reg


def test_metrics_snapshot_equals_reference():
    got = feed_registry(obs.MetricsRegistry())
    want = feed_registry(jax_obs.MetricsRegistry())
    assert got.snapshot() == want.snapshot()
    assert got.format() == want.format()
    assert obs.metrics_to_json(got.snapshot()) == jax_obs.metrics_to_json(
        want.snapshot())
    assert obs.metrics_from_json(obs.metrics_to_json(got.snapshot())) == \
        json.loads(jax_obs.metrics_to_json(want.snapshot()))
    with pytest.raises(ValueError, match="not a string"):
        obs.metrics_to_json({"sources": {("w", 2): 1}})
    got.reset()
    assert got.snapshot()["counters"] == {}
    assert "cache" in got.snapshot()["sources"]


def span_tree(mod):
    """One root with nested and cross-thread children, plus an open span
    (not exported) and one error span."""
    tr = mod.Tracer(capacity=64)
    with tr.span("query", parent=None, cat="query", u=3) as root:
        with tr.span("plan", route="device"):
            pass
        ctx = root.ctx
        box = []
        t = threading.Thread(target=lambda: box.append(
            tr.start_span("execute", parent=ctx, bucket=8)))
        t.start()
        t.join(timeout=TIMEOUT)
        box[0].end()
        root.child("cache", cat="query").end()
    tr.start_span("open", parent=None)               # never ended
    try:
        with tr.span("index_build", parent=None, cat="index"):
            raise KeyError("boom")
    except KeyError:
        pass
    return tr


def structure(events):
    """Events with ids replaced by the name of the parent span: names,
    categories, phases and parent links, no times or ids."""
    names = {e["args"]["span_id"]: e["name"] for e in events
             if e["ph"] == "X"}
    out = []
    for e in events:
        if e["ph"] != "X":
            out.append((e["name"], e["ph"]))
            continue
        args = {k: v for k, v in e["args"].items()
                if k not in ("trace_id", "span_id", "parent_id")}
        out.append((e["name"], e["cat"], e["ph"],
                    names.get(e["args"]["parent_id"]),
                    e["args"]["trace_id"] == e["args"]["span_id"],
                    json.dumps(args, sort_keys=True)))
    return out


def test_chrome_trace_events_equal_reference(tmp_path):
    got_tr, want_tr = span_tree(obs), span_tree(jax_obs)
    got = obs.chrome_trace_events(got_tr.spans(), t0=got_tr.t0)
    want = jax_obs.chrome_trace_events(want_tr.spans(), t0=want_tr.t0)
    assert structure(got) == structure(want)
    assert len(got_tr) == len(want_tr) == 5
    doc = obs.write_chrome_trace(str(tmp_path / "t.json"), got_tr,
                                 extra={"run": 1})
    loaded = json.loads((tmp_path / "t.json").read_text())
    assert jax_obs.validate_chrome_trace(loaded) == len(doc["traceEvents"])
    assert obs.validate_chrome_trace(loaded) == len(got)
    with pytest.raises(ValueError, match="invalid phase"):
        obs.validate_chrome_trace({"traceEvents": [
            {"name": "x", "ph": "Q", "pid": 1, "tid": 1}]})


def test_tracer_ring_and_null_span():
    tr = obs.Tracer(capacity=3)
    for i in range(5):
        tr.start_span(f"s{i}", parent=None).end()
    assert [s.name for s in tr.spans()] == ["s2", "s3", "s4"]
    assert tr.stats() == {"enabled": True, "capacity": 3, "spans": 3,
                          "dropped": 2}
    off = obs.Tracer(enabled=False)
    assert off.start_span("x") is obs.NULL_SPAN
    assert obs.NULL_SPAN.ids == (None, None)
    with pytest.raises(ValueError):
        obs.Tracer(capacity=0)


@pytest.mark.parametrize("threshold, logged", [(None, 0), (0.0, 3),
                                               (1e9, 0)])
def test_slow_query_log_gating(threshold, logged):
    out = []
    for mod in (obs, jax_obs):
        tr = mod.Tracer()
        log = mod.SlowQueryLog(threshold, tracer=tr, cap=2)
        for u in range(3):
            root = tr.start_span("query", parent=None, u=u)
            root.child("execute").end()
            root.end()
            log.observe(root, query=u)
        assert log.observe(mod.NULL_SPAN) is False
        out.append((log.enabled, log.observed, len(log),
                    [(e["query"], [s["name"] for s in e["spans"]])
                     for e in log.entries()]))
    assert out[0] == out[1]
    assert out[0][1] == logged and out[0][2] == min(logged, 2)


def serve_traffic(mod, eng_cls, cfg_cls, query_cls, g, **kw):
    """Host-route traffic, a cache hit, a trivial window and one device
    batch through an engine: a count of its trace events by structure,
    compile spans left out (the reference counts XLA compiles, the port
    kernel builds), and its cache hits."""
    cfg = cfg_cls(max_batch=16, flush_ms=500.0, host_threshold=4,
                  cache_capacity=64)
    with eng_cls(cfg, **kw) as eng:
        eng.register_graph("g", g)
        eng.warmup("g")
        specs = [query_cls(u, 2, 12, 2) for u in range(3)]
        for batch in (specs, specs[:1], [query_cls(0, 1, 0, 2)],
                      [query_cls(u, 1, 16, 3) for u in range(8)]):
            futs = eng.submit_specs("g", batch)
            eng.flush()
            for f in futs:
                f.result(timeout=TIMEOUT)
        eng.drain(timeout=TIMEOUT)
        events = structure(mod.chrome_trace_events(eng.tracer.spans()))
        # a build span's attributes and a query's times differ by run
        return collections.Counter(
            e[:5] + ("" if e[0] in ("index_build", "query") else e[5],)
            for e in events
            if e[0] != "thread_name" and e[1] != "compile"), \
            eng.metrics.counter("cache_hits")


def test_engine_trace_equals_reference():
    got = serve_traffic(obs, ServingEngine, EngineConfig, TCCSQuery,
                        gen_temporal_graph(**GRAPH), device="cpu")
    want = serve_traffic(jax_obs, JaxEngine, JaxConfig, JaxQuery,
                         jax_gen(**GRAPH))
    assert got == want
    names = {k[0] for k in got[0]}
    assert {"query", "queue", "route", "execute", "cache",
            "index_build", "core_times", "forest", "device"} <= names


def test_lock_hierarchy_equals_reference():
    assert locks.LOCK_HIERARCHY == jax_obs.LOCK_HIERARCHY


def test_deliberate_inversion_is_reported():
    w = locks.LockWitness()
    met = locks.named_lock("metrics", witness=w)
    reg = locks.named_lock("registry", witness=w)
    with met:
        with reg:          # registry ranks above metrics: an inversion
            pass
    (inv,) = [p for p in w.check() if p["kind"] == "lock-order"]
    assert (inv["outer"], inv["inner"]) == ("metrics", "registry")
    assert inv["threads"]
    w.reset()
    assert w.check() == [] and w.acquisitions == 0


def test_plain_locks_without_the_flag(monkeypatch):
    monkeypatch.delenv("REPRO_LOCK_WITNESS", raising=False)
    assert not locks.witness_enabled()
    assert isinstance(locks.named_lock("registry"), type(threading.Lock()))
    assert isinstance(locks.named_condition("batcher"), threading.Condition)


def test_witnessed_engine_respects_hierarchy(monkeypatch):
    """The flag armed before the engine is built: concurrent submits from
    four threads, an ingest and its refresh swap record only edges that
    respect the hierarchy, into the port's process-wide witness."""
    monkeypatch.setenv("REPRO_LOCK_WITNESS", "1")
    locks.WITNESS.reset()
    g = gen_temporal_graph(**GRAPH)
    g0, suffix = g.split_at(14)
    cfg = EngineConfig(max_batch=16, flush_ms=1.0, host_threshold=4)
    with ServingEngine(cfg, device="cpu") as eng:
        assert isinstance(eng._lock, locks.WitnessLock)
        eng.register_graph("g", g0)
        h = eng.warmup("g")
        rng = np.random.default_rng(0)
        futs, mu = [], threading.Lock()

        def submit(seed):
            r = np.random.default_rng(seed)
            for _ in range(5):
                batch = [TCCSQuery(int(r.integers(0, g.n)), 1, 14,
                                   int(r.choice(h.supported_ks)))
                         for _ in range(int(r.integers(1, 12)))]
                got = eng.submit_specs("g", batch)
                with mu:
                    futs.extend(got)

        threads = [threading.Thread(target=submit, args=(s,))
                   for s in rng.integers(0, 1000, 4).tolist()]
        for t in threads:
            t.start()
        eng.ingest("g", [tuple(e) for e in suffix.tolist()], wait=True,
                   timeout=TIMEOUT)
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        eng.drain(timeout=TIMEOUT)
        for f in futs:
            f.result(timeout=TIMEOUT)
    report = locks.WITNESS.report()
    assert report["problems"] == []
    assert report["acquisitions"] > 0
    edges = {(e["outer"], e["inner"]) for e in report["edges"]}
    assert ("batcher", "metrics") in edges
