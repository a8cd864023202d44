"""The port's sharded query plane on the CPU: ``ShardedExecutor`` and
``ServingEngine(devices=[...])`` over several shards of torch's one CPU
device (a device may repeat in the list; each entry is a shard with its
own replica of the index), held to the JAX reference's unsharded
functions, to the port's one-shard answers and to Algorithm 1.

The inputs are those of the reference's
``tests/test_distributed.py::test_batched_tccs_queries_shardable`` and
``tests/test_serving.py::test_engine_multi_device_sharded``:
``gen_temporal_graph(n=40, m=250, t_max=15, seed=1)`` and queries from
``np.random.default_rng(0)``. The index reaches the port through the
carry-across function, so both packages serve one index. Masks are bool:
tolerance 0. Also: the reference's ``align``/``final_bucket`` formula for
1..8 shards and every bucket to 256, unaligned buckets and wrong replica
counts raising, the lockstep order of B1 launches (a shard at its
fixpoint gets no further launch), the replicas of a cold build, a
refresh, a trim and a promotion from the disk tier, each equal to
``to_device`` array for array, and ``stats()["devices"]``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batch_query as jax_bq  # noqa: E402
from repro.core.pecb_index import \
    build_stratified_index as jax_build  # noqa: E402
from repro.core.temporal_graph import \
    gen_temporal_graph as jax_gen  # noqa: E402
from repro.serving.executor import \
    ShardedExecutor as JaxExecutor  # noqa: E402
from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core.carry import from_reference  # noqa: E402
from repro_torch.core.query_api import ResultMode, TCCSQuery  # noqa: E402
from repro_torch.core.temporal_graph import gen_temporal_graph  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.serving import (EngineConfig, IndexRegistry,  # noqa: E402
                                 ServingEngine, executor)
from repro_torch.store import IndexStore  # noqa: E402

GRAPH = dict(n=40, m=250, t_max=15, seed=1)
SHARDS = (1, 2, 3, 4, 8)
B = 64
K = 2
TIMEOUT = 120
RUNS = ("run", "run_full", "run_full_mixed", "run_sweep")


def plain_fields(obj):
    """A dataclass's fields as a plain dict (nested dataclasses too)."""
    return {f.name: (plain_fields(v) if dataclasses.is_dataclass(
                v := getattr(obj, f.name)) else v)
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def case():
    """The graph, both packages' stratified indexes and mirrors (fused
    and the k = 2 slice), and the reference test's 64 queries."""
    g = jax_gen(**GRAPH)
    jsx = jax_build(g)
    sx = from_reference(plain_fields(jsx))
    rng = np.random.default_rng(0)
    u = rng.integers(0, g.n, B).astype(np.int32)
    ts = rng.integers(1, g.t_max + 1, B).astype(np.int32)
    te = np.minimum(ts + 5, g.t_max).astype(np.int32)
    ks = np.asarray([sx.supported_ks[i % len(sx.supported_ks)]
                     for i in range(B)], np.int32)
    return dict(g=g, jsx=jsx, sx=sx, u=u, ts=ts, te=te, ks=ks,
                slot=bq.mixed_slots(sx, list(zip(u.tolist(), ks.tolist()))),
                dix=bq.to_device(sx, "cpu"),
                kdix=bq.to_device(sx.slice_k(K), "cpu"),
                jdix=jax_bq.to_device(jsx),
                jkdix=jax_bq.to_device(jsx.slice_k(K)))


def sharded(d):
    return executor.ShardedExecutor(devices=["cpu"] * d)


def answers(case, ex, what, stats=None):
    """``what`` of the executor on the case's queries: vertex masks, and
    version masks where the run gives them."""
    bucket = ex.final_bucket(B, 8, 256)
    c = case
    if what == "run":
        reps = bq.replicas_of(c["kdix"], ex.devices)
        return (ex.run(reps, c["u"], c["ts"], c["te"], bucket,
                       stats=stats),)
    if what == "run_full":
        reps = bq.replicas_of(c["kdix"], ex.devices)
        return ex.run_full(reps, c["u"], c["ts"], c["te"], bucket,
                           stats=stats)
    if what == "run_full_mixed":
        reps = bq.replicas_of(c["dix"], ex.devices)
        return ex.run_full_mixed(reps, c["slot"], c["ts"], c["te"], c["ks"],
                                 bucket, stats=stats)
    reps = bq.replicas_of(c["kdix"], ex.devices)
    return (ex.run_sweep(reps, int(c["u"][0]), c["ts"], c["te"], bucket,
                         stats=stats),)


def reference(case, what):
    """The reference's unsharded batch functions on the same index."""
    c = case
    u, ts, te = (jnp.asarray(c[k]) for k in ("u", "ts", "te"))
    if what == "run":
        return (np.asarray(jax_bq.batch_query(c["jkdix"], u, ts, te)),)
    if what == "run_full":
        v, m = jax_bq.batch_query_full(c["jkdix"], u, ts, te)
        return np.asarray(v), np.asarray(m)[:, :c["jkdix"].num_versions]
    if what == "run_full_mixed":
        v, m = jax_bq.batch_query_full_mixed(
            c["jdix"], jnp.asarray(c["slot"]), ts, te, jnp.asarray(c["ks"]))
        return np.asarray(v), np.asarray(m)[:, :c["jdix"].num_versions]
    u0 = jnp.int32(int(c["u"][0]))
    return (np.asarray(jax_bq.window_sweep(c["jkdix"], u0, ts, te)),)


def algorithm_1(case, what, i):
    c = case
    u = int(c["u"][0]) if what == "run_sweep" else int(c["u"][i])
    k = int(c["ks"][i]) if what == "run_full_mixed" else K
    return c["sx"].slice_k(k)._component_vertices(u, int(c["ts"][i]),
                                                  int(c["te"][i]))


@pytest.mark.parametrize("what", RUNS)
@pytest.mark.parametrize("d", SHARDS)
def test_sharded_runs_equal_one_shard_reference_and_algorithm_1(case, d,
                                                                what):
    stats = {}
    got = answers(case, sharded(d), what, stats)
    one = answers(case, sharded(1), what)
    want = reference(case, what)
    for g, o, w in zip(got, one, want):
        assert g.dtype == bool and g.shape == w.shape
        assert np.array_equal(g, o) and np.array_equal(g, w)
    for i in range(B):
        assert set(np.flatnonzero(got[0][i]).tolist()) == \
            algorithm_1(case, what, i), i
    bucket = sharded(d).final_bucket(B, 8, 256)
    per = bucket // d
    (by_shard,) = stats["shard_rounds"]
    assert len(by_shard) == d
    # shards past the 64 queries hold pad lanes only and are not run
    assert [r > 0 for r in by_shard] == [i * per < B for i in range(d)]
    assert stats["rounds"] == [r for r in by_shard if r]


@pytest.mark.parametrize("d", range(1, 9))
def test_align_and_final_bucket_equal_the_reference(d):
    class Stub:
        num_devices = d
        align = JaxExecutor.align
        final_bucket = JaxExecutor.final_bucket

    ex = executor.ShardedExecutor(devices=["cpu"] * d)
    assert ex.num_devices == d and ex.device == torch.device("cpu")
    for bucket in range(1, 257):
        assert ex.align(bucket) == Stub().align(bucket), bucket
    for min_bucket, max_batch in ((8, 256), (1, 256), (16, 64), (3, 100)):
        for b in range(1, max_batch + 1):
            assert ex.final_bucket(b, min_bucket, max_batch) == \
                Stub().final_bucket(b, min_bucket, max_batch), b


@pytest.mark.parametrize("what", RUNS)
def test_unaligned_bucket_raises(case, what):
    ex = sharded(3)
    reps = bq.replicas_of(case["dix"], ex.devices)
    u, ts, te = case["u"], case["ts"], case["te"]
    with pytest.raises(ValueError, match="not device-aligned"):
        if what == "run":
            ex.run(reps, u, ts, te, 64)
        elif what == "run_full":
            ex.run_full(reps, u, ts, te, 64)
        elif what == "run_full_mixed":
            ex.run_full_mixed(reps, case["slot"], ts, te, case["ks"], 64)
        else:
            ex.run_sweep(reps, 0, ts, te, 64)


def test_replica_count_must_match_the_shards(case):
    ex = sharded(2)
    bucket = ex.final_bucket(B, 8, 256)
    with pytest.raises(ValueError, match="1 index replica"):
        ex.run(case["dix"], case["slot"], case["ts"], case["te"], bucket)
    with pytest.raises(ValueError, match="3 index replica"):
        ex.run(bq.replicas_of(case["dix"], ["cpu"] * 3), case["slot"],
               case["ts"], case["te"], bucket)
    # a lone DeviceIndex is the one replica of a one-shard executor
    one = executor.ShardedExecutor("cpu")
    assert one.num_devices == 1
    assert one.run(case["dix"], case["slot"][:8], case["ts"][:8],
                   case["te"][:8], 8).shape == (8, case["g"].n)


def test_shard_devices_defaults_and_spellings():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CPU-only default")
    cuda = torch.device("cuda")
    assert executor.shard_devices() == (cuda,)
    assert executor.shard_devices(device="cpu") == (torch.device("cpu"),)
    assert executor.shard_devices("cpu") == (torch.device("cpu"),)
    assert executor.shard_devices(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="not both"):
        executor.shard_devices(["cpu"], device="cpu")
    with pytest.raises(ValueError, match="no devices"):
        executor.shard_devices([])
    ex = executor.ShardedExecutor()
    assert (ex.devices, ex.device, ex.num_devices) == ((cuda,), cuda, 1)
    reg = IndexRegistry(devices=["cpu"] * 2)
    assert reg.devices == (torch.device("cpu"),) * 2
    assert reg.device == torch.device("cpu")
    with pytest.raises(ValueError, match="builds on cpu"):
        ServingEngine(registry=reg, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="builds on cpu"):
        ServingEngine(registry=reg)


def counting_round(calls):
    """B1's plain round, recording each launch's ``link_l`` operand (one
    per shard and batch) in ``calls``."""
    def round_(labels, link_l, link_r, link_p, active, *, changed):
        calls.append(link_l)
        out = ref.label_prop_round(labels, link_l, link_r, link_p, active)
        if bool((out != labels).any()):
            changed.fill_(1)
        return out
    return round_


@pytest.mark.parametrize("d", (2, 3, 4, 8))
def test_lockstep_launch_order_and_own_fixpoints(case, d, monkeypatch):
    """Round r is launched on every shard still changing, in shard order,
    before round r + 1 anywhere; each shard stops at its own fixpoint,
    with the rounds of its slice run alone."""
    calls = []
    monkeypatch.setattr(bq, "label_prop_round", counting_round(calls))
    ex = sharded(d)
    bucket = ex.final_bucket(B, 8, 256)
    per = bucket // d
    stats = {}
    ex.run(bq.replicas_of(case["dix"], ex.devices), case["slot"],
           case["ts"], case["te"], bucket, stats=stats)
    (rounds,) = stats["shard_rounds"]
    assert len(calls) == sum(rounds)
    order = []
    seen = {}
    for link in calls:
        order.append(seen.setdefault(link.data_ptr(), len(seen)))
    want = [i for r in range(1, max(rounds) + 1)
            for i, n in enumerate(rounds) if n >= r]
    assert order == want
    for i, n in enumerate(rounds):
        if i * per >= B:
            assert n == 0
            continue
        sl = slice(i * per, min((i + 1) * per, B))
        alone = {}
        u, ts, te = executor.pad_queries(case["slot"][sl], case["ts"][sl],
                                         case["te"][sl], per)
        bq.batch_query(case["dix"], torch.as_tensor(u), torch.as_tensor(ts),
                       torch.as_tensor(te), stats=alone)
        assert alone["rounds"] == [n], i


def test_replicate_and_replicas_of(case):
    dix = case["dix"]
    rep = bq.replicate(dix, "cpu")
    want = bq.to_device(case["sx"], "cpu")
    for f in bq._ARRAY_FIELDS:
        a = getattr(rep, f)
        assert torch.equal(a, getattr(want, f)), f
        assert a.data_ptr() != getattr(dix, f).data_ptr(), f
    for f in bq._META_FIELDS:
        assert getattr(rep, f) == getattr(dix, f), f
    reps = bq.replicas_of(dix, ["cpu"] * 3)
    assert reps[0] is dix and len(reps) == 3
    with pytest.raises(ValueError, match="first shard"):
        bq.replicas_of(dix, ["meta", "cpu"])


def assert_replicas(h, d):
    """Every replica of ``h`` equal to ``to_device`` of its index, array
    for array, on its own storage."""
    fresh = bq.to_device(h.pecb, "cpu")
    assert len(h.replicas) == d and h.replicas[0] is h.device
    for i, r in enumerate(h.replicas):
        assert r.device == torch.device("cpu")
        for f in bq._ARRAY_FIELDS + bq._META_FIELDS:
            a, b = getattr(r, f), getattr(fresh, f)
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), (i, f)
    ptrs = {r.node_u.data_ptr() for r in h.replicas}
    assert len(ptrs) == d


def engine_specs(g, ks, n_q, seed, modes=(ResultMode.VERTICES,)):
    """The reference test's query stream: ``n_q`` windows from
    ``default_rng(seed)`` (an empty window where ts > te), k and the
    result mode cycling through ``ks`` and ``modes``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_q):
        u, ts, te = (int(rng.integers(0, g.n)), int(rng.integers(1, g.t_max)),
                     int(rng.integers(1, g.t_max + 1)))
        if ts > te:
            ts, te = 1, 0
        out.append(TCCSQuery(u, ts, te, ks[i % len(ks)], modes[i % len(modes)]))
    return out


def serve(eng, specs):
    futs = eng.submit_specs("g", specs)
    eng.flush()
    return [f.result(timeout=TIMEOUT) for f in futs]


@pytest.mark.parametrize("d", SHARDS)
def test_engine_sharded_equals_one_shard_and_algorithm_1(d):
    """The port's counterpart of the reference's
    ``test_engine_multi_device_sharded`` (its config and 48 k = 2
    queries), at 1, 2, 3, 4 and 8 shards, plus a mixed-k stream in
    VERTICES and EDGES modes; every answer equal to the one-shard
    engine's and to Algorithm 1."""
    g = gen_temporal_graph(**GRAPH)
    cfg = EngineConfig(max_batch=64, flush_ms=500.0, host_threshold=0,
                       cache_capacity=0)
    runs = []
    for devices in (["cpu"] * d, ["cpu"]):
        with ServingEngine(cfg, devices=devices) as eng:
            assert eng.executor.num_devices == len(devices)
            assert eng.stats()["devices"] == len(devices)
            eng.register_graph("g", g)
            h = eng.warmup("g", full=True)
            assert_replicas(h, len(devices))
            ks = h.supported_ks
            specs = (engine_specs(g, [K], 48, 0)
                     + engine_specs(g, ks, 64, 1, (ResultMode.VERTICES,
                                                   ResultMode.EDGES)))
            res = serve(eng, specs)
            runs.append(res)
            c = eng.metrics.snapshot(include_sources=False)["counters"]
            assert c["device_batches"] == 2 and "host_batches" not in c
            if len(devices) > 1:
                per = [c.get(f"propagation_rounds_shard{i}", 0)
                       for i in range(len(devices))]
                assert sum(per) == c["propagation_rounds"] and min(per) > 0
    for (s, a, b) in zip(specs, *runs):
        assert a.vertices == b.vertices and a.num_vertices == b.num_vertices
        assert (a.edges is None) == (b.edges is None)
        if a.edges is not None:
            assert a.edges.edge_ids() == b.edges.edge_ids()
        assert a.provenance.route == b.provenance.route
        assert a.provenance.route == ("trivial" if s.ts > s.te
                                      else "device")
        alg1 = h.pecb.answer(s)
        assert a.vertices == alg1.vertices
        if s.mode == ResultMode.EDGES:
            assert a.edges.edge_ids() == alg1.edges.edge_ids()


@pytest.mark.parametrize("d", (2, 3))
def test_engine_sweep_over_shards(d):
    g = gen_temporal_graph(**GRAPH)
    cfg = EngineConfig(max_batch=64, flush_ms=5.0, host_threshold=0,
                       cache_capacity=0)
    windows = [(a, min(a + 4, g.t_max)) for a in range(1, g.t_max)]
    from repro_torch.core.query_api import WindowSweep
    out = []
    for devices in (["cpu"] * d, ["cpu"]):
        with ServingEngine(cfg, devices=devices) as eng:
            eng.register_graph("g", g)
            h = eng.warmup("g", sweep=True, sweep_ks=[K])
            assert len(h.stratum_replicas(K)) == len(devices)
            assert h.stratum_replicas(K)[0] is h.stratum_device(K)
            res = eng.sweep("g", WindowSweep(u=3, k=K, windows=windows))
            assert all(r.provenance.route == "sweep" for r in res)
            out.append([r.vertices for r in res])
    assert out[0] == out[1]
    for (a, b), v in zip(windows, out[0]):
        assert v == h.pecb.slice_k(K)._component_vertices(3, a, b)


@pytest.mark.parametrize("step", ("refresh", "trim"))
def test_refresh_and_trim_replace_every_replica(step):
    """A refresh (a day ingested) or a trim under three shards: the new
    handle's every replica equals ``to_device`` of its index, its answers
    equal Algorithm 1, and ``stats()["devices"] == 3``."""
    g = gen_temporal_graph(**GRAPH)
    t_old = g.t_max - 2
    g0, suffix = g.split_at(t_old)
    cfg = EngineConfig(max_batch=64, flush_ms=5.0, host_threshold=0,
                       cache_capacity=0)
    with ServingEngine(cfg, devices=["cpu"] * 3) as eng:
        eng.register_graph("g", g0)
        h0 = eng.warmup("g")
        assert_replicas(h0, 3)
        if step == "refresh":
            edges = [tuple(e) for e in suffix.tolist()]
            h1 = eng.ingest("g", edges, wait=True)["g"].result()
            assert h1.epoch == 1 and h1.graph.t_max == g.t_max
        else:
            h1 = eng.retain("g", 4, wait=True, timeout=TIMEOUT)["g"].result()
            assert h1.epoch == 1 and h1.graph.m < g0.m
        assert eng.registry.get_nowait("g") is h1
        assert_replicas(h1, 3)
        st = eng.stats()
        assert st["devices"] == 3 and st["registry"]["devices"] == 3
        assert st["registry"]["resident_device_bytes"] == \
            3 * h1.device.nbytes()
        c = st["engine"]["counters"]
        if step == "refresh":
            # the fused layout shifts behind the first changed stratum: the
            # first replica's refresh uploads the whole mirror, so the
            # others are copied from it
            assert c["refresh_upload_bytes"] == h1.device.nbytes()
            assert c["refresh_replicated_bytes"] == 2 * h1.device.nbytes()
        else:
            assert c.get("retention_freed_bytes", 0) % 3 == 0
        specs = engine_specs(h1.graph, h1.supported_ks, 40, 2)
        for s, r in zip(specs, serve(eng, specs)):
            assert r.vertices == h1.pecb.answer(s).vertices
            assert r.provenance.index_key == "g"


@pytest.mark.parametrize("new", ("same", "suffix", "trim"))
def test_refresh_replicas_moves_the_fewer_bytes(new):
    """Each further replica takes the first one's refresh while that
    uploads less than the whole mirror (an unchanged epoch: nothing, every
    replica keeps its own tensors), else a copy of the new first replica
    (a suffix day or a trim, whose fused layouts shift). Either way every
    replica equals ``to_device`` of the new index."""
    from repro_torch.core.pecb_index import build_stratified_index
    g = gen_temporal_graph(**GRAPH)
    sx0 = build_stratified_index(g.split_at(g.t_max - 2)[0], device="cpu")
    sx1 = {"same": sx0,
           "suffix": build_stratified_index(g, device="cpu"),
           "trim": build_stratified_index(g.expire_before(5), sx0.ks,
                                          device="cpu")}[new]
    prev = bq.replicas_of(bq.to_device(sx0, "cpu"), ["cpu"] * 3)
    reps, st = bq.refresh_replicas(sx0, prev, sx1)
    _, st1 = bq.refresh_device(sx0, prev[0], sx1)
    copied = st1["uploaded_bytes"] >= reps[0].nbytes()
    assert copied == (new != "same")
    assert st["replicated_bytes"] == (2 * reps[0].nbytes() if copied else 0)
    assert st["uploaded_bytes"] == (1 if copied else 3) * \
        st1["uploaded_bytes"]
    assert st["freed_bytes"] == 3 * st1["freed_bytes"]
    fresh = bq.to_device(sx1, "cpu")
    for r, p in zip(reps, prev):
        for f in bq._ARRAY_FIELDS:
            assert torch.equal(getattr(r, f), getattr(fresh, f)), f
            # an unchanged array is handed over, each replica its own
            assert (getattr(r, f) is getattr(p, f)) == (not copied), f


def test_promotion_from_the_store_replicates(tmp_path):
    g = gen_temporal_graph(**GRAPH)
    reg = IndexRegistry(store=IndexStore(str(tmp_path)), devices=["cpu"] * 2)
    reg.register_graph("g", g)
    h = reg.get("g", timeout=TIMEOUT)
    assert h.source == "build"
    assert_replicas(h, 2)
    reg.close()
    reg2 = IndexRegistry(store=IndexStore(str(tmp_path)),
                         devices=["cpu"] * 4)
    reg2.register_graph("g", g)
    h2 = reg2.get("g", timeout=TIMEOUT)
    assert h2.source == "disk" and reg2.stats()["promotions"] == 1
    assert_replicas(h2, 4)
    reg2.close()
