"""The port's device query plane, run on the CPU, against the JAX
reference's jitted functions and against Algorithm 1.

The index reaches the port through the carry-across function
(``repro_torch.core.carry.from_reference``) from the reference's own
build, so the port serves exactly the reference's index. Masks are bool,
so equality is exact."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batch_query as jax_bq  # noqa: E402
from repro.core.pecb_index import \
    build_stratified_index as jax_build  # noqa: E402
from repro.core.temporal_graph import (gen_temporal_graph,  # noqa: E402
                                       random_queries)
from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core.carry import from_reference  # noqa: E402
from repro_torch.core.kcore import tccs_oracle_edges  # noqa: E402
from repro_torch.core.pecb_index import StratifiedPECB  # noqa: E402

GRAPHS = [dict(n=18, m=70, t_max=7, seed=3),
          dict(n=30, m=240, t_max=12, seed=5),
          dict(n=40, m=420, t_max=18, seed=31)]


def plain_fields(obj):
    """A dataclass's fields as a plain dict (nested dataclasses too)."""
    return {f.name: (plain_fields(v) if dataclasses.is_dataclass(
                v := getattr(obj, f.name)) else v)
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module", params=range(len(GRAPHS)),
                ids=["g18", "g30", "g40"])
def case(request):
    """(reference graph, reference index, port index, port CPU mirror,
    reference device mirror)."""
    g = gen_temporal_graph(**GRAPHS[request.param])
    jsx = jax_build(g)
    sx = from_reference(plain_fields(jsx))
    return g, jsx, sx, bq.to_device(sx, "cpu"), jax_bq.to_device(jsx)


def mixed_batch(g, sx, n_q, seed):
    rng = np.random.default_rng(seed)
    qs = random_queries(g, n_q, seed=seed)
    ks = [int(rng.choice(sx.supported_ks)) for _ in qs]
    slot = bq.mixed_slots(sx, [(u, k) for (u, _, _), k in zip(qs, ks)])
    ts = np.asarray([q[1] for q in qs], np.int32)
    te = np.asarray([q[2] for q in qs], np.int32)
    return qs, ks, slot, ts, te


def t(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def test_carry_across_gives_the_reference_index(case):
    _, jsx, sx, dix, _ = case
    assert isinstance(sx, StratifiedPECB) and sx.ks == jsx.ks
    assert sx.num_nodes == jsx.num_nodes
    meta, arrays = jax_bq._host_layout(jsx)
    carried = from_reference((meta, arrays), device="cpu")
    for f in bq._ARRAY_FIELDS + bq._META_FIELDS:
        a, b = getattr(carried, f), getattr(dix, f)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.int32 and np.array_equal(a.numpy(),
                                                             arrays[f]), f
    with pytest.raises(ValueError, match="needs a device"):
        from_reference((meta, arrays))


def test_batch_query_mixed_k_matches_reference_and_algorithm_1(case):
    g, jsx, sx, dix, jdix = case
    qs, ks, slot, ts, te = mixed_batch(g, sx, 32, 7)
    stats = {}
    got = bq.batch_query(dix, t(slot), t(ts), t(te), stats=stats).numpy()
    want = np.asarray(jax_bq.batch_query(jdix, jnp.asarray(slot),
                                         jnp.asarray(ts), jnp.asarray(te)))
    assert got.dtype == bool and np.array_equal(got, want)
    assert len(stats["rounds"]) == 1 and stats["rounds"][0] >= 1
    for i, ((u, a, b), k) in enumerate(zip(qs, ks)):
        alg1 = sx.slice_k(k)._component_vertices(u, a, b)
        assert set(np.flatnonzero(got[i]).tolist()) == alg1, (u, a, b, k)


def test_full_mixed_matches_reference_and_oracle_edges(case):
    g, jsx, sx, dix, jdix = case
    qs, ks, slot, ts, te = mixed_batch(g, sx, 16, 8)
    kq = np.asarray(ks, np.int32)
    vmask, vermask = bq.batch_query_full_mixed(dix, t(slot), t(ts), t(te),
                                               t(kq))
    jv, jver = jax_bq.batch_query_full_mixed(
        jdix, jnp.asarray(slot), jnp.asarray(ts), jnp.asarray(te),
        jnp.asarray(kq))
    assert np.array_equal(vmask.numpy(), np.asarray(jv))
    assert np.array_equal(vermask.numpy(), np.asarray(jver))
    eid = sx.strata.edge_id
    for i, ((u, a, b), k) in enumerate(zip(qs, ks)):
        got = set(eid[np.flatnonzero(vermask[i].numpy())].tolist())
        assert got == tccs_oracle_edges(g, k, u, a, b), (u, a, b, k)


def test_full_on_a_per_k_slice_matches_reference(case):
    g, jsx, sx, _, _ = case
    k = sx.ks[0]
    qs = random_queries(g, 12, seed=3)
    u, ts, te = (np.asarray(c, np.int32) for c in zip(*qs))
    vmask, vermask = bq.batch_query_full(bq.to_device(sx.slice_k(k), "cpu"),
                                         t(u), t(ts), t(te))
    jv, jver = jax_bq.batch_query_full(jax_bq.to_device(jsx.slice_k(k)),
                                       jnp.asarray(u), jnp.asarray(ts),
                                       jnp.asarray(te))
    assert np.array_equal(vmask.numpy(), np.asarray(jv))
    assert np.array_equal(vermask.numpy(), np.asarray(jver))


def test_window_sweep_and_stratum_device_match_reference(case):
    g, jsx, sx, dix, jdix = case
    windows = [(d, min(d + 3, g.t_max)) for d in range(1, g.t_max)]
    ts = np.asarray([w[0] for w in windows], np.int32)
    te = np.asarray([w[1] for w in windows], np.int32)
    u = 1
    for k in sx.supported_ks:
        slot = np.full(len(windows), sx.k_index(k) * g.n + u, np.int32)
        fused = bq.window_sweep(dix, t(slot), t(ts), t(te)).numpy()
        want = np.asarray(jax_bq.window_sweep(jdix, jnp.asarray(slot),
                                              jnp.asarray(ts),
                                              jnp.asarray(te)))
        assert np.array_equal(fused, want), k
        sd = bq.stratum_device(dix, sx, k)
        per_k = bq.to_device(sx.slice_k(k), "cpu")
        # the reference's eager carve is slow on the CPU: hold the last
        # (rebased) stratum against it, and every stratum against the
        # port's own per-k upload, itself the reference's layout
        # (test_torch_build)
        jsd = (jax_bq.stratum_device(jdix, jsx, k) if k == sx.ks[-1]
               else None)
        for f in bq._ARRAY_FIELDS:
            a = getattr(sd, f)
            assert torch.equal(a, getattr(per_k, f)), (k, f)
            if jsd is not None:
                assert np.array_equal(a.numpy(),
                                      np.asarray(getattr(jsd, f))), (k, f)
        assert sd.num_versions == per_k.num_versions
        sliced = bq.window_sweep(sd, u, t(ts), t(te)).numpy()
        assert np.array_equal(sliced, fused), k
        for i, (a, b) in enumerate(windows):
            assert set(np.flatnonzero(sliced[i]).tolist()) == \
                sx.slice_k(k)._component_vertices(u, a, b)
    with pytest.raises(KeyError):
        bq.stratum_device(dix, sx, 99)


def test_empty_forest_answers_empty():
    # a stratum above the graph's degeneracy has no forest nodes at all
    g = gen_temporal_graph(**GRAPHS[0])
    jsx = jax_build(g, ks=(12,))
    sx = from_reference(plain_fields(jsx))
    assert sx.num_nodes == 0
    dix = bq.to_device(sx, "cpu")
    u, ts, te = t([0, 3]), t([1, 2]), t([5, 7])
    got = bq.batch_query(dix, u, ts, te)
    assert got.shape == (2, g.n) and not got.any()
    want = np.asarray(jax_bq.batch_query(jax_bq.to_device(jsx),
                                         jnp.asarray(u.numpy()),
                                         jnp.asarray(ts.numpy()),
                                         jnp.asarray(te.numpy())))
    assert np.array_equal(got.numpy(), want)
    vmask, vermask = bq.batch_query_full_mixed(dix, u, ts, te, t([12, 12]))
    assert not vmask.any() and not vermask.any()
    assert not bq.window_sweep(dix, 0, ts, te).any()


def test_mixed_slots_overflow_and_unsupported_k():
    class FakeSx:
        n = 2**30
        ks = (2, 3, 4)

        def k_index(self, k):
            return self.ks.index(k)

    with pytest.raises(bq.LayoutOverflowError, match="mixed-k entry"):
        bq.mixed_slots(FakeSx(), [(5, 4)])    # 2*2^30 + 5 > int32 max
    assert issubclass(bq.LayoutOverflowError, OverflowError)
    with pytest.raises(bq.LayoutOverflowError, match="exceeds int32"):
        bq._i32(np.array([2**31], np.int64), "fused entry slots")
    g = gen_temporal_graph(**GRAPHS[0])
    sx = from_reference(plain_fields(jax_build(g, ks=(2, 4))))
    with pytest.raises(KeyError):
        bq.mixed_slots(sx, [(0, 3)])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    g = gen_temporal_graph(**GRAPHS[0])
    sx = from_reference(plain_fields(jax_build(g)))
    with pytest.raises((AssertionError, RuntimeError)):
        bq.to_device(sx)                 # device="cuda" with no card
