"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips on a machine
without an NVIDIA card (a CUDA kernel has no CPU mode). The file imports
neither JAX nor the reference package, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer and boolean outputs must match exactly. B5's f32 outputs sum the
same exact products in another order (rtol 1e-4, atol 1e-6 * K); B4's
add the same f32 rows in another order (rtol = atol = 1e-4,
tests/test_kernels.py's segment-sum tolerance), an order fixed by the ids
and the schedule: equal bit for bit from call to call and to the plain
mirror of its decomposition, ``ref.segment_sum_tiled``; B6's
bf16 outputs are held to ``flash_attention.error_bound``, as in
chip_smoke.py: 2e-2 of |plain| for the outputs' bf16 roundings plus 1e-2
of the largest |plain| in the element's row for the kernel's bf16 P."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core import core_time, kcore  # noqa: E402
from repro_torch.core.pecb_index import build_stratified_index  # noqa: E402
from repro_torch.core.temporal_graph import (TemporalGraph,  # noqa: E402
                                             bench_graph, gen_temporal_graph,
                                             random_queries)
from repro_torch.kernels import (flash_attention, kcore_peel,  # noqa: E402
                                 label_prop, ops, ref, segment_matmul,
                                 segmented_select)
from repro_torch.data import graph_sampler as gs  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import (EngineConfig, ServingEngine,  # noqa: E402
                                 TCCSQuery)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,N", [(1, 1), (2, 30), (8, 300), (256, 70_001)])
def test_label_prop_kernel_matches_plain_version(cuda, B, N):
    rng = np.random.default_rng(N)
    labels = torch.as_tensor(rng.integers(0, N + 1, (B, N), dtype=np.int32),
                             device=cuda)
    links = [torch.as_tensor(rng.integers(-1, N, (B, N), dtype=np.int32),
                             device=cuda) for _ in range(3)]
    active = torch.as_tensor(rng.random((B, N)) < 0.7, device=cuda)
    before = label_prop.label_prop_round.launches
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = label_prop.label_prop_round(labels, *links, active, changed=flag)
    torch.cuda.synchronize()
    assert label_prop.label_prop_round.launches == before + 1
    want = ref.label_prop_round(labels, *links, active)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(flag) == int(bool((want != labels).any()))


@pytest.mark.parametrize("E,n", [(0, 5), (1, 1), (5, 0), (257, 33),
                                 (34_948, 1_899)])
@pytest.mark.parametrize("kind", ["csr", "unsorted_pads"])
def test_segmented_count_kernel_matches_plain_version(cuda, E, n, kind):
    rng = np.random.default_rng(E + n)
    seg = rng.integers(0, max(n, 1), E)
    if kind == "csr":
        seg = np.sort(seg)
    else:
        seg[rng.random(E) < 0.1] = -1
        seg[rng.random(E) < 0.05] = n + 3
    w, seg, thr = (torch.as_tensor(a.astype(np.int32), device=cuda) for a in
                   (rng.integers(0, 195, E), seg, rng.integers(0, 195, n)))
    before = segmented_select.segmented_count_le.launches
    got = segmented_select.segmented_count_le(w, seg, thr, n)
    torch.cuda.synchronize()
    assert segmented_select.segmented_count_le.launches == \
        before + (E > 0 and n > 0)
    want = ref.segmented_count_le(w, seg, thr, n)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("m,n", [(0, 5), (1, 2), (7, 0), (301, 40),
                                 (17_474, 1_899), (59_835, 1_899)])
@pytest.mark.parametrize("weights", ["bool", "int"])
def test_peel_kernels_match_plain_versions(cuda, m, n, weights):
    rng = np.random.default_rng(m + n)
    src, dst = (torch.as_tensor(rng.integers(0, max(n, 1), m).astype(np.int32),
                                device=cuda) for _ in range(2))
    alive = rng.random(m) < 0.7
    if weights == "int":
        alive = (alive * rng.integers(1, 4, m)).astype(np.int32)
    alive = torch.as_tensor(alive, device=cuda)
    launched = (m > 0 and n > 0)
    before = (kcore_peel.degree_count.launches,
              kcore_peel.peel_threshold.launches)
    deg = kcore_peel.degree_count(src, dst, alive, n)
    assert torch.equal(deg, ref.degree_count(src, dst, alive, n))
    for k in (1, 2, 3, 8):
        flag = torch.zeros(1, dtype=torch.int32, device=cuda)
        got = kcore_peel.peel_threshold(src, dst, alive, deg, k, changed=flag)
        want = ref.peel_threshold(src, dst, alive, deg, k)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and torch.equal(got, want)
        assert int(flag) == int(bool((want != (alive > 0)).any()))
    assert (kcore_peel.degree_count.launches,
            kcore_peel.peel_threshold.launches) == \
        (before[0] + launched, before[1] + 4 * launched)


def test_kcore_fixpoint_on_card_equals_host_peeling(cuda):
    g = gen_temporal_graph(n=300, m=4000, t_max=160, seed=17)
    key = np.minimum(g.src, g.dst).astype(np.int64) * g.n + np.maximum(
        g.src, g.dst)
    uniq, inv = np.unique(key, return_inverse=True)
    us, ud = (torch.as_tensor(a.astype(np.int32), device=cuda)
              for a in (uniq // g.n, uniq % g.n))
    for k in (2, 5, kcore.k_max(g), kcore.k_max(g) + 1):
        got = ops.kcore_fixpoint(us, ud, g.n, k).cpu().numpy()[inv]
        assert np.array_equal(got, kcore.distinct_kcore_edge_mask(
            g.src, g.dst, g.n, k)), k


def fixpoint_on_card(src, dst, n, k, alive0):
    """The fixpoint kernel against the plain version on the same card
    tensors: bit-equal masks and equal round counts. The kernel's call
    runs under ``set_sync_debug_mode("error")`` (no host synchronisation)
    and is one launch, no B3a or B3b launch. Returns (mask, rounds)."""
    counts = (lambda: (kcore_peel.kcore_fixpoint.launches,
                       kcore_peel.degree_count.launches,
                       kcore_peel.peel_threshold.launches))
    rounds = torch.zeros(1, dtype=torch.int32, device=src.device)
    before = counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kcore_peel.kcore_fixpoint(src, dst, n, k, alive0, rounds=rounds)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1], before[2])
    want_rounds = torch.zeros(1, dtype=torch.int32, device=src.device)
    want = ref.kcore_fixpoint(src, dst, n, k, alive0, rounds=want_rounds)
    assert got.dtype == torch.bool and torch.equal(got, want), k
    assert int(rounds) == int(want_rounds), k
    return got, int(rounds)


def fixpoint_case(name):
    """(src, dst, n, alive0, ks) of an edge case of the fixpoint."""
    rng = np.random.default_rng(len(name))
    src = rng.integers(0, 12, 60).astype(np.int32)
    dst = rng.integers(0, 12, 60).astype(np.int32)
    n, alive0, ks = 12, None, (1, 2, 3, 4, 6)
    if name == "self_loops":
        src[::3] = dst[::3]
    elif name == "out_of_range":
        src[::5], dst[1::7], src[2::9] = -1, n, n + 5
    elif name == "parallel":
        src, dst = np.repeat(src[:15], 4), np.repeat(dst[:15], 4)
    elif name == "m0":
        src, dst = src[:0], dst[:0]
    elif name == "n0":
        n = 0
    elif name == "all_false":
        alive0 = np.zeros(60, bool)
    elif name == "bool_alive0":
        alive0 = rng.random(60) < 0.7
    elif name == "int32_weights":
        alive0 = rng.integers(-2, 4, 60).astype(np.int32)
    elif name == "int32_kept_weights":   # kept weight-2 edges fall to 1
        src, dst = np.array([0, 3, 2, 0, 2]), np.array([0, 3, 3, 0, 1])
        src, dst, n, ks = src.astype(np.int32), dst.astype(np.int32), 4, (3,)
        alive0 = np.array([-1, 1, 2, 2, 1], np.int32)
    elif name == "two_chains":       # round 2's death read in round 4
        src = np.array([1, 2, 3, 0, 0, 4, 0, 6, 7], np.int32)
        dst = np.array([2, 3, 1, 1, 4, 5, 6, 7, 8], np.int32)
        n, ks = 9, (2,)
    elif name == "k_nonpositive":
        ks = (0, -3, -2**40)
    elif name == "k_above_every_degree":
        ks = (121, 2**40)
    return src, dst, n, alive0, ks


@pytest.mark.parametrize("name", [
    "self_loops", "out_of_range", "parallel", "m0", "n0", "all_false",
    "bool_alive0", "int32_weights", "int32_kept_weights", "two_chains",
    "k_nonpositive", "k_above_every_degree"])
def test_fixpoint_kernel_edge_cases(cuda, name):
    src, dst, n, alive0, ks = fixpoint_case(name)
    src, dst = (torch.as_tensor(a, device=cuda) for a in (src, dst))
    if alive0 is not None:
        alive0 = torch.as_tensor(alive0, device=cuda)
    for k in ks:
        got, rounds = fixpoint_on_card(src, dst, n, k, alive0)
        if name in ("m0", "all_false", "k_nonpositive"):
            assert rounds == 1
        if name in ("n0", "all_false", "k_above_every_degree"):
            assert not bool(got.any())
        if name == "two_chains":
            assert rounds == 5 and got.tolist() == [True] * 3 + [False] * 6


def test_fixpoint_kernel_on_a_hub(cuda):
    """A hub with 1,809 pairs (CollegeMsg's largest degree) and a path
    over its leaves: the hub's atomics merge across a warp; at k = 3 the
    path peels two leaves a round from its ends (906 rounds), at k = 4
    every leaf dies in round 1."""
    leaves = np.arange(1, 1_810, dtype=np.int32)
    src = np.concatenate([np.zeros(1_809, np.int32), leaves[:-1]])
    dst = np.concatenate([leaves, leaves[1:]])
    src, dst = (torch.as_tensor(a, device=cuda) for a in (src, dst))
    for k in (1, 2, 3, 4, 1_809, 1_810):
        got, rounds = fixpoint_on_card(src, dst, 1_810, k, None)
        assert bool(got.all()) == (k <= 2) and bool(got.any()) == (k <= 2)
        assert rounds == {1: 1, 2: 1, 3: 906}.get(k, 2)


def distinct_pairs(g, device):
    us, ud, inv = kcore.distinct_pairs(g.src, g.dst, g.n)
    return [torch.as_tensor(a, dtype=torch.int32, device=device)
            for a in (us, ud)] + [inv]


def test_fixpoint_kernel_on_collegemsg_pairs_every_k(cuda):
    """CollegeMsg's scale (1,899 users, 59,835 messages): its 17,474
    distinct pairs, every k from 2 to k_max + 1; k_max's core equals the
    host's."""
    g = gen_temporal_graph(n=1_899, m=59_835, t_max=193, seed=7)
    us, ud, inv = distinct_pairs(g, cuda)
    assert us.shape[0] == 17_474
    k_max = kcore.k_max(g)
    for k in range(2, k_max + 2):
        got, _ = fixpoint_on_card(us, ud, g.n, k, None)
    assert not bool(got.any())
    got, _ = fixpoint_on_card(us, ud, g.n, k_max, None)
    assert np.array_equal(got.cpu().numpy()[inv],
                          kcore.distinct_kcore_edge_mask(g.src, g.dst, g.n,
                                                         k_max))


def test_fixpoint_kernel_at_sx_superuser_scale(cuda):
    """SNAP sx-superuser's scale (194,085 users, 1,443,339 interactions):
    461,605 distinct pairs over more blocks than the card holds at once;
    k in {2, k_max / 4, k_max / 2, k_max, k_max + 1}, each equal to the
    plain version and the host's k-core."""
    g = gen_temporal_graph(n=194_085, m=1_443_339, t_max=2_000, seed=7)
    us, ud, inv = distinct_pairs(g, cuda)
    assert us.shape[0] == 461_605
    k_max = kcore.k_max(g)
    for k in (2, k_max // 4, k_max // 2, k_max, k_max + 1):
        got, _ = fixpoint_on_card(us, ud, g.n, k, None)
        assert np.array_equal(got.cpu().numpy()[inv],
                              kcore.distinct_kcore_edge_mask(
                                  g.src, g.dst, g.n, k)), k
    assert 1 <= kcore_peel.grid_blocks(us.shape[0], g.n) <= \
        2 * torch.cuda.get_device_properties(0).multi_processor_count


def test_fixpoint_kernel_refuses_arguments_it_does_not_take(cuda):
    """The C entry refuses a missing scratch, an alive0 without its width
    and a weight of 2 bytes (cudaErrorInvalidValue) without running: the
    mask and the round count stay as they were."""
    src = torch.arange(8, dtype=torch.int32, device=cuda)
    dst = src.roll(1)
    out = torch.full((8,), True, device=cuda)
    rounds = torch.full((1,), -7, dtype=torch.int32, device=cuda)
    scratch = torch.zeros(2 * 8 + 1, dtype=torch.int32, device=cuda)
    w16 = torch.ones(8, dtype=torch.int16, device=cuda)
    lib = kcore_peel._fixpoint_library()[0]
    stream = torch.cuda.current_stream().cuda_stream
    for alive0, width, scr in ((None, 0, None), (None, 1, scratch),
                               (w16.data_ptr(), 2, scratch)):
        rc = lib.kcore_fixpoint_launch(
            src.data_ptr(), dst.data_ptr(), alive0, width, out.data_ptr(),
            rounds.data_ptr(), None if scr is None else scr.data_ptr(), 8, 8,
            3, stream)
        torch.cuda.synchronize()
        assert rc == 1 and int(rounds) == -7 and bool(out.all())
    fixpoint_on_card(src, dst, 8, 3, None)


def test_device_engine_strata_on_card_equal_host_engine(cuda):
    """The card build makes one stratum_sweep launch per t_uv block and no
    B2 launch, and its strata equal the host's on every field."""
    g = gen_temporal_graph(n=40, m=420, t_max=18, seed=31)
    before = segmented_select.segmented_count_le.launches
    sweeps = segmented_select.stratum_sweep.launches
    stats = {}
    dev = core_time.stratified_core_times(g, device=cuda, stats=stats)
    assert segmented_select.segmented_count_le.launches == before
    assert segmented_select.stratum_sweep.launches - sweeps == \
        -(-g.t_max // core_time.TUV_BLOCK)
    assert stats["iterations"] - stats["climbs"] == g.t_max * len(dev.ks)
    host = core_time.stratified_core_times(g, device="cpu")
    assert dev.ks == host.ks
    for f in ("kptr", "edge_id", "ts_from", "ts_to", "ct", "vptr",
              "v_ts_from", "v_ts_to", "v_ct"):
        assert np.array_equal(getattr(dev, f), getattr(host, f)), f


@pytest.mark.parametrize("frac", [0.3, 0.9])
def test_extend_on_card_equals_host_engine(cuda, frac):
    """``extend_stratified_core_times(engine="device")`` sweeps every
    stratum, the old ones and those the appended edges add, in one
    stratum_sweep launch per t_uv block, and equals the host engine (the
    frontier fixpoint) and a cold build on every field and dtype."""
    from repro_torch.core import streaming
    g = gen_temporal_graph(n=40, m=420, t_max=18, seed=31)
    g0, suffix = g.split_at(max(1, int(g.t_max * frac)))
    dense = [(u, v, g.t_max + 1) for u in range(9) for v in range(u + 1, 9)]
    g1 = g0.extend([tuple(e) for e in suffix.tolist()] + dense)
    prev = core_time.stratified_core_times(g0, device="cpu")
    ks = core_time.default_ks(g1)
    assert set(ks) - set(prev.ks)
    sweeps = segmented_select.stratum_sweep.launches
    got = core_time.extend_stratified_core_times(g1, prev, ks,
                                                 engine="device",
                                                 device=cuda)
    torch.cuda.synchronize()
    assert segmented_select.stratum_sweep.launches - sweeps == \
        -(-g1.t_max // core_time.TUV_BLOCK)
    host = core_time.extend_stratified_core_times(g1, prev, ks,
                                                  engine="host",
                                                  device="cpu")
    cold = core_time.stratified_core_times(g1, device="cpu")
    for want in (host, cold):
        assert got.ks == want.ks
        for f in ("kptr", "edge_id", "ts_from", "ts_to", "ct", "vptr",
                  "v_ts_from", "v_ts_to", "v_ct"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for k in prev.ks:
        assert np.array_equal(
            core_time.extend_core_times(g1, k, prev.table_for(k),
                                        device=cuda).vertex_ct,
            cold.table_for(k).vertex_ct)
    sx1 = streaming.extend_stratified_index(
        g1, build_stratified_index(g0, strata=prev), ks, strata=got)
    want_sx = build_stratified_index(g1, strata=cold)
    for f in ("node_u", "node_ct", "row_ptr", "ent_ts", "ent_left",
              "ent_parent", "vrow_ptr", "vent_node", "knode_ptr"):
        assert np.array_equal(getattr(sx1, f), getattr(want_sx, f)), f


def test_refresh_device_on_card(cuda):
    """``refresh_device`` on CUDA tensors: a no-op epoch hands over every
    resident tensor (same data_ptr), a per-k suffix epoch grows ver_k by
    a suffix upload on the card and uploads the rest in full; the result
    equals a fresh upload, lives on the old mirror's device, and the old
    mirror is never mutated."""
    from repro_torch.core import streaming
    from repro_torch.core.pecb_index import build_pecb_index
    g = gen_temporal_graph(n=40, m=420, t_max=18, seed=31)
    g0, suffix = g.split_at(11)
    tab0 = core_time.edge_core_times(g0, 2, device=cuda)
    idx0 = build_pecb_index(g0, 2, tab0)
    dix0 = bq.to_device(idx0, cuda)
    same, stats = bq.refresh_device(idx0, dix0, idx0)
    assert stats["reused"] == len(bq._ARRAY_FIELDS)
    assert stats["uploaded_bytes"] == 0
    for f in bq._ARRAY_FIELDS:
        assert getattr(same, f).data_ptr() == getattr(dix0, f).data_ptr()
    before = {f: getattr(dix0, f).clone() for f in bq._ARRAY_FIELDS}
    g1 = g0.extend([tuple(e) for e in suffix.tolist()])
    tab1 = core_time.extend_core_times(g1, 2, tab0, device=cuda)
    idx1 = streaming.extend_pecb_index(g1, 2, tab1, idx0)
    dix1, stats = bq.refresh_device(idx0, dix0, idx1)
    torch.cuda.synchronize()
    assert stats["suffix"] >= 1 and stats["full"] >= 1
    assert stats["reused"] + stats["suffix"] + stats["full"] == \
        len(bq._ARRAY_FIELDS)
    fresh = bq.to_device(idx1, cuda)
    for f in bq._ARRAY_FIELDS:
        a = getattr(dix1, f)
        assert a.device == dix0.device and a.dtype == torch.int32, f
        assert torch.equal(a, getattr(fresh, f)), f
        assert torch.equal(getattr(dix0, f), before[f]), f
    for f in bq._META_FIELDS:
        assert getattr(dix1, f) == getattr(fresh, f), f
    grown = [f for f in bq._ARRAY_FIELDS
             if getattr(dix1, f).shape[0] > getattr(dix0, f).shape[0]
             and torch.equal(getattr(dix1, f)[:getattr(dix0, f).shape[0]],
                             getattr(dix0, f))]
    assert "ver_k" in grown


def sweep_operands(g, dev, ts0=1, ts1=None):
    """(tuv, seg, vptr, dst) of g's pair CSR on ``dev``, tuv the t_uv rows
    of start times [ts0, ts1) (default: to t_max)."""
    csr = core_time._pair_csr(g)
    ts1 = g.t_max + 1 if ts1 is None else ts1
    tuv = np.ascontiguousarray(core_time._tuv_rows(csr, ts0, ts1, g.t_max))
    return [torch.as_tensor(a, device=dev) for a in
            (tuv, csr.src, csr.vptr.astype(np.int32), csr.dst)]


def hub_graph(seed=11):
    """Vertex 0 with 1,100 distinct neighbours (a segment of more than
    1,024 slots) around a denser random core."""
    rng = np.random.default_rng(seed)
    n = 1_101
    edges = [(0, v, int(rng.integers(1, 41))) for v in range(1, n)]
    a, b = rng.integers(1, 60, (2, 900))
    edges += [(int(u), int(v), int(t)) for u, v, t in
              zip(a, b, rng.integers(1, 41, 900))]
    return TemporalGraph.from_edges(n, edges)


def sweep_both(ops_, ks, n, inf, carry=None):
    """The kernel and its plain version on the same card operands:
    ((rows, carry, stats) of the kernel, the same of the plain version),
    after checking the launch and its route."""
    dev = ops_[0].device
    ks = torch.as_tensor(np.asarray(ks, np.int32), device=dev)
    carry = (torch.zeros((ks.shape[0], n), dtype=torch.int32, device=dev)
             if carry is None else carry)
    route = segmented_select.sweep_route(n)
    before = (segmented_select.stratum_sweep.launches,
              segmented_select.stratum_sweep.routes[route])
    c_kern = carry.clone()
    rows, stats = segmented_select.stratum_sweep(*ops_, ks, c_kern, inf)
    torch.cuda.synchronize()
    assert (segmented_select.stratum_sweep.launches,
            segmented_select.stratum_sweep.routes[route]) == \
        (before[0] + 1, before[1] + 1)
    c_plain = carry.clone()
    rows_p = torch.empty_like(rows)
    stats_p = ref.stratum_sweep(*ops_, ks, c_plain, inf, rows_p)
    return (rows, c_kern, stats), (rows_p, c_plain, stats_p)


def assert_sweeps_equal(kern, plain):
    for name, a, b in zip(("rows", "carry", "stats"), kern, plain):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("case", ["cm_like", "hub", "above_k_max",
                                  "forced_global"])
def test_stratum_sweep_kernel_matches_plain_version(cuda, case, monkeypatch):
    """Rows, carry and probe/climb counts exactly equal to the plain
    version's on the card: every stratum of a CollegeMsg-like graph (also
    with c forced into the global scratch), a hub of 1,100 slots, and a
    single k above k_max (every vertex climbs to inf)."""
    g = hub_graph() if case == "hub" else gen_temporal_graph(
        n=600, m=9000, t_max=190, seed=2)
    ks = core_time.default_ks(g)
    if case == "above_k_max":
        ks = (ks[-1] + 1,)
    if case == "forced_global":
        monkeypatch.setattr(segmented_select, "sweep_route",
                            lambda n: "global")
    kern, plain = sweep_both(sweep_operands(g, cuda), ks, g.n, g.t_max + 1)
    assert_sweeps_equal(kern, plain)
    if case == "above_k_max":
        assert bool((kern[0] == g.t_max + 1).all())


@pytest.mark.parametrize("n,route", [(20_000, "shared"), (30_000, "global")])
def test_stratum_sweep_kernel_routes_by_size(cuda, n, route):
    """n = 20,000: c's two int32 buffers (160,000 bytes) fit a block's
    shared memory only past the 48 KB default (the launch opts in); n =
    30,000: they (240,000 bytes) do not fit its 232,448 bytes, so c lives
    in device memory."""
    g = gen_temporal_graph(n=n, m=3 * n, t_max=40, seed=4)
    assert segmented_select.sweep_route(g.n) == route
    ks = core_time.default_ks(g)
    kern, plain = sweep_both(sweep_operands(g, cuda), (ks[0], ks[-1]), g.n,
                             g.t_max + 1)
    assert_sweeps_equal(kern, plain)


def test_stratum_sweep_kernel_carries_across_blocks(cuda):
    """t_max = 318 > TUV_BLOCK: two launches carrying c equal the plain
    version over all 318 start times at once, and the card build equals
    the host's."""
    g = gen_temporal_graph(n=30, m=800, t_max=400, seed=9)
    assert g.t_max > core_time.TUV_BLOCK
    ks = core_time.default_ks(g)
    inf, cut = g.t_max + 1, 1 + core_time.TUV_BLOCK
    kt = torch.as_tensor(np.asarray(ks, np.int32), device=cuda)
    carry = torch.zeros((len(ks), g.n), dtype=torch.int32, device=cuda)
    rows = torch.empty((len(ks), g.t_max, g.n), dtype=torch.int32,
                       device=cuda)
    stats = 0
    for lo, hi in ((1, cut), (cut, g.t_max + 1)):
        stats = stats + segmented_select.stratum_sweep(
            *sweep_operands(g, cuda, lo, hi), kt, carry, inf,
            out=rows[:, lo - 1:hi - 1])[1]
    torch.cuda.synchronize()
    c_plain = torch.zeros_like(carry)
    rows_p = torch.empty_like(rows)
    stats_p = ref.stratum_sweep(*sweep_operands(g, cuda), kt, c_plain, inf,
                                rows_p)
    assert_sweeps_equal((rows, carry, stats), (rows_p, c_plain, stats_p))
    dev = core_time.stratified_core_times(g, device=cuda)
    host = core_time.stratified_core_times(g, device="cpu")
    for f in ("kptr", "edge_id", "ts_from", "ts_to", "ct", "vptr",
              "v_ts_from", "v_ts_to", "v_ct"):
        assert np.array_equal(getattr(dev, f), getattr(host, f)), f


def test_stratum_sweep_kernel_on_an_empty_graph(cuda):
    """No slot: every vertex climbs to inf once, then each start time
    probes once; kernel and plain version agree."""
    z = torch.zeros(0, dtype=torch.int32, device=cuda)
    ops_ = [torch.zeros((5, 0), dtype=torch.int32, device=cuda), z,
            torch.zeros(8, dtype=torch.int32, device=cuda), z]
    kern, plain = sweep_both(ops_, (2, 3), 7, 6)
    assert_sweeps_equal(kern, plain)
    assert bool((kern[0] == 6).all()) and kern[2].tolist() == [[6, 1]] * 2


def test_batch_query_on_card_equals_cpu_and_algorithm_1(cuda):
    g = gen_temporal_graph(n=40, m=420, t_max=18, seed=31)
    sx = build_stratified_index(g)
    rng = np.random.default_rng(5)
    qs = random_queries(g, 48, seed=5)
    ks = [int(rng.choice(sx.ks)) for _ in qs]
    slot = bq.mixed_slots(sx, [(u, k) for (u, _, _), k in zip(qs, ks)])
    ts = np.asarray([q[1] for q in qs], np.int32)
    te = np.asarray([q[2] for q in qs], np.int32)
    masks = {}
    for dev in ("cpu", cuda):
        dix = bq.to_device(sx, dev)
        args = [torch.as_tensor(a, device=dev) for a in (slot, ts, te)]
        before = label_prop.label_prop_round.launches
        stats = {}
        masks[str(dev)] = bq.batch_query(dix, *args, stats=stats).cpu()
        launched = label_prop.label_prop_round.launches - before
        assert launched == (stats["rounds"][0] if dev == cuda else 0)
    assert torch.equal(masks["cpu"], masks["cuda"])
    for i, ((u, a, b), k) in enumerate(zip(qs, ks)):
        assert set(np.flatnonzero(masks["cuda"][i].numpy()).tolist()) == \
            sx.slice_k(k)._component_vertices(u, a, b)


def test_label_prop_launches_counted_exactly_from_threads(cuda):
    """Four host threads launching B1 at once: the count is exact (the
    serving engine's batcher, build and refresh threads all launch)."""
    rng = np.random.default_rng(3)
    ops_ = [torch.as_tensor(rng.integers(-1, 500, (8, 500), dtype=np.int32),
                            device=cuda) for _ in range(4)]
    active = torch.ones((8, 500), dtype=torch.bool, device=cuda)
    before = label_prop.label_prop_round.launches

    def launch():
        flag = torch.zeros(1, dtype=torch.int32, device=cuda)
        for _ in range(200):
            label_prop.label_prop_round(*ops_, active, changed=flag)

    threads = [threading.Thread(target=launch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert label_prop.label_prop_round.launches == before + 800


def test_serving_engine_on_card_equals_algorithm_1(cuda):
    """The engine with its default device: the registry's build sweeps
    on the card, device batches run B1, an ingest refreshes on the card;
    every answer equals Algorithm 1 on its epoch's graph."""
    g = gen_temporal_graph(n=40, m=420, t_max=18, seed=31)
    g0, suffix = g.split_at(15)
    cfg = EngineConfig(max_batch=64, flush_ms=500.0, host_threshold=0)
    sweeps = segmented_select.stratum_sweep.launches
    b1 = label_prop.label_prop_round.launches
    with ServingEngine(cfg) as eng:
        assert eng.executor.device.type == "cuda"
        eng.register_graph("g", g0)
        h = eng.warmup("g")
        assert h.device.device.type == "cuda"
        for graph in (g0, g):
            rng = np.random.default_rng(graph.t_max)
            specs = [TCCSQuery(u, ts, te, int(rng.choice(h.supported_ks)))
                     for (u, ts, te) in random_queries(graph, 40, seed=2)]
            futs = eng.submit_specs("g", specs)
            eng.flush()
            for q, f in zip(specs, futs):
                r = f.result(timeout=120)
                assert r.provenance.route in ("device", "cache")
                assert set(r.vertices) == kcore.tccs_oracle(
                    graph, q.k, q.u, q.ts, q.te)
            if graph is g0:
                eng.ingest("g", [tuple(e) for e in suffix.tolist()],
                           wait=True, timeout=120)
                h = eng.registry.get_nowait("g")
        rounds = eng.metrics.counter("propagation_rounds")
    assert segmented_select.stratum_sweep.launches - sweeps == 2
    assert label_prop.label_prop_round.launches - b1 == rounds > 0


@pytest.mark.parametrize("M,K,N", [(64, 64, 64), (200, 300, 150),
                                   (128, 256, 384), (33, 65, 17), (1, 8, 8),
                                   (16, 4096, 4096), (16, 13696, 4096),
                                   (64, 4096, 256), (65, 1000, 1000),
                                   (512, 4096, 13696), (4096, 4096, 256),
                                   (300, 136, 20),
                                   # the prefill projections at full size
                                   (4096, 4096, 4096), (4096, 4096, 13696),
                                   (4096, 13696, 4096),
                                   # ragged M, N against BN = 256, K
                                   (4095, 4096, 4096), (130, 4096, 4096),
                                   (65, 4096, 256), (256, 4096, 13696),
                                   (256, 4104, 1024)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_matmul_kernel_matches_plain_version(cuda, M, K, N, dtype):
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = torch.randn(M, K, generator=gen, device=cuda).to(dt)
    b = torch.randn(K, N, generator=gen, device=cuda).to(dt)
    route = segment_matmul.plan(M, N, K, dt).route
    before = segment_matmul.matmul.launches
    routes = dict(segment_matmul.matmul.routes)
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert segment_matmul.matmul.launches == before + 1
    routes[route] += 1
    assert segment_matmul.matmul.routes == routes
    want = ref.matmul(a, b)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * K)


def test_wgmma_single_tile_matches_plain_version(cuda):
    """One m64n128k16 wgmma from TMA-loaded, 128B-swizzled tiles (A
    K-major, B MN-major): the descriptors and swizzle of the TMA routes on
    a single tile, where a mistake gives wrong numbers, not a crash."""
    gen = torch.Generator(device=cuda).manual_seed(64)
    a = torch.randn(64, 16, generator=gen, device=cuda).bfloat16()
    b = torch.randn(16, 128, generator=gen, device=cuda).bfloat16()
    got = segment_matmul.wgmma_probe(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.matmul(a, b), rtol=1e-4,
                               atol=1e-6 * 16)


@pytest.mark.parametrize("M,K,N", [(4096, 4096, 256), (16, 4096, 4096)])
def test_matmul_split_k_is_bitwise_deterministic(cuda, M, K, N):
    """Split-K sums its partials in a fixed order: two calls agree bit for
    bit."""
    assert segment_matmul.plan(M, N, K).splits > 1
    gen = torch.Generator(device=cuda).manual_seed(K)
    a = torch.randn(M, K, generator=gen, device=cuda).bfloat16()
    b = torch.randn(K, N, generator=gen, device=cuda).bfloat16()
    assert torch.equal(ops.matmul(a, b), ops.matmul(a, b))


def test_matmul_routes_are_counted(cuda):
    """One launch on each route, each counted under its route and once in
    the total; a TMA shape whose base is not 16-byte aligned takes the
    masked route."""
    segment_matmul.reset_counts()
    gen = torch.Generator(device=cuda).manual_seed(4)
    cases = {route: (torch.randn(m, 64, generator=gen, device=cuda).to(dt),
                     torch.randn(64, n, generator=gen, device=cuda).to(dt))
             for route, m, n, dt in (("wgmma", 128, 256, torch.bfloat16),
                                     ("skinny", 16, 128, torch.bfloat16),
                                     ("f32", 128, 41, torch.float32))}
    base = torch.zeros(8 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    cases["masked"] = (base[1:].view(8, 64), cases["skinny"][1])
    for route, (a, b) in cases.items():
        got = ops.matmul(a, b)
        torch.testing.assert_close(got, ref.matmul(a, b), rtol=1e-4,
                                   atol=1e-4)
        assert segment_matmul.matmul.routes[route] == 1, route
    assert segment_matmul.matmul.launches == 4
    assert sorted(segment_matmul.matmul.routes.values()) == [1, 1, 1, 1]


def test_matmul_kernel_masks_unaligned_operands(cuda):
    """Operands whose rows are not 16-byte multiples take the masked
    element-wise loads; a view that is not contiguous raises. Mixed float
    operands multiply as their promotion (here f32); f64 operands are
    computed in f32, as the plain version computes them."""
    base = torch.randn(70, 131, device=cuda).bfloat16()
    a, b = base[:33, 1:66].contiguous(), base[3:68, 2:19].contiguous()
    assert segment_matmul.plan(33, 17, 65).route == "masked"
    torch.testing.assert_close(ops.matmul(a, b), ref.matmul(a, b),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        ops.matmul(base[:, :65], base[:65, :3])
    before = segment_matmul.matmul.routes["f32"]
    torch.testing.assert_close(ops.matmul(a, b.float()),
                               ref.matmul(a.float(), b.float()), rtol=1e-4,
                               atol=1e-4)
    assert segment_matmul.matmul.routes["f32"] == before + 1
    for a64, b64 in ((a, b.double()), (a.double(), b.double())):
        got = ops.matmul(a64, b64)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, ref.matmul(a64, b64), rtol=1e-4,
                                   atol=1e-4)
    assert segment_matmul.matmul.routes["f32"] == before + 3


@pytest.mark.parametrize("B,S,T,H,Hkv,t_real,causal,dh,dtype", [
    (2, 64, 64, 4, 4, None, True, 128, "bf16"),
    (1, 70, 70, 8, 2, None, True, 128, "bf16"),
    (2, 128, 256, 4, 1, None, False, 128, "bf16"),
    (1, 40, 24, 4, 2, None, True, 128, "bf16"),
    (2, 24, 40, 6, 3, 30, True, 128, "bf16"),
    (1, 300, 300, 32, 2, None, True, 128, "bf16"),
    (16, 1, 1000, 32, 2, None, False, 128, "bf16"),
    (16, 1, 1000, 32, 2, 1, False, 128, "bf16"),
    (16, 1, 1000, 32, 2, 65, False, 128, "bf16"),
    (3, 1, 777, 32, 32, 500, False, 128, "bf16"),
    (2, 1, 96, 8, 2, 37, True, 128, "bf16"),
    (1, 2, 129, 16, 2, 100, False, 128, "bf16"),
    (4, 1, 5000, 16, 1, 4097, False, 128, "bf16"),
    # the wgmma route: glm4's GQA 16:1, ragged positions and keys, S != T
    (1, 1000, 1000, 32, 2, None, True, 128, "bf16"),
    (2, 333, 400, 16, 1, 390, True, 128, "bf16"),
    (1, 200, 520, 8, 8, None, False, 128, "bf16"),
    (1, 257, 257, 32, 2, None, True, 64, "bf16"),
    (1, 300, 300, 32, 2, None, True, 128, "f16"),
    (2, 100, 150, 4, 2, 140, False, 64, "f16"),
    # the mma and split routes at other head widths, f16; G = 3 (does
    # not divide 128) at dh = 128
    (2, 40, 40, 4, 2, None, True, 16, "bf16"),
    (2, 1, 40, 4, 2, 17, False, 16, "bf16"),
    (1, 90, 90, 4, 4, None, True, 8, "bf16"),
    (3, 1, 300, 4, 4, 201, False, 8, "f16"),
    (1, 70, 100, 8, 2, 90, True, 64, "f16"),
    (4, 1, 3000, 16, 1, None, False, 64, "bf16"),
    (1, 50, 50, 6, 2, None, True, 24, "bf16"),
    (1, 100, 100, 12, 4, None, True, 128, "bf16"),
    (2, 1, 700, 32, 2, 650, False, 80, "f16"),
    # the f32 route
    (2, 40, 40, 4, 2, None, True, 16, "f32"),
    (2, 1, 300, 4, 4, 123, False, 16, "f32"),
    (1, 70, 90, 8, 2, 80, True, 128, "f32"),
    (2, 33, 33, 6, 3, None, False, 64, "f32"),
    (1, 20, 20, 4, 4, None, True, 8, "f32")])
def test_flash_attention_kernel_matches_plain_version(cuda, B, S, T, H, Hkv,
                                                      t_real, causal, dh,
                                                      dtype):
    dt = {"bf16": torch.bfloat16, "f16": torch.float16,
          "f32": torch.float32}[dtype]
    gen = torch.Generator(device=cuda).manual_seed(S * T + H + dh)
    q = torch.randn(B, S, H, dh, generator=gen, device=cuda).to(dt)
    k, v = (torch.randn(B, T, Hkv, dh, generator=gen, device=cuda).to(dt)
            for _ in range(2))
    if t_real is not None:                 # keys past t_real are never read
        k[:, t_real:], v[:, t_real:] = float("nan"), float("nan")
    route = flash_attention.plan(B, S, H, Hkv, T if t_real is None else
                                 t_real, causal, dh, dt).route
    before = flash_attention.flash_attention.routes[route]
    got = ops.flash_attention(q, k, v, causal=causal, t_real=t_real)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
    assert got.dtype == dt and got.shape == q.shape
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= flash_attention.error_bound(want)).all()), \
        float(diff.max())


def test_flash_attention_probe_matches_plain_version(cuda):
    """The wgmma route's two products on a single tile: S = Q K^T from
    TMA-loaded tiles within f32 rounding of the plain product, and P V
    with P rounded to bf16 in registers within the route's bound."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(64, 128, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(128, 128, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    s, o = flash_attention.rs_probe(q, k, v)
    torch.testing.assert_close(s, q.float() @ k.float().T, rtol=1e-5,
                               atol=1e-4)
    want = ref.flash_attention(q.float()[None, :, None], k.float()[None, :,
                                                                    None],
                               v.float()[None, :, None])[0, :, 0]
    bound = flash_attention.error_bound(want.bfloat16()[None, :, None])
    assert bool(((o - want).abs() <= bound[0, :, 0]).all())


@pytest.mark.parametrize("H,Hkv", [(48, 8), (12, 2)],
                         ids=["one_card", "model_rank"])
@pytest.mark.parametrize("S", [8, 64, 200])
def test_decode_rows_equal_the_causal_prefills_bit_for_bit(cuda, H, Hkv, S):
    """At dbrx-132b's attention shapes (bf16, dh 128, 6 query heads a kv
    head, batch 4; on one card and on a model rank of (1, 4)), the decode
    of position p over a 32,768-slot cache holding the prompt's keys (the
    split route, t_real = p + 1) equals the causal prefill's row p (the
    mma route) bit for bit, output and lse, wherever the decode's keys fit
    one block (no flash-decoding split); past that its rows stay within
    the plain version's bound."""
    B, dh, slots = 4, 128, 32768
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(B, S, h, dh, generator=gen,
                           device=cuda).bfloat16() for h in (H, Hkv, Hkv))
    ck = torch.randn(B, slots, Hkv, dh, generator=gen, device=cuda).bfloat16()
    cv = torch.randn_like(ck)
    ck[:, :S], cv[:, :S] = k, v
    assert flash_attention.plan(B, S, H, Hkv, S, True, dh).route == "mma"
    o, lse = flash_attention.flash_attention(q, k, v, causal=True,
                                             return_lse=True)
    one_block = 0
    for p in range(S):
        plan = flash_attention.plan(B, 1, H, Hkv, p + 1, False, dh)
        assert plan.route == "split"
        od, ld = flash_attention.flash_attention(
            q[:, p:p + 1].contiguous(), ck, cv, t_real=p + 1,
            return_lse=True)
        if plan.splits == 1:
            one_block += 1
            assert torch.equal(od.view(torch.int16),
                               o[:, p:p + 1].view(torch.int16)), p
            assert torch.equal(ld.view(torch.int32),
                               lse[:, :, p:p + 1].view(torch.int32)), p
        else:
            want = ref.flash_attention(q[:, p:p + 1], ck, cv, t_real=p + 1)
            assert bool(((od.float() - want.float()).abs()
                         <= flash_attention.error_bound(want)).all()), p
    assert one_block == min(S, 64)


@pytest.mark.parametrize("dh,dtype", [(12, "bf16"), (12, "f32"),
                                      (136, "bf16"), (136, "f32"),
                                      (256, "bf16"), (256, "f32"),
                                      (4, "f16"), (64, "f64"), (12, "f64"),
                                      (136, "f64")])
def test_flash_attention_kernel_refuses_other_shapes(cuda, dh, dtype):
    """Every head width and f64 now compute on the card, within
    ``error_bound`` of the plain version: a dh that is not a multiple of 8
    is zero-padded (scale 1/sqrt(dh) kept), a dh above 128 takes the
    ``wide`` route (the f32 route's kernel over 128-column chunks), f64 is
    computed in f32 and cast back. Another dtype still raises."""
    dt = {"bf16": torch.bfloat16, "f16": torch.float16,
          "f32": torch.float32, "f64": torch.float64}[dtype]
    gen = torch.Generator(device=cuda).manual_seed(dh)
    for B, S, T, H, Hkv, t_real, causal in ((2, 40, 40, 4, 2, None, True),
                                            (3, 1, 300, 8, 2, 201, False),
                                            (1, 70, 90, 6, 3, 80, True)):
        q = torch.randn(B, S, H, dh, generator=gen, device=cuda).to(dt)
        k, v = (torch.randn(B, T, Hkv, dh, generator=gen, device=cuda).to(dt)
                for _ in range(2))
        if t_real is not None:
            k[:, t_real:], v[:, t_real:] = float("nan"), float("nan")
        kdt = torch.float32 if dt == torch.float64 else dt
        route = flash_attention.plan(
            B, S, H, Hkv, T if t_real is None else t_real, causal,
            flash_attention.kernel_width(dh), kdt).route
        assert route == "wide" if dh > 128 else route != "wide"
        before = flash_attention.flash_attention.routes[route]
        got = ops.flash_attention(q, k, v, causal=causal, t_real=t_real)
        torch.cuda.synchronize()
        assert flash_attention.flash_attention.routes[route] == before + 1
        want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
        assert got.dtype == dt and got.shape == q.shape
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= flash_attention.error_bound(want)).all()), \
            (B, S, float(diff.max()))
    q = torch.zeros(1, 4, 4, 64, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q)


def test_lm_decode_matches_forward_on_card(cuda):
    """A narrow glm4-shaped model (dh 128, GQA 16:1) on the card: decode
    with the kernels against prefill with the kernels, and prefill with the
    kernels against the plain versions, each within 5e-2 of the largest
    |logit| (chip_smoke.py's bound)."""
    from unittest import mock
    cfg = tfm.LMConfig("narrow", n_layer=4, d_model=512, n_head=32, n_kv=2,
                       d_ff=1024, vocab=2000, d_head=128, qkv_bias=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = tfm.init_params(cfg, gen, device=cuda)
    toks = torch.randint(0, cfg.vocab, (3, 20), generator=gen, device=cuda)
    full, _ = tfm.forward(model, toks)
    with mock.patch.object(ops, "matmul", ref.matmul), \
            mock.patch.object(ops, "flash_attention", ref.flash_attention):
        plain, _ = tfm.forward(model, toks)
    assert (full - plain).abs().max() <= 5e-2 * plain.abs().max()
    cache = tfm.init_cache(cfg, 3, 200, device=cuda)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    for i in range(toks.shape[1]):
        step, _ = tfm.decode_step(model, toks[:, i:i + 1], cache, i)
        assert (step - full[:, i]).abs().max() <= \
            5e-2 * full[:, i].abs().max()


def segment_operands(E, d, S, kind, seed=0):
    """``runs``: a sampled GNN batch's aggregation, ids grouped by
    destination in runs of 10-15 over the first 36% of the rows with
    N(0, 1) values, the rest padding rows with id 0 and value 0 (the
    model multiplies them by their zero edge mask); ``integer_runs``: the
    same ids, every row (the long run of padding rows too) holding small
    integers, whose f32 sums are exact in any order; ``random``: N(0, 1)
    values on unsorted ids with 10% -1 and 5% >= S; ``hubs``: unsorted
    ids, 60% of them on one id and 5% on a second (meshgraphnet's
    power-law hubs, a padded batch's node 0), the rest uniform, with small
    integer values: a hub of 200,000 N(0, 1) rows sums to within f32's
    rounding of a few hundred (~1e-2) in any order, so that the kernel and
    the plain version would part by more than 1e-4 while both are right;
    integer rows sum exactly in every order."""
    rng = np.random.default_rng(seed + E + d + S)
    vals = rng.normal(size=(E, d)).astype(np.float32)
    if kind == "hubs":
        ids = rng.integers(0, max(S, 1), E)
        u = rng.random(E)
        ids[u < 0.6] = S // 2
        ids[(u >= 0.6) & (u < 0.65)] = max(S - 1, 0)
        vals = rng.integers(-4, 5, (E, d)).astype(np.float32)
        return vals, ids.astype(np.int32)
    if kind == "random":
        ids = rng.integers(0, max(S, 1), E)
        u = rng.random(E)
        past = (u >= 0.1) & (u < 0.15)
        ids[u < 0.1] = -1
        ids[past] = S + rng.integers(0, 1000, int(past.sum()))
        return vals, ids.astype(np.int32)
    runs = rng.integers(10, 16, max(E // 12, 1))
    real = np.repeat(rng.integers(0, max(S, 1), len(runs)), runs)[
        :int(E * 0.36)]
    ids = np.zeros(E, np.int32)
    ids[:len(real)] = real
    if kind == "integer_runs":
        vals = rng.integers(-4, 5, (E, d)).astype(np.float32)
    else:
        vals[len(real):] = 0.0
    return vals, ids


@pytest.mark.parametrize("E,d,S", [(337_920, 602, 169_984),
                                   (337_920, 128, 169_984),
                                   (337_920, 1, 169_984), (10, 4, 3),
                                   (700, 32, 90), (1024, 128, 256),
                                   (513, 7, 1), (129, 131, 5), (0, 5, 3),
                                   (5, 3, 0), (1, 1, 1)])
@pytest.mark.parametrize("kind", ["runs", "integer_runs", "random", "hubs"])
def test_segment_sum_kernel_matches_plain_version(cuda, E, d, S, kind):
    """Also: bit-equal to the plain mirror of its decomposition and to
    itself with a plan built beforehand."""
    vals, ids = segment_operands(E, d, S, kind)
    vals, ids = torch.as_tensor(vals, device=cuda), torch.as_tensor(
        ids, device=cuda)
    before = segment_matmul.segment_sum.launches
    got = ops.segment_sum(vals, ids, S)
    torch.cuda.synchronize()
    assert segment_matmul.segment_sum.launches == before + (E * d * S > 0)
    want = ref.segment_sum(vals, ids, S)
    assert got.dtype == torch.float32 and got.shape == (S, d)
    if kind in ("integer_runs", "hubs"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    plan = ops.segment_plan(ids, S)
    assert torch.equal(ops.segment_sum(vals, plan, S), got)
    assert torch.equal(got, ref.segment_sum_tiled(
        vals, plan, *segment_matmul.segment_tiles(E, d)))


@pytest.mark.parametrize("E,d", [(1_000_000, 128), (100_000, 1),
                                 (200_000, 7), (120_000, 602)])
def test_segment_sum_kernel_carries_across_many_tiles(cuda, E, d):
    """One id on 60% of the rows: its carry chain spans hundreds of level-0
    tiles and every level above. On integer rows the kernel equals the
    plain version exactly; on N(0, 1) rows it equals its mirror and itself
    bit for bit."""
    S = 5_000
    ints, ids = segment_operands(E, d, S, "hubs")
    ints, ids = torch.as_tensor(ints, device=cuda), torch.as_tensor(
        ids, device=cuda)
    vals = torch.randn(E, d, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(E + d))
    tile, fans = segment_matmul.segment_tiles(E, d)
    assert int((ids == S // 2).sum()) >= 300 * tile and len(fans) >= 3
    plan = ops.segment_plan(ids, S)
    assert torch.equal(segment_matmul.segment_sum(ints, plan, S),
                       ref.segment_sum(ints, ids, S))
    got = segment_matmul.segment_sum(vals, plan, S)
    again = segment_matmul.segment_sum(vals, plan, S)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, ref.segment_sum_tiled(vals, plan, tile, fans))


def test_segment_plan_on_card_equals_cpu_and_is_counted(cuda):
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 60, 5_000).astype(np.int32)
    ids[rng.random(5_000) < 0.05] = 70
    before = segment_matmul.segment_plan.builds
    plan = ops.segment_plan(torch.as_tensor(ids, device=cuda), 60)
    cpu = ops.segment_plan(torch.as_tensor(ids), 60)
    assert segment_matmul.segment_plan.builds == before + 1
    for name in ("ids", "perm", "sorted_ids", "offsets"):
        got, want = getattr(plan, name), getattr(cpu, name)
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    assert plan.num_segments == 60
    # plan-free calls build one; calls with a plan build none
    vals = torch.randn(5_000, 16, device=cuda)
    segment_matmul.segment_sum(vals, plan, 60)
    assert segment_matmul.segment_plan.builds == before + 1
    segment_matmul.segment_sum(vals, plan.ids, 60)
    assert segment_matmul.segment_plan.builds == before + 2
    with pytest.raises(ValueError):
        segment_matmul.segment_sum(vals, plan, 61)


def test_segment_sum_kernel_takes_bf16_and_refuses_strided_values(cuda):
    vals = torch.randn(300, 40, device=cuda)
    ids = torch.randint(-1, 20, (300,), device=cuda, dtype=torch.int32)
    torch.testing.assert_close(ops.segment_sum(vals.bfloat16(), ids, 20),
                               ref.segment_sum(vals.bfloat16(), ids, 20),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        ops.segment_sum(vals[:, ::2], ids, 20)


def test_sage_forward_on_card_matches_plain_versions_and_cpu(cuda):
    """graphsage-reddit at full width on a sampled, padded batch of a small
    pool: the forward with B4 and B5 against the same forward with the
    plain versions on the card and on the CPU, within 1e-4 of max|logit|;
    4 B4 and 5 B5 launches."""
    from unittest import mock

    from repro_torch import configs
    n = 4_000
    g = gs.CSRGraph(n, *gs.random_powerlaw_graph(n, 20, seed=1))
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(n, 602)).astype(np.float32)
    labels = rng.integers(0, 41, n).astype(np.int32)
    batch = gs.sample_subgraph_batch(g, feats, labels,
                                     rng.choice(n, 256, replace=False),
                                     (15, 10), rng, pad_nodes=4_096,
                                     pad_edges=16_384)
    spec = configs.get("graphsage-reddit")
    cfg = configs.cell_model_cfg(spec, "minibatch_lg")
    step = configs.make_serve_step(spec, "minibatch_lg")
    model = gnn.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                            device=cuda)
    feed = {k: torch.as_tensor(batch[k], device=cuda)
            for k in ("node_feat", "src", "dst", "edge_mask")}
    before = (segment_matmul.segment_sum.launches,
              segment_matmul.matmul.launches)
    got = step(model, feed)
    torch.cuda.synchronize()
    assert (segment_matmul.segment_sum.launches - before[0],
            segment_matmul.matmul.launches - before[1]) == (4, 5)
    with mock.patch.object(ops, "segment_sum", ref.segment_sum), \
            mock.patch.object(ops, "matmul", ref.matmul):
        plain = step(model, feed)
    cpu_model = gnn.GraphSAGE(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    on_cpu = step(cpu_model, {k: v.cpu() for k, v in feed.items()})
    for want in (plain, on_cpu.to(cuda)):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_store_promotion_on_card_equals_cold_build(cuda, tmp_path):
    """The disk tier on the card: a registry writes its cold build through,
    a second registry promotes it with no stratum sweep, and the promoted
    mirror equals a fresh upload of a cold card build array for array;
    then one ingest onto the promoted (mmap-backed) handle equals a cold
    card build of the grown graph, mirror included."""
    from repro_torch.serving import IndexRegistry
    from repro_torch.store import IndexStore

    g = gen_temporal_graph(n=40, m=420, t_max=18, seed=31)
    g0, suffix = g.split_at(15)
    reg = IndexRegistry(store=IndexStore(str(tmp_path)), device=cuda)
    reg.register_graph("g", g0)
    reg.get("g", timeout=120)
    reg.close()
    sweeps = segmented_select.stratum_sweep.launches
    reg = IndexRegistry(store=IndexStore(str(tmp_path)), device=cuda)
    h = reg.get("g", timeout=120)
    assert h.source == "disk" and reg.stats()["promotions"] == 1
    assert segmented_select.stratum_sweep.launches == sweeps
    for graph, handle in ((g0, h), (g, None)):
        if handle is None:
            before = segmented_select.stratum_sweep.launches
            fut = reg.extend_graph("g", [tuple(e) for e in suffix.tolist()])
            handle = fut["g"].result(timeout=120)
            assert segmented_select.stratum_sweep.launches == before + 1
        cold = build_stratified_index(graph, device=cuda)
        fresh = bq.to_device(cold, cuda)
        for f in bq._ARRAY_FIELDS:
            got, want = getattr(handle.device, f), getattr(fresh, f)
            assert got.device.type == "cuda" and torch.equal(got, want), f
        for f in ("node_u", "ent_ts", "vent_node", "knode_ptr"):
            assert np.array_equal(getattr(handle.pecb, f), getattr(cold, f))
    st = reg.stats()
    reg.close()
    assert (st["store_load_failures"], st["store_commit_failures"]) == (0, 0)
    assert IndexStore(str(tmp_path)).current_epoch("g") == 1


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """graphsage-reddit's parameters from the card through save and
    save_async, restored onto cuda:0 bit-equal."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager

    cfg = configs.cell_model_cfg(configs.get("graphsage-reddit"),
                                 "minibatch_lg")
    model = gnn.init_params(cfg, torch.Generator(cuda).manual_seed(3),
                            device=cuda)
    sd = model.state_dict()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, sd)
    mgr.save_async(2, {"params": sd, "bf16": torch.randn(
        4, 8, device=cuda).bfloat16()})
    mgr.wait()
    _, got, _ = mgr.restore(1, device="cuda:0")
    assert list(got) == list(sd)
    for k, v in got.items():
        assert v.device == torch.device("cuda", 0) and torch.equal(v, sd[k])
    _, got2, _ = mgr.restore(device="cuda:0")
    assert all(torch.equal(got2["params"][k], v) for k, v in sd.items())
    assert got2["bf16"].dtype == torch.bfloat16


# ----------------------------------------------------------------------
# the baselines (A7) and the k-core on the peel fixpoint
# ----------------------------------------------------------------------

def kmax_probes(km: int) -> int:
    """Fixpoints :func:`kcore.k_max` runs to find ``km``: the doubling's
    probes (the last one empty), then the bisection's."""
    probes, lo, hi = 0, 1, 1
    while hi <= km:
        probes += 1
        lo, hi = hi, hi * 2
    probes += 1
    while lo + 1 < hi:
        probes += 1
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if mid <= km else (lo, mid)
    return probes


def test_boruvka_on_card_equals_kruskal(cuda):
    """Borůvka as torch ops on card tensors selects the Kruskal forest at
    every start time of cm_like at its default k."""
    from repro_torch.core import ctmsf, ecb_forest

    g = bench_graph("cm_like")
    tab = core_time.edge_core_times(g, 12, device=cuda)
    checked = 0
    for ts in range(1, g.t_max + 1):
        e_ids, cts = ecb_forest.active_versions(tab, ts)
        if not e_ids.size:
            continue
        u, v = g.src[e_ids], g.dst[e_ids]
        stats = {}
        got = ctmsf.boruvka_msf(*(torch.as_tensor(a, device=cuda)
                                  for a in (u, v, cts)), g.n, stats=stats)
        assert got.device.type == cuda.type and stats["rounds"][0] >= 1
        want = ctmsf.kruskal_msf(u, v, cts, g.n)
        assert np.array_equal(got.cpu().numpy(), want), ts
        assert np.array_equal(ctmsf.boruvka_msf_np(u, v, cts, g.n,
                                                   device=cuda), want)
        checked += 1
    assert checked > 100


def test_k_max_on_card_counts_one_launch_per_probe(cuda):
    for g in (bench_graph("cm_like"),
              gen_temporal_graph(n=1899, m=59835, t_max=193, seed=7)):
        km = kcore.k_max(g)
        before = kcore_peel.kcore_fixpoint.launches
        assert kcore.k_max(g, device=cuda) == km
        assert kcore_peel.kcore_fixpoint.launches - before == kmax_probes(km)
        assert core_time.default_ks(g, device=cuda) == core_time.default_ks(g)


def test_distinct_kcore_on_card_with_self_loops_and_parallel_edges(cuda):
    rng = np.random.default_rng(23)
    n, m = 60, 900
    src = rng.integers(0, n, m).astype(np.int32)
    dst = np.where(rng.random(m) < 0.05, src, rng.integers(0, n, m))
    dst = dst.astype(np.int32)
    src, dst = np.concatenate([src, src[:200]]), np.concatenate([dst,
                                                                 dst[:200]])
    for k in (-1, 0, 1, 2, 5, 9, 14, 40):
        before = kcore_peel.kcore_fixpoint.launches
        got = kcore.distinct_kcore_edge_mask(src, dst, n, k, device=cuda)
        assert kcore_peel.kcore_fixpoint.launches == before + 1
        assert np.array_equal(got, kcore.distinct_kcore_edge_mask(
            src, dst, n, k)), k


def test_window_oracles_on_card_equal_numpy(cuda):
    """One fixpoint launch per window with edges; the same vertex and edge
    sets as the numpy peel."""
    g = bench_graph("cm_like")
    for k in (2, 12):
        for (u, ts, te) in random_queries(g, 24, seed=k):
            nonempty = int(g.project(ts, te)[0].size > 0)
            before = kcore_peel.kcore_fixpoint.launches
            got = kcore.tccs_oracle(g, k, u, ts, te, device=cuda)
            got_e = kcore.tccs_oracle_edges(g, k, u, ts, te, device=cuda)
            assert kcore_peel.kcore_fixpoint.launches - before == 2 * nonempty
            assert got == kcore.tccs_oracle(g, k, u, ts, te)
            assert got_e == kcore.tccs_oracle_edges(g, k, u, ts, te)


def test_card_build_takes_its_k_range_on_the_card(cuda):
    """A card build peels its default k range and k_max_graph through the
    fixpoint kernel; strata and index are those of the host build."""
    from repro_torch.core import streaming

    g = gen_temporal_graph(n=300, m=4000, t_max=160, seed=1)
    km = kcore.k_max(g)
    before = kcore_peel.kcore_fixpoint.launches
    dev = core_time.stratified_core_times(g, device=cuda)
    assert kcore_peel.kcore_fixpoint.launches - before == kmax_probes(km)
    host = core_time.stratified_core_times(g, device="cpu")
    assert dev.ks == host.ks == core_time.default_ks(g)
    for f in ("kptr", "edge_id", "ts_from", "ts_to", "ct", "vptr"):
        assert np.array_equal(getattr(dev, f), getattr(host, f)), f
    before = kcore_peel.kcore_fixpoint.launches
    sx = build_stratified_index(g, strata=dev, device=cuda)
    assert kcore_peel.kcore_fixpoint.launches - before == kmax_probes(km)
    want = build_stratified_index(g, strata=host, device="cpu")
    assert sx.k_max_graph == want.k_max_graph == km
    for f in ("node_u", "ent_ts", "vent_node", "knode_ptr"):
        assert np.array_equal(getattr(sx, f), getattr(want, f)), f
    g0, suffix = g.split_at(150)
    sx0 = build_stratified_index(g0, device=cuda)
    g1 = g0.extend(map(tuple, suffix.tolist()))
    before = kcore_peel.kcore_fixpoint.launches
    sx1 = streaming.extend_stratified_index(g1, sx0, device=cuda)
    assert kcore_peel.kcore_fixpoint.launches > before
    assert sx1.ks == want.ks and sx1.k_max_graph == km
    g2 = g1.expire_before(80)
    sx2 = streaming.shrink_stratified_index(g2, sx1, device=cuda)
    assert sx2.ks == core_time.default_ks(g2)
    assert sx2.k_max_graph == kcore.k_max(g2)


@pytest.mark.parametrize("backend", ["ef", "ctmsf"])
def test_baseline_index_builds_its_table_on_the_card(cuda, backend):
    from repro_torch.core.ctmsf_index import CTMSFIndex
    from repro_torch.core.ef_index import EFIndex

    g = bench_graph("cm_like")
    cls = EFIndex if backend == "ef" else CTMSFIndex
    got = cls(g, 12, device=cuda)
    want = cls(g, 12, core_time.edge_core_times(g, 12, device="cpu"))
    assert got.nbytes() == want.nbytes()
    assert np.array_equal(got.node_u if backend == "ctmsf"
                          else got.ts_to_forest,
                          want.node_u if backend == "ctmsf"
                          else want.ts_to_forest)
    for (u, ts, te) in random_queries(g, 50, seed=4):
        assert got._component_vertices(u, ts, te) == \
            want._component_vertices(u, ts, te)


# -- the training path's gradients (B5 on transposed operands, B4's gather,
# B6's backward) and the train step, against the plain versions ------------

def _attn_inputs(cuda, B, S, T, H, Hkv, dh, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed + S + T + H + dh)
    q = torch.randn(B, S, H, dh, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, T, Hkv, dh, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn(B, S, H, dh, generator=g, device=cuda).to(dtype)
    return q, k, v, do


def _bwd_checked(q, k, v, o, do, got, causal, t_real):
    """Hold a backward's (dq, dk, dv, lse) to the plain backward: each
    gradient within ``bwd_error_bound``, keys past t_real 0, lse within
    1e-4."""
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                   t_real=t_real)
    scales = ref.flash_attention_bwd_scales(q, k, v, o, do, causal=causal,
                                            t_real=t_real)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == q.dtype and a.shape == w.shape
        diff = (a.float() - w.float()).abs()
        bound = flash_attention.bwd_error_bound(w, *scales[name])
        assert bool((diff <= bound).all()), \
            (name, float(diff.max()), float((diff / bound).max()))
    T = k.shape[1]
    if t_real is not None and t_real < T:   # keys past t_real: no gradient
        assert float(got[1][:, t_real:].float().abs().max()) == 0.0
        assert float(got[2][:, t_real:].float().abs().max()) == 0.0
    torch.testing.assert_close(got[3], want[3].float(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=["bf16", "f16", "f32"])
def test_flash_attention_backward_kernel_matches_plain_version(
        cuda, dtype, dh, G, causal):
    """Every route at the plan's choice (wgmma for bf16 and f16 at dh 64
    and 128, mma at dh 16, f32), given the forward's lse: within
    ``bwd_error_bound`` of the plain backward, and bit-equal to a second
    call with ``lse=None``, which takes lse from one forward launch."""
    B, S, T, Hkv = 2, 150, 150 if causal else 170, 2
    t_real = T if causal else 161
    H = G * Hkv
    q, k, v, do = _attn_inputs(cuda, B, S, T, H, Hkv, dh, dtype)
    o, lse = flash_attention.flash_attention(q, k, v, causal=causal,
                                             t_real=t_real, return_lse=True)
    route = flash_attention.bwd_plan(B, S, H, Hkv, t_real, causal, dh,
                                     dtype).route
    assert route == ("f32" if dtype == torch.float32 else
                     "wgmma" if dh in (64, 128) else "mma")
    before = flash_attention.flash_attention_bwd.routes[route]
    got = flash_attention.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                              t_real=t_real, lse=lse)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bwd.routes[route] == before + 1
    _bwd_checked(q, k, v, o, do, got, causal, t_real)
    fwd = flash_attention.flash_attention.launches
    again = flash_attention.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                                t_real=t_real)
    assert flash_attention.flash_attention.launches == fwd + 1
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.parametrize("groups", [1, 2, 4, 8, 16])
def test_flash_attention_backward_wgmma_head_groups_at_4000(cuda, groups,
                                                            monkeypatch):
    """glm4's causal backward at a ragged 4,000 positions on the wgmma
    route with each split of the kv heads' 16 query heads into head groups
    (the plan's and the others): within ``bwd_error_bound`` of the plain
    backward and bitwise reproducible."""
    B, S, H, Hkv, dh = 1, 4000, 32, 2, 128
    q, k, v, do = _attn_inputs(cuda, B, S, S, H, Hkv, dh, torch.bfloat16)
    o, lse = flash_attention.flash_attention(q, k, v, causal=True,
                                             return_lse=True)
    plan = flash_attention.bwd_plan(B, S, H, Hkv, S, True, dh,
                                    torch.bfloat16)
    assert plan.route == "wgmma"
    monkeypatch.setattr(flash_attention, "bwd_plan",
                        lambda *a: plan._replace(groups=groups))
    got = flash_attention.flash_attention_bwd(q, k, v, o, do, causal=True,
                                              lse=lse)
    again = flash_attention.flash_attention_bwd(q, k, v, o, do, causal=True,
                                                lse=lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _bwd_checked(q, k, v, o, do, got, True, None)


@pytest.mark.parametrize("B,S,T,H,Hkv,t_real,causal,dh,dtype,route", [
    (1, 300, 300, 32, 2, None, True, 128, "bf16", "wgmma"),
    (2, 100, 150, 4, 2, 140, False, 64, "f16", "wgmma"),
    (2, 40, 40, 4, 2, None, True, 16, "bf16", "mma"),
    (1, 100, 100, 12, 4, None, True, 128, "bf16", "mma"),
    (16, 1, 1000, 32, 2, None, False, 128, "bf16", "split"),
    (4, 1, 5000, 16, 1, 4097, False, 128, "bf16", "split"),
    (1, 70, 90, 8, 2, 80, True, 128, "f32", "f32"),
    (1, 70, 90, 6, 3, 80, True, 136, "bf16", "wide"),
    (2, 40, 40, 4, 2, None, True, 256, "f32", "wide"),
    (1, 30, 30, 4, 2, None, True, 64, "f64", "f32")])
def test_flash_attention_forward_lse_on_every_route(cuda, B, S, T, H, Hkv,
                                                    t_real, causal, dh,
                                                    dtype, route):
    """Every forward route writes the rows' lse when asked, within 1e-4 of
    the plain version's, and its output is the one without lse, bit for
    bit (serving asks for none)."""
    dt = {"bf16": torch.bfloat16, "f16": torch.float16,
          "f32": torch.float32, "f64": torch.float64}[dtype]
    q, k, v, _ = _attn_inputs(cuda, B, S, T, H, Hkv, dh, dt)
    before = flash_attention.flash_attention.routes[route]
    o = flash_attention.flash_attention(q, k, v, causal=causal, t_real=t_real)
    o2, lse = flash_attention.flash_attention(q, k, v, causal=causal,
                                              t_real=t_real, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.routes[route] == before + 2
    assert torch.equal(o, o2)
    _, want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real,
                                  return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want.float(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dh", [12, 40])
def test_flash_attention_backward_pads_odd_head_widths(cuda, dh):
    q, k, v, do = _attn_inputs(cuda, 1, 70, 70, 6, 3, dh, torch.bfloat16)
    o = ops.flash_attention(q, k, v, causal=True)
    got = flash_attention.flash_attention_bwd(q, k, v, o, do, causal=True)
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=True)
    scales = ref.flash_attention_bwd_scales(q, k, v, o, do, causal=True)
    for name, a, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.shape == w.shape
        assert bool(((a.float() - w.float()).abs() <= flash_attention
                     .bwd_error_bound(w, *scales[name])).all())


def test_flash_attention_backward_refuses_wide_heads(cuda):
    """Heads wider than 128 have a backward on the card now (they raised
    before): the ``wide`` route, in bf16, f16 and f32, within
    ``bwd_error_bound`` of the plain backward and bitwise reproducible."""
    for dh, dtype in ((136, torch.bfloat16), (200, torch.float16),
                      (256, torch.float32)):
        q, k, v, do = _attn_inputs(cuda, 1, 40, 50, 4, 2, dh, dtype)
        o, lse = flash_attention.flash_attention(q, k, v, causal=True,
                                                 t_real=45, return_lse=True)
        before = flash_attention.flash_attention_bwd.routes["wide"]
        got = flash_attention.flash_attention_bwd(q, k, v, o, do,
                                                  causal=True, t_real=45,
                                                  lse=lse)
        again = flash_attention.flash_attention_bwd(q, k, v, o, do,
                                                    causal=True, t_real=45,
                                                    lse=lse)
        torch.cuda.synchronize()
        assert flash_attention.flash_attention_bwd.routes["wide"] == \
            before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _bwd_checked(q, k, v, o, do, got, True, 45)


@pytest.mark.parametrize("E,d,S", [(1, 1, 1), (37, 5, 4), (2_000, 128, 900),
                                   (3_001, 602, 1_500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_gather_kernel_matches_plain_version(cuda, E, d, S, dtype):
    rng = np.random.default_rng(E + d)
    ids = rng.integers(0, S, E)
    ids[rng.random(E) < 0.1] = -1
    ids[rng.random(E) < 0.05] = S + 3
    ids = torch.as_tensor(ids.astype(np.int32), device=cuda)
    dout = torch.as_tensor(rng.normal(size=(S, d)).astype(np.float32),
                           device=cuda)
    before = segment_matmul.segment_gather.launches
    got = segment_matmul.segment_gather(dout, ids, dtype)
    torch.cuda.synchronize()
    assert segment_matmul.segment_gather.launches == before + 1
    want = ref.segment_gather(dout, ids, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("M,K,N", [(64, 48, 40), (300, 256, 96),
                                   (1_000, 130, 72)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_matmul_gradient_kernels_match_plain_version(cuda, M, K, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    b = torch.randn(K, N, generator=g, device=cuda).to(dtype)
    dc = torch.randn(N, M, generator=g, device=cuda).t()   # not contiguous
    if dtype == torch.bfloat16:
        dc = dc.bfloat16().float()
    a.requires_grad_(True)
    b.requires_grad_(True)
    before = segment_matmul.matmul.launches
    c = ops.matmul(a, b)
    da, db = torch.autograd.grad(c, (a, b), dc)
    torch.cuda.synchronize()
    assert segment_matmul.matmul.launches == before + 3
    wa, wb = ref.matmul_grads(a.detach(), b.detach(), dc)
    assert da.dtype == wa.dtype == dtype and db.dtype == dtype
    for got, want, k in ((da, wa, N), (db, wb, M)):
        tol = 1e-4 * want.float().abs() + 1e-6 * k
        if dtype == torch.bfloat16:          # both rounded to bf16 last
            tol = 2 ** -7 * want.float().abs() + 1e-6 * k
        assert bool(((got.float() - want.float()).abs() <= tol).all())


def _plain_ops():
    from unittest import mock
    return (mock.patch.object(ops, "matmul", ref.matmul),
            mock.patch.object(ops, "flash_attention", ref.flash_attention),
            mock.patch.object(ops, "segment_sum", ref.segment_sum),
            mock.patch.object(ops, "gather_rows",
                              lambda x, idx: x[segment_matmul.plan_ids(
                                  idx).long()]))


def _loss_and_grads(spec, cfg, model, batch, plain=False, relu=None):
    import contextlib
    from unittest import mock
    from repro_torch import configs
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    with contextlib.ExitStack() as stack:
        if plain:
            for patch in _plain_ops():
                stack.enter_context(patch)
        if relu is not None:
            stack.enter_context(mock.patch.object(torch, "relu", relu))
        loss = configs.loss_for(spec, cfg)(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_lm_train_gradients_match_plain_versions_on_card(cuda, dtype):
    """A narrow glm4-shaped model (dh 128, GQA 16:1, 2 layers, remat): the
    loss and every gradient with the kernels against the plain versions;
    bf16 within 5e-2 of each leaf's largest |gradient| (the key bias's,
    a sum of position gradients that nearly cancel, against wk's scale:
    chip_smoke.py's TRAIN_GRAD_TOL), f32 within 1e-3."""
    from repro_torch import configs
    spec = configs.get("glm4-9b")
    cfg = tfm.LMConfig("narrow", n_layer=2, d_model=256, n_head=32, n_kv=2,
                       d_ff=512, vocab=1000, d_head=128, qkv_bias=True,
                       dtype=dtype)
    model = tfm.init_params(cfg, torch.Generator(device=cuda).manual_seed(1),
                            device=cuda)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 97)).astype(
        np.int32), device=cuda)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    before = (segment_matmul.matmul.launches,
              flash_attention.flash_attention_bwd.launches)
    loss, grads = _loss_and_grads(spec, cfg, model, batch)
    L = cfg.n_layer
    assert segment_matmul.matmul.launches - before[0] == 28 * L + 3
    assert flash_attention.flash_attention_bwd.launches - before[1] == L
    want_loss, want = _loss_and_grads(spec, cfg, model, batch, plain=True)
    share = 5e-2 if dtype == torch.bfloat16 else 1e-3
    assert abs(loss - want_loss) <= share * abs(want_loss)
    for name, g in grads.items():
        scale_of = name.replace(".bk", ".wk") if name.endswith(".bk") else name
        scale = float(want[scale_of].float().abs().max())
        assert float((g.float() - want[name].float()).abs().max()) <= \
            share * scale, name


def test_sage_train_gradients_match_plain_versions_on_card(cuda):
    """GraphSAGE's loss and gradients with the kernels against the plain
    versions, f32 within 1e-4 of each leaf's largest |gradient|. The plain
    run multiplies each relu input by the kernel run's mask, so that a
    pre-activation within the f32 rounding of 0 cannot take the other
    sign there and move a gradient by a whole term (chip_smoke.py's
    ReluPattern)."""
    from repro_torch import configs
    spec = configs.get("graphsage-reddit")
    cfg = configs.cell_model_cfg(spec, "minibatch_lg", smoke=False)
    model = gnn.init_params(cfg, torch.Generator(device=cuda).manual_seed(2),
                            device=cuda)
    src, dst = gs.random_powerlaw_graph(3_000, 8, seed=3)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(3_000, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, 3_000).astype(np.int32)
    b = gs.sample_subgraph_batch(gs.CSRGraph(3_000, src, dst), feats, labels,
                                 rng.choice(3_000, 300, replace=False),
                                 (5, 5), rng)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in b.items()}
    before = (segment_matmul.segment_sum.launches,
              segment_matmul.segment_gather.launches,
              segment_matmul.matmul.launches)
    masks, relu = [], torch.relu

    def record(x):
        masks.append(x.detach() > 0)
        return relu(x)

    loss, grads = _loss_and_grads(spec, cfg, model, batch, relu=record)
    assert (segment_matmul.segment_sum.launches - before[0],
            segment_matmul.segment_gather.launches - before[1],
            segment_matmul.matmul.launches - before[2]) == (5, 1, 13)
    kept = iter(masks)
    want_loss, want = _loss_and_grads(spec, cfg, model, batch, plain=True,
                                      relu=lambda x: x * next(kept))
    assert next(kept, None) is None
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for name, g in grads.items():
        w = want[name]
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


@pytest.mark.parametrize("arch", ["glm4-9b", "graphsage-reddit"])
def test_train_cli_replays_an_injected_failure_on_card(cuda, arch, tmp_path):
    from repro_torch.launch import train
    base = ["--arch", arch, "--smoke", "--steps", "6", "--log-every", "100"]
    clean = train.main(base)
    losses = train.main(base + ["--ckpt-dir", str(tmp_path), "--ckpt-every",
                                "2", "--inject-failure", "3"])
    assert len(losses) == 7 and all(np.isfinite(losses))
    if arch == "glm4-9b":          # B5 and B6 and their gradients: no atomics
        assert losses == clean[:3] + clean[2:]
    else:                          # B4's float atomics reorder its sums
        np.testing.assert_allclose(losses, clean[:3] + clean[2:], rtol=1e-5)


# -- the MoE layer (slice 15) ---------------------------------------------------

class _Routes:
    """``transformer.route`` recorded on one run and replayed on another:
    the plain run routes every token as the kernel run did (the f32 router
    products of B5 and of the plain version sum in other orders, so a
    near-tie could flip)."""

    def __init__(self):
        self.kept, self.next = [], 0
        self._route = tfm.route

    def record(self, probs, k):
        out = self._route(probs, k)
        self.kept.append(out)
        return out

    def replay(self, probs, k):
        out = self.kept[self.next]
        self.next += 1
        return out


def _moe_on_card_and_plain(cfg, x, grads: bool = False):
    """(kernel output, plain output, B5 launches) of ``moe_ffn`` over the
    first layer's MoE of a model drawn from a seed, the plain run
    replaying the kernel run's routes."""
    from unittest import mock
    model = tfm.init_params(cfg, torch.Generator(device=x.device).manual_seed(
        3), device=x.device)
    p = model.layers[0].moe
    routes = _Routes()
    before = segment_matmul.matmul.launches
    with mock.patch.object(tfm, "route", routes.record), torch.no_grad():
        got, aux = tfm.moe_ffn(p, cfg, x)
    launches = segment_matmul.matmul.launches - before
    with mock.patch.object(tfm, "route", routes.replay), \
            mock.patch.object(ops, "matmul", ref.matmul), torch.no_grad():
        want, want_aux = tfm.moe_ffn(p, cfg, x)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
    return got, want, launches


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_moe_layer_on_card_matches_plain_version(cuda, arch, dtype):
    """The smoke config's MoE layer over 2 x 96 tokens on the card (B5 for
    the router, 3 launches per expert, the shared experts' 2 per expert
    and 1) against the plain versions, routes replayed: bf16 within 3e-2
    of max|out|, f32 within 1e-4."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(arch).smoke_cfg, dtype=dtype)
    m = cfg.moe
    x = torch.randn(2, 96, cfg.d_model,
                    generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda).to(dtype)
    got, want, launches = _moe_on_card_and_plain(cfg, x)
    G, _ = tfm.capacity(m, 192)
    assert launches == G * (1 + 3 * m.e_total) + (
        2 * m.n_shared + 1 if m.n_shared else 0)
    share = 3e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((got.float() - want.float()).abs().max()) <= \
        share * float(want.float().abs().max())


def test_moe_layer_on_card_at_full_width(cuda):
    """qwen2-moe-a2.7b's MoE layer at full width (d 2,048, 60 experts of
    1,408, 4 shared) over 1,024 tokens in bf16: the experts' products on
    B5's wgmma route at C = 96, the router's on the f32 route, against the
    plain versions with the routes replayed, within 3e-2 of max|out|."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("qwen2-moe-a2.7b").model_cfg,
                              n_layer=1)
    x = torch.randn(1, 1024, cfg.d_model,
                    generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).bfloat16()
    segment_matmul.reset_counts()
    got, want, launches = _moe_on_card_and_plain(cfg, x)
    assert tfm.capacity(cfg.moe, 1024) == (1, 96)
    assert launches == 1 + 3 * 60 + 2 * 4 + 1
    assert segment_matmul.matmul.routes["f32"] == 1
    assert segment_matmul.matmul.routes["wgmma"] == 3 * 60 + 2 * 4 + 1
    assert float((got.float() - want.float()).abs().max()) <= \
        3e-2 * float(want.float().abs().max())


def test_moe_layer_on_card_is_bitwise_reproducible(cuda):
    """Two runs of a MoE layer's forward and backward on the card (bf16,
    capacity 0.5 so that assignments drop) give the same bits: the
    dispatch and the combine use no float atomics, nor their gradients."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("qwen2-moe-a2.7b").smoke_cfg,
                              moe=tfm.MoEConfig(n_experts=6, top_k=2,
                                                d_ff_expert=32, n_shared=1,
                                                capacity_factor=0.5))
    model = tfm.init_params(cfg, torch.Generator(device=cuda).manual_seed(6),
                            device=cuda)
    p = model.layers[0].moe
    params = dict(p.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    x0 = torch.randn(4, 256, cfg.d_model,
                     generator=torch.Generator(device=cuda).manual_seed(7),
                     device=cuda).bfloat16()
    runs = []
    for _ in range(2):
        x = x0.clone().requires_grad_(True)
        out, aux = tfm.moe_ffn(p, cfg, x)
        loss = out.float().square().mean() + aux
        runs.append([out, aux] + list(torch.autograd.grad(
            loss, [x] + list(params.values()))))
    # 1,024 x 2 / 6 x 0.5 = 171 rows an expert, rounded up to 192: about
    # 341 assignments an expert, so many are dropped
    assert tfm.capacity(cfg.moe, 1024) == (1, 192)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# -- second derivatives through B4 and B5, NequIP and MACE, the
# -- row limit of B5's f32 and masked routes, routing ties ----------------

def _hvp(f, xs, plain):
    """The gradient of sum(|grad f|^2) over ``xs`` (a second derivative),
    with the kernels or, with ``plain``, the plain versions."""
    import contextlib
    with contextlib.ExitStack() as stack:
        if plain:
            for patch in _plain_ops():
                stack.enter_context(patch)
        gs_ = torch.autograd.grad(f(*xs), xs, create_graph=True)
        return gs_, torch.autograd.grad(sum((g ** 2).sum() for g in gs_), xs)


def test_double_backward_through_b4_and_b5_on_card(cuda):
    """A second derivative through B5 (product), B4 (sum) and the gather:
    the first gradient taken with ``create_graph`` carries the port's
    Function nodes on the card, the second backward launches B5, B4 and
    B4's gather again, and both match the plain versions (f32, 1e-4 of
    each result's largest |value|)."""
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn(40, 24, generator=g, device=cuda, requires_grad=True)
    w = torch.randn(24, 16, generator=g, device=cuda, requires_grad=True)
    idx = torch.randint(0, 40, (300,), generator=g, device=cuda,
                        dtype=torch.int32)

    def f(x, w):
        rows = ops.gather_rows(x, idx)
        return ops.segment_sum(ops.matmul(rows, w).tanh(), idx, 40
                               ).pow(2).sum()

    before = (segment_matmul.matmul.launches,
              segment_matmul.segment_sum.launches,
              segment_matmul.segment_gather.launches)
    (gx, gw), (hx, hw) = _hvp(f, (x, w), plain=False)
    torch.cuda.synchronize()
    assert type(gw.grad_fn).__name__ == "_MatMulBackward"
    after = (segment_matmul.matmul.launches,
             segment_matmul.segment_sum.launches,
             segment_matmul.segment_gather.launches)
    # forward 1 + 1 + 0, first backward 2 + 1 + 1, second more of each
    assert all(a - b > n for a, b, n in zip(after, before, (3, 2, 1)))
    (px, pw), (qx, qw) = _hvp(f, (x, w), plain=True)
    for got, want in ((gx, px), (gw, pw), (hx, qx), (hw, qw)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale


def test_plans_serve_every_gradient_on_card(cuda):
    """A plan handed to segment_sum and gather_rows serves the forward, the
    first backward (the sum's gather, the gather's sum) and the second: no
    plan is built after it, the kernels launch as often as with the id
    vector (whose every B4 call builds a plan), and every result is
    bit-equal (the sums' order depends on the ids alone); both match the
    plain versions (f32, 1e-4 of each result's largest |value|)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(50, 24, generator=g, device=cuda, requires_grad=True)
    w = torch.randn(24, 16, generator=g, device=cuda, requires_grad=True)
    idx = torch.randint(0, 50, (400,), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[:40] = 7                                    # a hub over 2 tiles

    def f(ids):
        def fn(x, w):
            rows = ops.gather_rows(x, ids)
            return ops.segment_sum(ops.matmul(rows, w).tanh(), ids,
                                   50).pow(2).sum()
        return fn

    def counts():
        return np.array([segment_matmul.matmul.launches,
                         segment_matmul.segment_sum.launches,
                         segment_matmul.segment_gather.launches,
                         segment_matmul.segment_plan.builds])

    plan = ops.segment_plan(idx, 50)
    c0 = counts()
    (gx, gw), (hx, hw) = _hvp(f(plan), (x, w), plain=False)
    torch.cuda.synchronize()
    c1 = counts()
    (ax, aw), (bx, bw) = _hvp(f(idx), (x, w), plain=False)
    torch.cuda.synchronize()
    c2 = counts()
    assert c1[3] == c0[3] and (c1 - c0)[:3].tolist() == (c2 - c1)[:3].tolist()
    assert c2[3] - c1[3] == c2[1] - c1[1] > 2
    for got, want in ((gx, ax), (gw, aw), (hx, bx), (hw, bw)):
        assert torch.equal(got, want)
    (px, pw), (qx, qw) = _hvp(f(plan), (x, w), plain=True)
    for got, want in ((gx, px), (gw, pw), (hx, qx), (hw, qw)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale


def _geo_on_card(arch, cuda, n_layers=1, seed=0):
    from repro_torch import configs
    spec = configs.get(arch)
    cfg = dataclasses.replace(configs.cell_model_cfg(spec, "molecule",
                                                     smoke=True),
                              n_layers=n_layers)
    model = gnn.init_params(cfg, torch.Generator(device=cuda).manual_seed(
        seed), device=cuda)
    rng = np.random.default_rng(seed)
    n, G, e = 40, 4, 96
    pos = rng.uniform(0, 2.5, (n, 3)) + 10.0 * np.repeat(np.arange(G),
                                                          n // G)[:, None]
    gid = np.repeat(np.arange(G), n // G)
    src, dst = [], []
    for k in range(G):
        a = rng.integers(0, n // G, (e // G, 2))
        a = a[a[:, 0] != a[:, 1]] + k * (n // G)
        src.append(a[:, 0])
        dst.append(a[:, 1])
    src = np.concatenate(src + [np.zeros(8, int)])
    dst = np.concatenate(dst + [np.zeros(8, int)])
    mask = (np.arange(src.shape[0]) < src.shape[0] - 8).astype(np.float32)
    b = {"node_feat": np.eye(cfg.d_species, dtype=np.float32)[
             rng.integers(0, cfg.d_species, n)],
         "pos": pos.astype(np.float32), "src": src.astype(np.int32),
         "dst": dst.astype(np.int32), "edge_mask": mask,
         "graph_id": gid.astype(np.int32),
         "energy_target": rng.normal(size=G).astype(np.float32),
         "force_target": rng.normal(size=(n, 3)).astype(np.float32)}
    return spec, cfg, model, {k: torch.as_tensor(v, device=cuda)
                              for k, v in b.items()}


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_one_layer_geo_loss_gradients_match_plain_versions_on_card(cuda,
                                                                   arch):
    """A one-layer NequIP or MACE at the smoke widths on the card: the
    loss, every gradient and the force term's gradient alone with the
    kernels against the plain versions (f32, 1e-4 of each leaf's largest
    |gradient|; the plain run replays the kernel run's relu masks)."""
    spec, cfg, model, batch = _geo_on_card(arch, cuda)
    masks, relu = [], torch.relu

    def record(x):
        masks.append(x.detach() > 0)
        return relu(x)

    gather = segment_matmul.segment_gather.launches
    loss, grads = _loss_and_grads(spec, cfg, model, batch, relu=record)
    # the force term's gradient runs B4's gather as well as B4
    assert segment_matmul.segment_gather.launches > gather
    kept = iter(masks)
    want_loss, want = _loss_and_grads(spec, cfg, model, batch, plain=True,
                                      relu=lambda x: x * next(kept))
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        assert float((g - want[name]).abs().max()) <= 1e-4 * max(
            scale, 1e-30), name
    # the force loss alone: its gradient exists only through the second
    # derivative, so a dropped one shows here
    params = dict(model.named_parameters())

    def f_grads(plain):
        import contextlib
        with contextlib.ExitStack() as stack:
            if plain:
                for patch in _plain_ops():
                    stack.enter_context(patch)
            f = gnn.geo_loss_terms(model, batch)[1]
            return torch.autograd.grad(f, list(params.values()),
                                       allow_unused=True,
                                       materialize_grads=True)
    for name, g, w in zip(params, f_grads(False), f_grads(True)):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * max(scale, 1e-30), name
    assert max(float(w.abs().max()) for w in f_grads(False)) > 0


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_kernel_forces_are_equivariant(cuda, arch):
    """Energies and forces with the kernels: a rotated copy of the
    positions gives the same energies (1e-4) and rotated forces (1e-3),
    tests/test_models.py's tolerances."""
    _, cfg, model, batch = _geo_on_card(arch, cuda, n_layers=2, seed=3)
    th = 0.9
    R = torch.tensor([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1.0]],
                     dtype=torch.float32, device=cuda)
    e1, f1 = gnn.energy_and_forces(model, batch)
    e2, f2 = gnn.energy_and_forces(model, dict(batch, pos=batch["pos"] @ R.T))
    torch.testing.assert_close(e1, e2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(f1 @ R.T, f2, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype,K,N", [(torch.float32, 16, 16),
                                       (torch.bfloat16, 12, 20)],
                         ids=["f32", "masked"])
def test_matmul_rows_beyond_the_old_grid_limit(cuda, dtype, K, N):
    """B5's f32 and masked routes at 8,400,000 rows (past 65,535 row
    tiles of 128, the old grid's y limit): against ``ref.matmul``, the
    last rows too."""
    M = 8_400_000
    assert M > 65_535 * 128
    g = torch.Generator(device=cuda).manual_seed(22)
    a = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    b = torch.randn(K, N, generator=g, device=cuda).to(dtype)
    route = segment_matmul.plan(M, N, K, dtype).route
    assert route == ("f32" if dtype == torch.float32 else "masked")
    got = segment_matmul.matmul(a, b)
    want = ref.matmul(a, b)
    tol = 1e-4 * want.abs() + 1e-6 * K
    assert bool(((got - want).abs() <= tol).all())
    assert float(got[-1000:].abs().sum()) > 0


def test_route_breaks_ties_on_card(cuda):
    """Routing ties on the card: exact ties among router probabilities
    keep the lower index first (numpy's stable descending order, the
    order ``jax.lax.top_k`` gives)."""
    rng = np.random.default_rng(5)
    T, E = 4096, 60
    p = rng.random((T, E)).astype(np.float32)
    p[:, [10, 40, 50, 55, 59]] = 0.9
    p[: T // 4, 20:30] = p[: T // 4, [1]]
    p /= p.sum(-1, keepdims=True)
    for k in (1, 4, 8):
        got = tfm.route(torch.as_tensor(p, device=cuda), k).cpu().numpy()
        want = np.argsort(-p, axis=-1, kind="stable")[:, :k]
        np.testing.assert_array_equal(got, want)


def test_segment_sum_kernel_with_far_more_segments_than_rows(cuda):
    """MIND's table gradient in small: many more segments than rows
    (2,000,000 against 200,000, nearly all empty), one hub on 60% of the
    rows spanning hundreds of level-0 tiles. Integer rows equal the plain
    version exactly; N(0, 1) rows equal the kernel's mirror and a second
    call bit for bit (the hub's 120,000 N(0, 1) rows sum to a few hundred,
    within f32's rounding in any order but not within 1e-4 of the plain
    version's order, as ``segment_operands`` says of its hubs)."""
    E, d, S = 200_000, 64, 2_000_000
    ints, ids = segment_operands(E, d, S, "hubs")
    ints, ids = torch.as_tensor(ints, device=cuda), torch.as_tensor(
        ids, device=cuda)
    tile, fans = segment_matmul.segment_tiles(E, d)
    assert int((ids == S // 2).sum()) >= 100 * tile
    plan = ops.segment_plan(ids, S)
    before = segment_matmul.segment_sum.launches
    assert torch.equal(segment_matmul.segment_sum(ints, plan, S),
                       ref.segment_sum(ints, ids, S))
    vals = torch.randn(E, d, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(64))
    got = segment_matmul.segment_sum(vals, plan, S)
    again = segment_matmul.segment_sum(vals, plan, S)
    torch.cuda.synchronize()
    assert segment_matmul.segment_sum.launches == before + 3
    assert torch.equal(got, again)
    assert torch.equal(got, ref.segment_sum_tiled(vals, plan, tile, fans))


@pytest.mark.parametrize("M,K,N", [(64, 3_276_800, 64),      # MIND's dS
                                   (602, 169_984, 128),      # SAGE's dW
                                   (40, 100_003, 200), (7, 9_000, 30)])
def test_matmul_f32_split_k_matches_plain_version(cuda, M, K, N):
    """B5's f32 route with K split (an output of fewer tiles than SMs, a
    long K): one counted launch on the f32 route against ``ref.matmul``,
    and two calls bit-equal (the partials are added in a fixed order)."""
    p = segment_matmul.plan(M, N, K, torch.float32)
    assert p.route == "f32" and p.splits > 1
    gen = torch.Generator(device=cuda).manual_seed(M + N)
    a = torch.randn(M, K, generator=gen, device=cuda)
    b = torch.randn(K, N, generator=gen, device=cuda)
    before = segment_matmul.matmul.routes["f32"]
    got = ops.matmul(a, b)
    again = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert segment_matmul.matmul.routes["f32"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.matmul(a, b), rtol=1e-4,
                               atol=1e-6 * K)


#: (B5, of them B5's gradient products, B4, B4 plans) of one MIND serve
#: call, retrieval call and train step (chip_smoke.py's MIND_LAUNCHES)
MIND_CALLS = {"serve": (1, 0, 0, 0), "retrieval": (2, 0, 0, 0),
              "train": (6, 4, 1, 1)}


def _mind_counts():
    return (segment_matmul.matmul.launches,
            segment_matmul.matmul_grads.launches,
            segment_matmul.segment_sum.launches,
            segment_matmul.segment_plan.builds)


def test_mind_serve_and_train_step_on_card_match_plain_versions(cuda):
    """The smoke MIND on the card through make_serve_step and
    make_train_step: launches exact per call, scores within 1e-5 and the
    loss and both gradients within 1e-4 of their scale against the plain
    versions, two identical train steps bit-equal."""
    import contextlib
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    spec = configs.get("mind")
    cfg = spec.smoke_cfg
    model = configs.init_params(spec, cfg, torch.Generator(cuda).manual_seed(
        5), device=cuda)
    b = train.make_batch_fn(spec, cfg, dict(kind="train", batch=6),
                            device=cuda)(0)
    rng = np.random.default_rng(5)
    cands = {"serve_p99": torch.as_tensor(rng.integers(
        -2, cfg.n_items + 3, (6, 16)).astype(np.int32), device=cuda),
        "retrieval_cand": torch.arange(-4, cfg.n_items + 9,
                                       dtype=torch.int32, device=cuda)}
    for shape, kind in (("serve_p99", "serve"),
                        ("retrieval_cand", "retrieval")):
        batch = {"hist_ids": b["hist_ids"], "hist_mask": b["hist_mask"],
                 "cand_ids": cands[shape]}
        if kind == "retrieval":
            batch = dict(batch, hist_ids=b["hist_ids"][:1],
                         hist_mask=b["hist_mask"][:1])
        step = configs.make_serve_step(spec, shape, cfg)
        before = _mind_counts()
        got = step(model, batch)
        torch.cuda.synchronize()
        assert tuple(x - y for x, y in zip(_mind_counts(), before)) == \
            MIND_CALLS[kind], kind
        with contextlib.ExitStack() as stack:
            for patch in _plain_ops():
                stack.enter_context(patch)
            want = step(model, batch)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        torch.testing.assert_close(got[ok], want[ok], rtol=1e-5, atol=1e-5)
    before = _mind_counts()
    loss, grads = _loss_and_grads(spec, cfg, model, b)
    assert tuple(x - y for x, y in zip(_mind_counts(), before)) == \
        MIND_CALLS["train"]
    _, again = _loss_and_grads(spec, cfg, model, b)
    want_loss, want = _loss_and_grads(spec, cfg, model, b, plain=True)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for name, g in grads.items():
        assert torch.equal(g, again[name]), name
        scale = float(want[name].abs().max())
        assert float((g - want[name]).abs().max()) <= 1e-4 * scale, name
    assert isinstance(model, recsys.MIND)
    opt = adamw.init_state(dict(model.named_parameters()))
    before = _mind_counts()
    _, _, m = configs.make_train_step(spec, cfg)(model, opt, b)
    assert tuple(x - y for x, y in zip(_mind_counts(), before)) == \
        MIND_CALLS["train"]
    assert bool(torch.isfinite(m["loss"]))


# ----------------------------------------------------------------------
# the runtime on the card's one-rank NCCL mesh
# ----------------------------------------------------------------------

def test_vp_take_on_card_matches_plain_version(cuda):
    """The vocab-parallel lookup over the card's (1, 1) NCCL mesh: rows
    equal to the plain versions' and to ``ops.take`` for ids in range,
    zero rows for ids n, -1 and -n-1; the table's gradient one B4 launch,
    bit-equal to ``ops.take``'s and within 1e-4 of the plain versions';
    the exchanges counted."""
    import contextlib
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.runtime import sharding as shd
    n, d = 1 << 16, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    table = torch.randn(n, d, generator=gen, device=cuda)
    ids = torch.randint(0, n, (512, 51), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = torch.randn(512, 51, d, generator=gen, device=cuda)
    take = shd.make_vp_take(make_smoke_mesh("cuda"), leading=("data",))

    def rows_and_grad(fn, plain=False):
        t = table.clone().requires_grad_(True)
        with contextlib.ExitStack() as stack:
            if plain:
                for patch in _plain_ops():
                    stack.enter_context(patch)
            rows = fn(t, ids)
            (g,) = torch.autograd.grad((rows * w).sum(), t)
        return rows.detach(), g

    shd.reset_collectives()
    before = segment_matmul.segment_sum.launches
    rows, g = rows_and_grad(take)
    torch.cuda.synchronize()
    assert segment_matmul.segment_sum.launches - before == 1
    assert shd.collective_counts()["all-reduce"]["calls"] == 3
    rows_t, g_t = rows_and_grad(ops.take)
    assert torch.equal(rows, rows_t) and torch.equal(g, g_t)
    rows_p, g_p = rows_and_grad(take, plain=True)
    assert torch.equal(rows, rows_p)
    assert float((g - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())
    bad = torch.tensor([n, -1, -n - 1, 5], dtype=torch.int32, device=cuda)
    out = take(table, bad)
    assert not out[:3].any() and torch.equal(out[3], table[5])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_a2a_moe_on_card_matches_plain_version(cuda, dtype):
    """The a2a MoE over the card's (1, 1) NCCL mesh, qwen2-moe's smoke
    layer over 2 x 96 tokens: against its plain versions with the routes
    replayed (bf16 within 3e-2 of max|out|, f32 1e-4); B5 launched once
    for the router and three times per expert, as ``moe_ffn``; with a
    capacity that does not bind, equal to ``moe_ffn`` within the same
    bound."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.moe_a2a import make_a2a_moe
    cfg = dataclasses.replace(configs.get("qwen2-moe-a2.7b").smoke_cfg,
                              dtype=dtype)
    m = cfg.moe
    x = torch.randn(2, 96, cfg.d_model,
                    generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda).to(dtype)
    share = 3e-2 if dtype == torch.bfloat16 else 1e-4
    tfm.set_moe_impl(make_a2a_moe(make_smoke_mesh("cuda"), ("data",)))
    try:
        shd.reset_collectives()
        got, want, launches = _moe_on_card_and_plain(cfg, x)
        assert shd.collective_counts()["all-to-all"]["calls"] == 4
    finally:
        tfm.set_moe_impl(None)
    assert launches == 1 + 3 * m.e_total + 2 * m.n_shared + 1
    assert float((got.float() - want.float()).abs().max()) <= \
        share * float(want.float().abs().max())
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=8.0))
    tfm.set_moe_impl(make_a2a_moe(make_smoke_mesh("cuda"), ("data",)))
    try:
        a2a, _, _ = _moe_on_card_and_plain(wide, x)
    finally:
        tfm.set_moe_impl(None)
    ffn, _, _ = _moe_on_card_and_plain(wide, x)
    assert float((a2a.float() - ffn.float()).abs().max()) <= \
        share * float(ffn.float().abs().max())


def test_cuda_tensors_never_take_plain_versions(cuda):
    """With every plain version made to raise, B5, B4, B4's gather and B6
    still run on CUDA tensors (they launch); meta tensors take the plain
    versions and launch nothing."""
    from unittest import mock

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor took a plain version")
    patches = [mock.patch.object(ref, name, boom) for name in
               ("matmul", "segment_sum", "segment_gather", "flash_attention")]
    a = torch.randn(64, 32, device=cuda)
    ids = torch.randint(0, 7, (64,), device=cuda, dtype=torch.int32)
    q = torch.randn(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    before = (segment_matmul.matmul.launches,
              segment_matmul.segment_sum.launches,
              segment_matmul.segment_gather.launches,
              flash_attention.flash_attention.launches)
    for p in patches:
        p.start()
    try:
        segment_matmul.matmul(a, a.t().contiguous())
        segment_matmul.segment_sum(a, ids, 7)
        segment_matmul.segment_gather(a[:7].contiguous(), ids)
        flash_attention.flash_attention(q, q, q, causal=True)
        torch.cuda.synchronize()
    finally:
        for p in patches:
            p.stop()
    after = (segment_matmul.matmul.launches,
             segment_matmul.segment_sum.launches,
             segment_matmul.segment_gather.launches,
             flash_attention.flash_attention.launches)
    assert all(x - y == 1 for x, y in zip(after, before))
    meta = segment_matmul.matmul(a.to("meta"), a.t().contiguous().to("meta"))
    assert meta.device.type == "meta"
    assert segment_matmul.matmul.launches == after[0]


# ---------------------------------------------------------------------------
# the kernel contracts, armed on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def armed(monkeypatch):
    """A kernel witness of the test's own, armed."""
    from repro_torch.kernels import contracts
    w = contracts.KernelWitness()
    monkeypatch.setenv("REPRO_KERNEL_WITNESS", "1")
    monkeypatch.setattr(contracts, "WITNESS", w)
    return w


def card_contract_calls(dev) -> dict:
    """name -> (route, a call of that contract on the card) at small
    shapes: every contract, B5 on its wgmma, skinny and f32 routes, B6
    on wgmma and split, B6's backward on wgmma."""
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = dict(dtype=torch.bfloat16, device=dev)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def i32(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    B, N = 4, 300
    lab = torch.arange(B * N, dtype=torch.int32, device=dev).reshape(B, N) % N
    link = torch.randint(-1, N, (B, N), generator=gen, device=dev,
                         dtype=torch.int32)
    act = torch.ones((B, N), dtype=torch.bool, device=dev)
    g = gen_temporal_graph(n=60, m=400, t_max=16, seed=3)
    src, dst = (torch.as_tensor(a, device=dev) for a in (g.src, g.dst))
    alive = torch.ones(g.m, dtype=torch.bool, device=dev)
    deg = kcore_peel.degree_count(src, dst, alive, g.n)
    q, kv = randn(1, 256, 4, 128), randn(1, 256, 2, 128)
    o, lse = flash_attention.flash_attention(q, kv, kv, causal=True,
                                             return_lse=True)
    vals = torch.randn((500, 128), generator=gen, device=dev)
    ids = torch.randint(-1, 70, (500,), generator=gen, device=dev,
                        dtype=torch.int32)
    return {
        "label_prop_round": lambda: label_prop.label_prop_round(
            lab, link, link, link, act, changed=flag),
        "segmented_count_le": lambda: segmented_select.segmented_count_le(
            i32(1, 2, 3), i32(0, 0, 1), i32(2, 2), 2),
        "kth_smallest": lambda: segmented_select.kth_smallest(
            i32(1, 2, 3), i32(0, 0, 1), 2, 1, 9),
        "stratum_sweep": lambda: segmented_select.stratum_sweep(
            i32(1, 1, 1, 1).reshape(1, 4), i32(0, 0, 1, 1), i32(0, 2, 4),
            i32(1, 1, 0, 0), i32(1),
            torch.zeros((1, 2), dtype=torch.int32, device=dev), 5),
        "degree_count": lambda: kcore_peel.degree_count(src, dst, alive,
                                                        g.n),
        "peel_threshold": lambda: kcore_peel.peel_threshold(
            src, dst, alive, deg, 3, changed=flag),
        "kcore_fixpoint": lambda: kcore_peel.kcore_fixpoint(src, dst, g.n, 3),
        "matmul wgmma": lambda: segment_matmul.matmul(randn(256, 128),
                                                      randn(128, 256)),
        "matmul skinny": lambda: segment_matmul.matmul(randn(16, 128),
                                                       randn(128, 256)),
        "matmul f32": lambda: segment_matmul.matmul(
            randn(300, 64, dtype=torch.float32),
            randn(64, 96, dtype=torch.float32)),
        "wgmma_probe": lambda: segment_matmul.wgmma_probe(
            randn(64, 16), randn(16, 128)),
        "segment_sum": lambda: segment_matmul.segment_sum(vals, ids, 70),
        "segment_gather": lambda: segment_matmul.segment_gather(
            vals[:70].contiguous(), ids),
        "flash_attention wgmma": lambda: flash_attention.flash_attention(
            q, kv, kv, causal=True),
        "flash_attention split": lambda: flash_attention.flash_attention(
            randn(2, 1, 8, 128), randn(2, 512, 2, 128),
            randn(2, 512, 2, 128), t_real=500),
        "flash_attention_bwd": lambda: flash_attention.flash_attention_bwd(
            q, kv, kv, o, torch.ones_like(o), causal=True, lse=lse),
        "rs_probe": lambda: flash_attention.rs_probe(
            randn(64, 128), randn(128, 128), randn(128, 128)),
    }


CARD_CONTRACT_CALLS = (
    "label_prop_round", "segmented_count_le", "kth_smallest",
    "stratum_sweep", "degree_count", "peel_threshold", "kcore_fixpoint",
    "matmul wgmma", "matmul skinny", "matmul f32", "wgmma_probe",
    "segment_sum", "segment_gather", "flash_attention wgmma",
    "flash_attention split", "flash_attention_bwd", "rs_probe")


@pytest.mark.parametrize("call", CARD_CONTRACT_CALLS)
def test_armed_contract_call_on_card(cuda, armed, call):
    """Each contract armed on the card: one call recorded, no problem, its
    declared shared memory within the card's 232,448 bytes a block (and
    the route's, where a route is named)."""
    from repro_torch.kernels import contracts
    calls = card_contract_calls(cuda)
    armed.reset()
    out = calls[call]()
    torch.cuda.synchronize()
    name = call.split()[0]
    rep = armed.report()
    assert rep["problems"] == []
    assert rep["kernels"][name]["calls"] >= 1
    smem = rep["kernels"][name]["max_smem"]
    assert smem is None or smem <= contracts.SMEM_PER_BLOCK
    if " " in call:
        route = call.split()[1]
        fn = getattr(segment_matmul if name == "matmul" else flash_attention,
                     name)
        assert fn.routes[route] >= 1
    assert out is not None


def test_witness_records_a_wrong_operand_on_card(cuda, armed):
    """A (B, N + 1) ``active`` on the card: the armed witness records the
    conflict, then B1's own check raises, and nothing launches."""
    B, N = 4, 100
    labels = torch.zeros((B, N), dtype=torch.int32, device=cuda)
    links = [torch.full((B, N), -1, dtype=torch.int32, device=cuda)
             for _ in range(3)]
    active = torch.ones((B, N + 1), dtype=torch.bool, device=cuda)
    before = label_prop.label_prop_round.launches
    with pytest.raises(ValueError):
        label_prop.label_prop_round(
            labels, *links, active,
            changed=torch.zeros(1, dtype=torch.int32, device=cuda))
    (p,) = armed.problems()
    assert p["kind"] == "shape-contract" and "active" in p["message"]
    assert label_prop.label_prop_round.launches == before


def card_shards(cuda) -> list:
    """Every visible card once, or ``cuda:0`` twice on a one-card
    machine."""
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [torch.device("cuda", 0)] * 2)


def test_sharded_executor_over_cards_equals_one_card(cuda):
    """The executor over every visible card (or two shards on cuda:0):
    every run's masks bit-equal to one card's, B1's launches equal to the
    rounds of every shard, each replica equal to ``to_device`` there."""
    from repro_torch.serving import executor
    g = gen_temporal_graph(n=40, m=420, t_max=18, seed=31)
    sx = build_stratified_index(g, device=cuda)
    shards = card_shards(cuda)
    one = executor.ShardedExecutor(devices=shards[:1])
    ex = executor.ShardedExecutor(devices=shards)
    dix = bq.to_device(sx, shards[0])
    reps = bq.replicas_of(dix, shards)
    for r in reps:
        fresh = bq.to_device(sx, r.device)
        for f in bq._ARRAY_FIELDS:
            assert torch.equal(getattr(r, f), getattr(fresh, f)), f
    qs = random_queries(g, 64, seed=4)
    ks = [sx.supported_ks[i % len(sx.supported_ks)] for i in range(64)]
    slot = bq.mixed_slots(sx, [(q[0], k) for q, k in zip(qs, ks)])
    ts, te = [q[1] for q in qs], [q[2] for q in qs]
    bucket = ex.final_bucket(64, 8, 256)
    b1 = label_prop.label_prop_round.launches
    stats = {}
    got = ex.run(reps, slot, ts, te, bucket, stats=stats)
    assert label_prop.label_prop_round.launches - b1 == sum(stats["rounds"])
    assert np.array_equal(got, one.run(dix, slot, ts, te,
                                       one.final_bucket(64, 8, 256)))
    v, m = ex.run_full_mixed(reps, slot, ts, te, ks, bucket)
    v1, m1 = one.run_full_mixed(dix, slot, ts, te, ks,
                                one.final_bucket(64, 8, 256))
    assert np.array_equal(v, v1) and np.array_equal(m, m1)
    k = sx.ks[0]
    sreps = tuple(bq.stratum_device(r, sx, k) for r in reps)
    sw = ex.run_sweep(sreps, 3, ts, te, bucket)
    assert np.array_equal(sw, one.run_sweep(sreps[0], 3, ts, te,
                                            one.final_bucket(64, 8, 256)))
    for i, (q, kk) in enumerate(zip(qs, ks)):
        assert set(np.flatnonzero(got[i]).tolist()) == kcore.tccs_oracle(
            g, kk, *q)


def test_sharded_engine_over_cards_equals_algorithm_1(cuda):
    """``ServingEngine(devices=...)`` over every visible card: cold build,
    an ingest and a trim, each handle's replicas equal to ``to_device``,
    every answer equal to Algorithm 1, ``stats()["devices"]`` the shard
    count."""
    g = gen_temporal_graph(n=40, m=420, t_max=18, seed=31)
    g0, suffix = g.split_at(15)
    shards = card_shards(cuda)
    cfg = EngineConfig(max_batch=64, flush_ms=500.0, host_threshold=0,
                       cache_capacity=0)
    with ServingEngine(cfg, devices=shards) as eng:
        assert eng.stats()["devices"] == len(shards)
        eng.register_graph("g", g0)
        h = eng.warmup("g", full=True)
        for step in ("build", "ingest", "trim"):
            if step == "ingest":
                h = eng.ingest("g", [tuple(e) for e in suffix.tolist()],
                               wait=True, timeout=120)["g"].result()
            elif step == "trim":
                h = eng.retain("g", 5, wait=True, timeout=120)["g"].result()
            assert len(h.replicas) == len(shards)
            for r, d in zip(h.replicas, shards):
                fresh = bq.to_device(h.pecb, d)
                for f in bq._ARRAY_FIELDS:
                    got = getattr(r, f)
                    assert got.device == d and torch.equal(got,
                                                           getattr(fresh, f))
            rng = np.random.default_rng(len(step))
            specs = [TCCSQuery(u, ts, te, int(rng.choice(h.supported_ks)))
                     for (u, ts, te) in random_queries(h.graph, 48, seed=5)]
            futs = eng.submit_specs("g", specs)
            eng.flush()
            for q, f in zip(specs, futs):
                assert set(f.result(timeout=120).vertices) == \
                    kcore.tccs_oracle(h.graph, q.k, q.u, q.ts, q.te)


def test_wgmma_routes_on_a_second_card(cuda):
    """B5, B6 and B6's backward on their wgmma routes, launched on cuda:0
    and then on cuda:1 in one process: the dynamic shared-memory opt-in is
    made per device, so the second card's launches succeed and agree with
    the plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the opt-in is per device")
    M = N = K = 1024
    B, S, H, dh = 1, 1024, 4, 128
    assert segment_matmul.plan(M, N, K).route == "wgmma"
    assert flash_attention.plan(B, S, H, H, S, True, dh).route == "wgmma"
    assert flash_attention.bwd_plan(B, S, H, H, S, True, dh).route == "wgmma"
    for i in (0, 1):
        dev = torch.device("cuda", i)
        gen = torch.Generator(device=dev).manual_seed(43)
        a, b = (torch.randn(M, K, generator=gen, device=dev).bfloat16(),
                torch.randn(K, N, generator=gen, device=dev).bfloat16())
        got, want = segment_matmul.matmul(a, b), ref.matmul(a, b)
        assert bool(((got - want).abs()
                     <= 1e-4 * want.abs() + 1e-6 * K).all())
        q, k, v, do = (torch.randn(B, S, H, dh, generator=gen, device=dev)
                       .bfloat16() for _ in range(4))
        o, lse = flash_attention.flash_attention(q, k, v, causal=True,
                                                 return_lse=True)
        want = ref.flash_attention(q, k, v, causal=True)
        assert bool(((o.float() - want.float()).abs()
                     <= flash_attention.error_bound(want)).all())
        got = flash_attention.flash_attention_bwd(q, k, v, o, do,
                                                  causal=True, lse=lse)
        want = ref.flash_attention_bwd(q, k, v, o, do, causal=True)
        scales = ref.flash_attention_bwd_scales(q, k, v, o, do, causal=True)
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            bound = flash_attention.bwd_error_bound(w, *scales[name])
            assert bool(((x.float() - w.float()).abs() <= bound).all()), name


def test_mind_mesh_one_rank_steps_bit_equal_on_card(cuda):
    """MIND's partition on the card's one-rank NCCL mesh: the smoke model
    placed as drawn (``init_params(mesh=)``), serve_p99, retrieval and one
    train step through ``make_serve_step(mesh=)`` and
    ``make_train_step(mesh=)`` bit-equal to the unsharded ones (scores,
    loss, norm, lr, S, item_embed, both moments), with the launches of
    MIND_CALLS and no collective."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    spec = configs.get("mind")
    cfg = spec.smoke_cfg
    mesh = make_smoke_mesh("cuda")
    a = configs.init_params(spec, cfg, torch.Generator(cuda).manual_seed(5),
                            device=cuda)
    b = configs.init_params(spec, cfg, torch.Generator(cuda).manual_seed(5),
                            device=cuda, mesh=mesh)
    batch = train.make_batch_fn(spec, cfg, dict(kind="train", batch=16),
                                device=cuda)(0)
    rng = np.random.default_rng(6)
    serve = {"hist_ids": batch["hist_ids"], "hist_mask": batch["hist_mask"],
             "cand_ids": torch.as_tensor(rng.integers(
                 0, cfg.n_items, (16, 16)).astype(np.int32), device=cuda)}
    ret = {"hist_ids": batch["hist_ids"][:1],
           "hist_mask": batch["hist_mask"][:1],
           "cand_ids": torch.arange(cfg.n_items, dtype=torch.int32,
                                    device=cuda)}
    shd.reset_collectives()
    for shape, kind, req in (("serve_p99", "serve", serve),
                             ("retrieval_cand", "retrieval", ret)):
        want = configs.make_serve_step(spec, shape, cfg)(a, req)
        before = _mind_counts()
        got = configs.make_serve_step(spec, shape, cfg, mesh=mesh)(b, req)
        torch.cuda.synchronize()
        assert tuple(x - y for x, y in zip(_mind_counts(), before)) == \
            MIND_CALLS[kind], kind
        assert torch.equal(got, want), shape
    sa = adamw.init_state(dict(a.named_parameters()))
    sb = adamw.init_state(dict(b.named_parameters()))
    _, sa, ma = configs.make_train_step(spec, cfg)(a, sa, batch)
    before = _mind_counts()
    _, sb, mb = configs.make_train_step(spec, cfg, mesh=mesh)(b, sb, batch)
    torch.cuda.synchronize()
    assert tuple(x - y for x, y in zip(_mind_counts(), before)) == \
        MIND_CALLS["train"]
    assert shd.collective_counts() == {}
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), n
        assert torch.equal(sa["mu"][n], sb["mu"][n]), n
        assert torch.equal(sa["nu"][n], sb["nu"][n]), n


@pytest.mark.parametrize("arch", ["glm4-9b", "codeqwen1.5-7b"])
def test_mesh_one_rank_step_and_prefill_bit_equal_on_card(cuda, arch):
    """The partitioner on the card's one-rank NCCL mesh: the smoke model
    placed as drawn, its prefill and one train step (remat on) bit-equal
    to the unsharded ones, through B5, B6 and their gradients."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import adamw
    spec = configs.get(arch)
    cfg = dataclasses.replace(spec.smoke_cfg, remat=True)
    mesh = make_smoke_mesh("cuda")
    a = tfm.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                        device=cuda)
    b = tfm.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                        device=cuda, mesh=mesh)
    toks = torch.randint(0, cfg.vocab, (2, 65), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    assert torch.equal(
        configs.make_serve_step(spec, "prefill_32k", cfg)(a, batch),
        configs.make_serve_step(spec, "prefill_32k", cfg, mesh=mesh)(
            b, batch))
    sa = adamw.init_state(dict(a.named_parameters()))
    sb = adamw.init_state(dict(b.named_parameters()))
    before = segment_matmul.matmul.launches
    _, sa, ma = configs.make_train_step(spec, cfg)(a, sa, batch)
    _, sb, mb = configs.make_train_step(spec, cfg, mesh=mesh)(b, sb, batch)
    assert segment_matmul.matmul.launches > before
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    for n in sa["mu"]:
        assert torch.equal(sa["mu"][n], sb["mu"][n])
        assert torch.equal(sa["nu"][n], sb["nu"][n])
