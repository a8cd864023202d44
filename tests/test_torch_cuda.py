"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips on a machine
without an NVIDIA card (a CUDA kernel has no CPU mode). The file imports
neither JAX nor the reference package, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer and boolean outputs must match exactly. B5's f32 outputs sum the
same exact products in another order (rtol 1e-4, atol 1e-6 * K); B4's
add the same f32 rows in an order its atomics change from run to run
(rtol = atol = 1e-4, tests/test_kernels.py's segment-sum tolerance); B6's
bf16 outputs are held to ``flash_attention.error_bound``, as in
chip_smoke.py: 2e-2 of |plain| for the outputs' bf16 roundings plus 1e-2
of the largest |plain| in the element's row for the kernel's bf16 P."""

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
    values on unsorted ids with 10% -1 and 5% >= S."""
    rng = np.random.default_rng(seed + E + d + S)
    vals = rng.normal(size=(E, d)).astype(np.float32)
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
@pytest.mark.parametrize("kind", ["runs", "integer_runs", "random"])
def test_segment_sum_kernel_matches_plain_version(cuda, E, d, S, kind):
    vals, ids = segment_operands(E, d, S, kind)
    vals, ids = torch.as_tensor(vals, device=cuda), torch.as_tensor(
        ids, device=cuda)
    before = segment_matmul.segment_sum.launches
    got = ops.segment_sum(vals, ids, S)
    torch.cuda.synchronize()
    assert segment_matmul.segment_sum.launches == before + (E * d * S > 0)
    want = ref.segment_sum(vals, ids, S)
    assert got.dtype == torch.float32 and got.shape == (S, d)
    if kind == "integer_runs":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


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
                              lambda x, idx: x[idx.long()]))


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
        grads = torch.autograd.grad(loss, list(params.values()))
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
