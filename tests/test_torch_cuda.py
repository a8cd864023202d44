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
                                             gen_temporal_graph,
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
