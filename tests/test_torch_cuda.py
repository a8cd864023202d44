"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips on a machine
without an NVIDIA card (a CUDA kernel has no CPU mode). The file imports
neither JAX nor the reference package, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Outputs are integer and boolean: the tolerance is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core import core_time, kcore  # noqa: E402
from repro_torch.core.pecb_index import build_stratified_index  # noqa: E402
from repro_torch.core.temporal_graph import (gen_temporal_graph,  # noqa: E402
                                             random_queries)
from repro_torch.kernels import (kcore_peel, label_prop, ops,  # noqa: E402
                                 ref, segmented_select)

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


def test_device_engine_strata_on_card_equal_host_engine(cuda):
    g = gen_temporal_graph(n=40, m=420, t_max=18, seed=31)
    before = segmented_select.segmented_count_le.launches
    stats = {}
    dev = core_time.stratified_core_times(g, device=cuda, stats=stats)
    launched = segmented_select.segmented_count_le.launches - before
    assert launched == stats["iterations"] + \
        segmented_select.bisection_steps(g.t_max + 1) * stats["climbs"]
    host = core_time.stratified_core_times(g, device="cpu")
    assert dev.ks == host.ks
    for f in ("kptr", "edge_id", "ts_from", "ts_to", "ct", "vptr",
              "v_ts_from", "v_ts_to", "v_ct"):
        assert np.array_equal(getattr(dev, f), getattr(host, f)), f


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
