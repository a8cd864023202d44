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
from repro_torch.core.pecb_index import build_stratified_index  # noqa: E402
from repro_torch.core.temporal_graph import (gen_temporal_graph,  # noqa: E402
                                             random_queries)
from repro_torch.kernels import label_prop, ref  # noqa: E402

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
