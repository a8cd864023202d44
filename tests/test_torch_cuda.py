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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core import core_time, kcore  # noqa: E402
from repro_torch.core.pecb_index import build_stratified_index  # noqa: E402
from repro_torch.core.temporal_graph import (gen_temporal_graph,  # noqa: E402
                                             random_queries)
from repro_torch.kernels import (flash_attention, kcore_peel,  # noqa: E402
                                 label_prop, ops, ref, segment_matmul,
                                 segmented_select)
from repro_torch.data import graph_sampler as gs  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

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


@pytest.mark.parametrize("M,K,N", [(64, 64, 64), (200, 300, 150),
                                   (128, 256, 384), (33, 65, 17), (1, 8, 8),
                                   (16, 4096, 4096), (16, 13696, 4096),
                                   (64, 4096, 256), (65, 1000, 1000),
                                   (512, 4096, 13696), (4096, 4096, 256),
                                   (300, 136, 20)])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_matmul_kernel_matches_plain_version(cuda, M, K, N, dtype):
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = torch.randn(M, K, generator=gen, device=cuda).to(dt)
    b = torch.randn(K, N, generator=gen, device=cuda).to(dt)
    before = segment_matmul.matmul.launches
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert segment_matmul.matmul.launches == before + 1
    want = ref.matmul(a, b)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * K)


def test_matmul_kernel_masks_unaligned_operands(cuda):
    """Operands whose rows are not 16-byte multiples take the masked
    element-wise loads; a view that is not contiguous raises."""
    base = torch.randn(70, 131, device=cuda).bfloat16()
    a, b = base[:33, 1:66].contiguous(), base[3:68, 2:19].contiguous()
    torch.testing.assert_close(ops.matmul(a, b), ref.matmul(a, b),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        ops.matmul(base[:, :65], base[:65, :3])
    with pytest.raises(TypeError):
        ops.matmul(a, b.float())


@pytest.mark.parametrize("B,S,T,H,Hkv,t_real,causal", [
    (2, 64, 64, 4, 4, None, True), (1, 70, 70, 8, 2, None, True),
    (2, 128, 256, 4, 1, None, False), (1, 40, 24, 4, 2, None, True),
    (2, 24, 40, 6, 3, 30, True), (1, 300, 300, 32, 2, None, True),
    (16, 1, 1000, 32, 2, None, False), (16, 1, 1000, 32, 2, 1, False),
    (16, 1, 1000, 32, 2, 65, False), (3, 1, 777, 32, 32, 500, False),
    (2, 1, 96, 8, 2, 37, True), (1, 2, 129, 16, 2, 100, False),
    (4, 1, 5000, 16, 1, 4097, False)])
def test_flash_attention_kernel_matches_plain_version(cuda, B, S, T, H, Hkv,
                                                      t_real, causal):
    gen = torch.Generator(device=cuda).manual_seed(S * T + H)
    q = torch.randn(B, S, H, 128, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(B, T, Hkv, 128, generator=gen, device=cuda)
            .bfloat16() for _ in range(2))
    if t_real is not None:                 # keys past t_real are never read
        k[:, t_real:], v[:, t_real:] = float("nan"), float("nan")
    before = flash_attention.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, t_real=t_real)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= flash_attention.error_bound(want)).all()), \
        float(diff.max())


def test_flash_attention_kernel_refuses_other_shapes(cuda):
    q = torch.zeros(1, 4, 4, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # dh != 128
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 4, 128, device=cuda)
    with pytest.raises(TypeError):                   # f32
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
