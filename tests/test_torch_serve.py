"""The port's serving entry point and one-GPU executor, run on the CPU.

``serve_graph`` on fb_like must answer with 0 mismatches against
Algorithm 1 in every mode; the executor's bucketing and padding mirror
tests/test_serving.py, and its masks equal the reference executor's on
the same padded batch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batch_query as jax_bq  # noqa: E402
from repro.core.pecb_index import \
    build_stratified_index as jax_build  # noqa: E402
from repro.serving.executor import ShardedExecutor  # noqa: E402
from repro_torch.core import batch_query as bq  # noqa: E402
from repro_torch.core.pecb_index import build_stratified_index  # noqa: E402
from repro_torch.core.query_api import (InvalidQueryError,  # noqa: E402
                                        ResultMode, TCCSQuery)
from repro_torch.core.temporal_graph import (bench_graph,  # noqa: E402
                                             gen_temporal_graph,
                                             random_queries)
from repro_torch.kernels import label_prop  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import executor  # noqa: E402


@pytest.fixture(scope="module")
def fb_like():
    g = bench_graph("fb_like")
    sx = build_stratified_index(g, device="cpu")
    return g, sx, bq.to_device(sx, "cpu")


@pytest.mark.parametrize("mode", ["vertices", "edges", "count"])
def test_serve_graph_fb_like_has_no_mismatch(fb_like, mode):
    g, sx, dix = fb_like
    before = label_prop.label_prop_round.launches
    out = serve.serve_graph(g, n_queries=20, batch=8, mode=mode, verify=20,
                            device="cpu", index=sx, dix=dix, seed=3)
    assert out["mismatches"] == 0 and out["checked"] == 20
    assert len(out["rounds"]) == 3 == len(out["batch_s"])  # 8 + 8 + 4
    # CPU tensors launch no kernel
    assert label_prop.label_prop_round.launches == before
    res = out["results"]
    assert all(r.provenance.route == "device" for r in res)
    assert [r.provenance.bucket for r in res[-4:]] == [8] * 4
    if mode == "edges":
        assert all(r.edges is not None for r in res)
    if mode == "count":
        assert all(r.vertices == frozenset() for r in res)


def test_serve_sweep_matches_algorithm_1(fb_like):
    g, sx, dix = fb_like
    windows = [(d, min(d + 30, g.t_max)) for d in range(1, 20)]
    out = serve.serve_sweep(sx, dix, 0, sx.ks[1], windows)
    assert out["mismatches"] == 0 and out["largest"] > 0


def test_answer_batch_host_answers_trivial_specs(fb_like):
    g, sx, dix = fb_like
    specs = [TCCSQuery(3, 5, 4, 2),                       # ts > te
             TCCSQuery(3, 1, 10, sx.k_max_graph + 5),     # above k-max
             TCCSQuery(3, 1, g.t_max, 2),                 # device lane
             TCCSQuery(3, -5, 10**6, 3, ResultMode.EDGES)]
    with pytest.raises(InvalidQueryError):
        serve.answer_batch(sx, dix, specs[:1])
    res = serve.answer_batch(sx, dix, specs[1:])
    assert res[0].vertices == frozenset()
    assert res[0].provenance.route == "trivial"
    assert res[1].provenance.route == "device"
    assert res[1].vertices == frozenset(
        sx.slice_k(2)._component_vertices(3, 1, g.t_max))
    assert res[2].query.ts == 1 and res[2].query.te == g.t_max  # clamped
    want = sx.slice_k(3)._component_vertices(3, 1, g.t_max)
    assert res[2].vertices == frozenset(want)
    assert res[2].edges.edge_ids() == sx.slice_k(3).versions.member_edges(
        want, 1, g.t_max).edge_ids()


def test_cli_runs_on_cpu(capsys):
    qps = serve.main(["--workload", "fb_like", "--queries", "12",
                      "--batch", "8", "--device", "cpu", "--verify", "12"])
    assert qps > 0
    assert "12 queries checked against Algorithm 1, 0 mismatches" in \
        capsys.readouterr().out


class TestExecutor:
    def test_bucket_size(self):
        assert executor.bucket_size(1) == 8
        assert executor.bucket_size(8) == 8
        assert executor.bucket_size(9) == 16
        assert executor.bucket_size(100) == 128
        assert executor.bucket_size(200, max_batch=256) == 256
        assert executor.bucket_size(255, min_bucket=8, max_batch=256) == 256
        assert executor.bucket_size(3, min_bucket=4, max_batch=16) == 4
        assert executor.ShardedExecutor("cpu").final_bucket(13, 8, 64) == 16
        with pytest.raises(ValueError):
            executor.bucket_size(0)
        with pytest.raises(ValueError):
            executor.bucket_size(300)

    def test_pad_queries_inert(self):
        u, ts, te = executor.pad_queries([5, 6], [2, 3], [7, 8], 8)
        assert u.shape == ts.shape == te.shape == (8,)
        assert u.dtype == np.int32
        assert list(u[:2]) == [5, 6]
        assert (te[2:] < ts[2:]).all()           # pad windows are empty
        assert executor.PAD_QUERY == (0, 1, 0)
        with pytest.raises(ValueError, match="exceeds bucket"):
            executor.pad_queries([1] * 9, [1] * 9, [2] * 9, 8)

    def test_padded_runs_match_reference_executor(self):
        g = gen_temporal_graph(n=30, m=200, t_max=12, seed=33)
        sx, jsx = build_stratified_index(g, device="cpu"), jax_build(g)
        dix, jdix = bq.to_device(sx, "cpu"), jax_bq.to_device(jsx)
        qs = random_queries(g, 5, seed=1)
        ks = [sx.ks[i % len(sx.ks)] for i in range(5)]
        slot = bq.mixed_slots(sx, [(u, k) for (u, _, _), k in zip(qs, ks)])
        ts = [q[1] for q in qs]
        te = [q[2] for q in qs]
        ref = ShardedExecutor()
        port = executor.ShardedExecutor("cpu")
        bucket = port.final_bucket(5, 8, 64)
        assert bucket == ref.final_bucket(5, 8, 64) == 8
        got = port.run(dix, slot, ts, te, bucket)
        assert got.shape == (5, g.n)
        assert np.array_equal(got, ref.run(jdix, slot, ts, te, bucket))
        vm, ver = port.run_full_mixed(dix, slot, ts, te, ks, bucket)
        jvm, jver = ref.run_full_mixed(jdix, slot, ts, te, ks, bucket)
        assert np.array_equal(vm, jvm) and np.array_equal(ver, jver)
        assert ver.shape == (5, dix.num_versions)
        sd = bq.stratum_device(dix, sx, sx.ks[0])
        jsd = jax_bq.stratum_device(jdix, jsx, sx.ks[0])
        sw = port.run_sweep(sd, 2, ts, te, bucket)
        assert np.array_equal(sw, ref.run_sweep(jsd, 2, ts, te, bucket))
