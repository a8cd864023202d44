"""The GraphSAGE slice (sampler copy, config, model, weight carry, serve
step) against the JAX reference, with the reference's weights carried by
``gnn_params_from_reference``: at the smoke config on a random graph,
with and without an edge mask, and at graphsage-reddit's full width on a
sampled minibatch of a small power-law pool.

Tolerance: rtol = atol = 1e-4, the reference's own f32 tolerance for the
segment sum (tests/test_kernels.py::TestSegmentSum): the port sums the
same f32 rows and products in another order."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.data import graph_sampler as jax_gs  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.carry import gnn_params_from_reference  # noqa: E402
from repro_torch.data import graph_sampler as gs  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

ARCH = "graphsage-reddit"
TOL = 1e-4


def models(smoke: bool, shape: str = "minibatch_lg", seed: int = 0):
    """(jax cfg, jax params, port cfg, port model) with the same weights."""
    jspec, spec = jax_configs.get(ARCH), configs.get(ARCH)
    jcfg = jax_configs.cell_model_cfg(jspec, shape, smoke=smoke)
    cfg = configs.cell_model_cfg(spec, shape, smoke=smoke)
    params = jax_gnn.sage_init(jcfg, jax.random.PRNGKey(seed))
    model = gnn.GraphSAGE(cfg, device="cpu")
    model.load_state_dict(gnn_params_from_reference(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, cfg, model


def both_steps(batch: dict, smoke: bool):
    """The reference's and the port's serve-step logits on one batch of
    numpy arrays, and the port's B4/B5 launches meanwhile (0 on the CPU)."""
    jcfg, params, cfg, model = models(smoke)
    jstep = jax_configs.make_serve_step(jax_configs.get(ARCH), "minibatch_lg",
                                        jcfg)
    want = np.asarray(jstep(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}))
    step = configs.make_serve_step(configs.get(ARCH), "minibatch_lg", cfg)
    before = (sm.segment_sum.launches, sm.matmul.launches)
    got = step(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    launched = (sm.segment_sum.launches - before[0],
                sm.matmul.launches - before[1])
    return got.numpy(), want, launched


def random_batch(n=24, e=48, d=8, masked=True, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"node_feat": rng.normal(size=(n, d)).astype(np.float32),
             "src": rng.integers(0, n, e).astype(np.int32),
             "dst": rng.integers(0, n, e).astype(np.int32)}
    if masked:
        batch["edge_mask"] = (rng.random(e) < 0.75).astype(np.float32)
    return batch


def pool(n=3_000, avg_deg=16, d=602, classes=41, seed=5):
    """A small power-law pool: (port CSR, reference CSR, feats, labels)."""
    src, dst = gs.random_powerlaw_graph(n, avg_deg, seed=seed)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    return (gs.CSRGraph(n, src, dst), jax_gs.CSRGraph(n, src, dst), feats,
            labels)


@pytest.mark.parametrize("n,avg_deg,seed", [(500, 6, 0), (3_000, 16, 5)])
def test_pool_generator_and_csr_match_reference(n, avg_deg, seed):
    got = gs.random_powerlaw_graph(n, avg_deg, seed=seed)
    want = jax_gs.random_powerlaw_graph(n, avg_deg, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    g, jg = gs.CSRGraph(n, *got), jax_gs.CSRGraph(n, *want)
    assert np.array_equal(g.ptr, jg.ptr) and np.array_equal(g.col, jg.col)
    assert g.col.dtype == jg.col.dtype and g.ptr.dtype == jg.ptr.dtype


@pytest.mark.parametrize("pad", [None, (4_096, 8_192)])
@pytest.mark.parametrize("fanout", [(15, 10), (5,)])
def test_sampler_matches_reference(fanout, pad):
    g, jg, feats, labels = pool()
    seeds = np.random.default_rng(2).choice(g.n, 64, replace=False)
    pads = {} if pad is None else dict(pad_nodes=pad[0], pad_edges=pad[1])
    got = gs.sample_subgraph_batch(g, feats, labels, seeds, fanout,
                                   np.random.default_rng(9), **pads)
    want = jax_gs.sample_subgraph_batch(jg, feats, labels, seeds, fanout,
                                        np.random.default_rng(9), **pads)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_sampler_refuses_a_small_pad_budget():
    g, _, feats, labels = pool(n=500, avg_deg=6)
    with pytest.raises(ValueError, match="pad budget"):
        gs.sample_subgraph_batch(g, feats, labels, np.arange(32), (15, 10),
                                 np.random.default_rng(0), pad_nodes=40)


@pytest.mark.parametrize("masked", [True, False])
def test_smoke_forward_matches_reference(masked):
    got, want, launched = both_steps(random_batch(masked=masked), smoke=True)
    assert got.shape == want.shape == (24, 5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert launched == (0, 0)                           # CPU: no launch


@pytest.mark.parametrize("masked", [True, False])
def test_full_width_forward_on_a_sampled_batch_matches_reference(masked):
    """graphsage-reddit at full width (602 -> 128 -> 128, 41 classes) on a
    (15, 10) sample of 64 seeds from a 3,000-node pool, padded as the
    sampler pads (padding edges point at node 0 with mask 0)."""
    g, _, feats, labels = pool()
    seeds = np.random.default_rng(3).choice(g.n, 64, replace=False)
    batch = gs.sample_subgraph_batch(g, feats, labels, seeds, (15, 10),
                                     np.random.default_rng(4))
    assert batch["edge_mask"].min() == 0.0               # padding present
    feed = {k: batch[k] for k in ("node_feat", "src", "dst")}
    if masked:
        feed["edge_mask"] = batch["edge_mask"]
    got, want, _ = both_steps(feed, smoke=False)
    assert got.shape == want.shape == (batch["node_feat"].shape[0], 41)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    seeds_at = batch["seed_mask"]
    assert (got[seeds_at].argmax(-1) == want[seeds_at].argmax(-1)).all()


def test_layer_pieces_match_reference():
    """``segment_mean`` and one masked ``sage_layer`` against the
    reference's arithmetic, step by step."""
    b = random_batch(n=30, e=90, d=8)
    vals = b["node_feat"][b["src"]]
    np.testing.assert_allclose(
        gnn.segment_mean(torch.as_tensor(vals), torch.as_tensor(b["dst"]),
                         30).numpy(),
        np.asarray(jax_gnn.segment_mean(jnp.asarray(vals),
                                        jnp.asarray(b["dst"]), 30)),
        rtol=TOL, atol=TOL)
    jcfg, params, _, model = models(smoke=True)
    one = dataclasses.replace(jcfg, n_layers=1)
    jparams = {"layers": params["layers"][:1],
               "head": jnp.eye(jcfg.d_hidden)}
    want = np.asarray(jax_gnn.sage_forward(
        jparams, one, {k: jnp.asarray(v) for k, v in b.items()}))
    got = gnn.sage_layer(model.layers[0], *(torch.as_tensor(b[k]) for k in (
        "node_feat", "src", "dst", "edge_mask")))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_registry_resolves_minibatch_lg_to_the_published_widths():
    spec, jspec = configs.get(ARCH), jax_configs.get(ARCH)
    cfg = configs.cell_model_cfg(spec, "minibatch_lg")
    assert (cfg.d_in, cfg.d_hidden, cfg.n_layers, cfg.n_classes) == (
        602, 128, 2, 41)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_configs.cell_model_cfg(jspec, "minibatch_lg"))
    assert spec.family == "gnn" and spec.source == jspec.source
    assert configs.GNN_SHAPES == jax_configs.base.GNN_SHAPES
    assert cfg.param_count == 192_384
    model = gnn.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count
    assert not model.layers[1].b.any()
    w = model.layers[0].w_self
    assert float(w.std()) == pytest.approx(602 ** -0.5, rel=0.02)


@pytest.mark.parametrize("shape", sorted(configs.GNN_SHAPES))
def test_model_flops_match_reference(shape):
    got = configs.model_flops(configs.get(ARCH), shape)
    want = jax_configs.model_flops(jax_configs.get(ARCH), shape)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("shape", sorted(configs.GNN_SHAPES))
def test_cell_model_cfg_and_model_flops_take_the_reference_arguments(
        shape, smoke):
    """``cell_model_cfg(smoke=)`` (a smoke GNN takes ``d_feat`` 8) and
    ``model_flops(model_cfg=)`` return the reference's values."""
    spec, jspec = configs.get(ARCH), jax_configs.get(ARCH)
    cfg = configs.cell_model_cfg(spec, shape, smoke=smoke)
    jcfg = jax_configs.cell_model_cfg(jspec, shape, smoke=smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.d_in == (8 if smoke else configs.GNN_SHAPES[shape]["d_feat"])
    got = configs.model_flops(spec, shape, model_cfg=cfg)
    want = jax_configs.model_flops(jspec, shape, model_cfg=jcfg)
    assert got == pytest.approx(want, rel=1e-12)


def test_minibatch_lg_forward_counts_65_gflop():
    dims = dict(configs.GNN_SHAPES["minibatch_lg"], kind="serve")
    flops = configs.model_flops(configs.get(ARCH), "minibatch_lg", dims=dims)
    assert flops == pytest.approx(65.31e9, rel=1e-3)


def test_other_gnn_families_raise():
    """A gnn spec whose config is a type the port does not know (the
    reference's own MeshGraphNet config class, not the port's): nothing
    of the port takes it."""
    spec = configs.ArchSpec(id="meshgraphnet", family="gnn",
                            model_cfg=jax_gnn.MGNConfig(),
                            smoke_cfg=jax_gnn.MGNConfig(),
                            shapes=configs.GNN_SHAPES, skips={})
    for fn in (configs.cell_model_cfg, configs.make_serve_step,
               configs.model_flops):
        with pytest.raises(NotImplementedError, match="A8"):
            fn(spec, "molecule")


def test_serve_step_refuses_a_model_of_another_config():
    spec = configs.get(ARCH)
    step = configs.make_serve_step(spec, "minibatch_lg")
    other = gnn.GraphSAGE(dataclasses.replace(spec.smoke_cfg, d_in=8),
                          device="cpu")
    with pytest.raises(ValueError):
        step(other, {k: torch.as_tensor(v) for k, v in random_batch().items()})


def test_carry_names_every_parameter():
    _, params, cfg, _ = models(smoke=False)
    state = gnn_params_from_reference(jax.tree.map(np.asarray, params))
    assert set(state) == set(gnn.GraphSAGE(cfg, device="meta").state_dict())
    assert all(t.dtype == torch.float32 for t in state.values())
    assert np.array_equal(state["layers.1.w_neigh"].numpy(),
                          np.asarray(params["layers"][1]["w_neigh"]))
