"""NequIP and MACE in the port against the JAX reference, and the second
derivatives they need: energies, node features, forces (``-dE/dpos``
against ``-jax.grad``), the loss and every gradient of it (the force
term's too, which differentiates a gradient), at the smoke configs with
and without an edge mask, NequIP with ``bf16_state`` too; the reference's
equivariance test; the AdamW state carry (the launcher's CLI:
tests/test_torch_mgn.py; the kernels' own second derivatives:
tests/test_torch_double_backward.py).
Inputs are drawn with numpy from a seed; the weights
are the reference's ``nequip_init``/``mace_init``'s, carried by
``gnn_params_from_reference``; the reference runs under ``jax.jit``.

Tolerance: f32, 1e-4 of each output's or gradient leaf's largest |value|
(sums re-associated; the rule of tests/test_torch_gnn.py); the rotated
energies within 1e-4 and forces within 1e-3, the reference's own
(tests/test_models.py). With ``bf16_state`` the node features are rounded
to bf16 between layers in both packages and the forward agrees as in f32;
the derivatives (forces and parameter gradients) do not: jax scatters the
bf16 features' cotangents in bf16 where the port sums them in f32 (B4)
and rounds once, so they are held to 1e-2 of their scale, bf16's
resolution (2^-8 = 3.9e-3) over a few roundings."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.carry import (adamw_state_from_reference,  # noqa: E402
                                    gnn_params_from_reference,
                                    lm_params_from_reference)
from repro_torch.models import gnn  # noqa: E402

TOL = 1e-4
BF16_GRAD_TOL = 1e-2
CASES = {"nequip": ("nequip", {}), "nequip-bf16": ("nequip",
                                                   dict(bf16_state=True)),
         "mace": ("mace", {})}
N_GRAPHS, ATOMS, EDGES, PAD = 3, 10, 24, 8


def close(got, want, share=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= share, f"{what}: {err:.3e} of max|want|"


def models(case, seed=0):
    """(jax spec, jax cfg, jax params, port spec, port model) of a case,
    at the smoke config on the molecule shape, the reference's weights."""
    arch, over = CASES[case]
    jspec, spec = jax_configs.get(arch), configs.get(arch)
    jcfg = dataclasses.replace(jax_configs.cell_model_cfg(
        jspec, "molecule", smoke=True), **over)
    cfg = dataclasses.replace(configs.cell_model_cfg(
        spec, "molecule", smoke=True), **over)
    params = jax_base.init_params(jspec, jcfg, jax.random.PRNGKey(seed))
    model = gnn.GeoModel(cfg, device="cpu")
    model.load_state_dict(gnn_params_from_reference(
        jax.tree.map(np.asarray, params)))
    return jspec, jcfg, params, spec, model


def molecules(d_species, masked=True, seed=1):
    """N_GRAPHS molecules of ATOMS atoms, each in a box of its own, with
    EDGES random directed pairs inside each molecule (all within the 5.0
    cutoff) and, masked, PAD padding edges at node 0 (r = 0, edge_mask
    0); one-hot species; energy and force targets from the seed."""
    rng = np.random.default_rng(seed)
    n = N_GRAPHS * ATOMS
    pos = rng.uniform(0.0, 2.5, (n, 3)) + 10.0 * np.repeat(
        np.arange(N_GRAPHS), ATOMS)[:, None]
    src, dst = [], []
    for g in range(N_GRAPHS):
        a = rng.integers(0, ATOMS, (EDGES, 2))
        a = a[a[:, 0] != a[:, 1]] + g * ATOMS
        src.append(a[:, 0])
        dst.append(a[:, 1])
    src, dst = np.concatenate(src), np.concatenate(dst)
    mask = np.ones(src.shape[0], np.float32)
    if masked:
        src = np.concatenate([src, np.zeros(PAD, int)])
        dst = np.concatenate([dst, np.zeros(PAD, int)])
        mask = np.concatenate([mask, np.zeros(PAD, np.float32)])
    b = {"node_feat": np.eye(d_species, dtype=np.float32)[
             rng.integers(0, d_species, n)],
         "pos": pos.astype(np.float32),
         "src": src.astype(np.int32), "dst": dst.astype(np.int32),
         "graph_id": np.repeat(np.arange(N_GRAPHS), ATOMS).astype(np.int32),
         "energy_target": rng.normal(size=N_GRAPHS).astype(np.float32),
         "force_target": rng.normal(size=(n, 3)).astype(np.float32)}
    if masked:
        b["edge_mask"] = mask
    r = np.linalg.norm(pos[src] - pos[dst], axis=-1)
    assert r[mask > 0].max() < 5.0 and r[mask > 0].min() > 0.01
    return b


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def jax_forces(fwd, params, jcfg, b):
    def energy(pos):
        e, _ = fwd(params, jcfg, {**b, "pos": pos})
        return jnp.sum(e)
    return -jax.grad(energy)(b["pos"])


def params_grads(model, loss_fn, batch):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    for p in params.values():
        p.requires_grad_(False)
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_energies_features_and_forces_match(case, masked):
    jspec, jcfg, params, spec, model = models(case)
    b = molecules(model.cfg.d_species, masked)
    jfwd = jax_base._GNN_FWD[type(jcfg)]
    want_e, want_svt = jax.jit(jax_base.make_serve_step(
        jspec, "molecule", jcfg))(params, as_jax(b))
    got_e, got_svt = configs.make_serve_step(spec, "molecule", model.cfg)(
        model, as_torch(b))
    close(got_e.numpy(), want_e, what="energy")
    for name, g, w in zip("sVT", got_svt, want_svt):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        close(g.float().numpy(), np.asarray(w, np.float32), what=name)
    want_f = jax.jit(lambda p, bb: jax_forces(jfwd, p, jcfg, bb))(
        params, as_jax(b))
    e, f = gnn.energy_and_forces(model, as_torch(b))
    close(e.detach().numpy(), want_e, what="energy with autograd")
    close(f.numpy(), want_f, what="forces",
          share=BF16_GRAD_TOL if model.cfg.bf16_state else TOL)
    if masked:                                   # the r = 0 padding edges
        assert bool(torch.isfinite(f).all())


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_match_jax_grad(case, masked):
    """The loss (energy + 10 x force terms) and the gradient of every
    parameter, which differentiates the forces once more."""
    jspec, jcfg, params, spec, model = models(case)
    b = molecules(model.cfg.d_species, masked)
    lval, jgrads = jax.jit(jax.value_and_grad(jax_base.loss_for(
        jspec, jcfg)))(params, as_jax(b))
    loss, grads = params_grads(model, configs.loss_for(spec, model.cfg),
                               as_torch(b))
    assert loss == pytest.approx(float(lval), rel=1e-5)
    want = gnn_params_from_reference(jax.tree.map(np.asarray, jgrads))
    assert want.keys() == grads.keys()
    share = BF16_GRAD_TOL if model.cfg.bf16_state else TOL
    for name, g in grads.items():
        close(g.numpy(), want[name].numpy(), share=share, what=name)


@pytest.mark.parametrize("case", ["nequip", "mace"])
def test_force_loss_gradient_alone_matches(case):
    """The gradient of the force term alone (10 x f_loss), which exists
    only through the second derivative, against jax.grad of the same."""
    jspec, jcfg, params, spec, model = models(case)
    b = molecules(model.cfg.d_species)
    jfwd = jax_base._GNN_FWD[type(jcfg)]

    def f_loss(p, bb):
        f = jax_forces(jfwd, p, jcfg, bb)
        return 10.0 * jnp.mean((f - bb["force_target"]) ** 2)

    lval, jgrads = jax.jit(jax.value_and_grad(f_loss))(params, as_jax(b))
    loss, grads = params_grads(
        model, lambda m, bb: 10.0 * gnn.geo_loss_terms(m, bb)[1],
        as_torch(b))
    assert loss == pytest.approx(float(lval), rel=1e-5)
    want = gnn_params_from_reference(jax.tree.map(np.asarray, jgrads))
    nonzero = 0
    for name, g in grads.items():
        if float(np.abs(want[name].numpy()).max()) == 0.0:
            assert float(g.abs().max()) == 0.0, name
            continue
        nonzero += 1
        close(g.numpy(), want[name].numpy(), what=name)
    assert nonzero >= len(grads) // 2


@pytest.mark.parametrize("case", ["nequip", "mace"])
def test_energy_invariance_force_equivariance(case):
    """tests/test_models.py's equivariance test on the port: a rotated
    copy of the positions gives the same energies (1e-4) and rotated
    forces (1e-3)."""
    *_, model = models(case)
    b = molecules(model.cfg.d_species)
    th = 0.9
    R = np.asarray([[np.cos(th), -np.sin(th), 0],
                    [np.sin(th), np.cos(th), 0], [0, 0, 1.0]], np.float32)
    e1, f1 = gnn.energy_and_forces(model, as_torch(b))
    e2, f2 = gnn.energy_and_forces(
        model, as_torch(dict(b, pos=(b["pos"] @ R.T).astype(np.float32))))
    np.testing.assert_allclose(e1.detach().numpy(), e2.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f1.numpy() @ R.T, f2.numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("case", ["nequip", "mace"])
def test_adamw_state_carries_geometric_trees(case):
    """NequIP's and MACE's trees have an ``embed`` MLP; their AdamW state
    carries under the model's names, not an LM's."""
    _, _, params, _, model = models(case)
    jstate = jax.tree.map(np.asarray, jax_adamw.init_state(params))
    jstate["nu"] = jax.tree.map(lambda a: a + 0.25, jstate["nu"])
    state = adamw_state_from_reference(jstate)
    names = dict(model.named_parameters())
    assert state["mu"].keys() == state["nu"].keys() == names.keys()
    assert all(state["nu"][k].shape == names[k].shape for k in names)
    assert all(float(state["nu"][k].max()) == 0.25 for k in names)


def test_adamw_state_still_carries_lm_and_sage_trees():
    lm = jax_configs.get("glm4-9b").smoke_cfg
    from repro.models import transformer as jax_tfm
    lp = jax.tree.map(np.asarray, jax_tfm.init_params(
        lm, jax.random.PRNGKey(0)))
    st = adamw_state_from_reference(jax.tree.map(
        np.asarray, jax_adamw.init_state(lp)))
    assert st["mu"].keys() == lm_params_from_reference(lp).keys()
    sage = jax_configs.cell_model_cfg(jax_configs.get("graphsage-reddit"),
                                      "minibatch_lg", smoke=True)
    sp = jax.tree.map(np.asarray, jax_gnn.sage_init(sage,
                                                    jax.random.PRNGKey(0)))
    st = adamw_state_from_reference(jax.tree.map(
        np.asarray, jax_adamw.init_state(sp)))
    assert st["nu"].keys() == gnn_params_from_reference(sp).keys()
