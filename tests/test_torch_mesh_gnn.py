"""The port's edge-parallel GNN steps (``models.gnn.EdgeShard``,
``configs.make_train_step(mesh=)`` and ``make_serve_step(mesh=)`` for
the GNN family) against the JAX package's single-device step.

The reference partitions the family with GSPMD: edge arrays over every
mesh axis, node state and parameters replicated, each aggregation's
partial sums all-reduced (``src/repro/runtime/sharding.py``'s GNN rules).
Its own sharded test fails in this container (tests/test_distributed.py),
so every mesh is held to the reference's single-device step, jitted on
the CPU, which a correct partition must reproduce.

* The smoke configs of graphsage-reddit (with and without an edge mask),
  meshgraphnet (masked), nequip and mace (molecules with padding edges
  at node 0, mask 0), their weights the reference's init carried by
  ``gnn_params_from_reference``, inputs from a numpy seed, the edge count
  a multiple of 8. On the 2-, 4- and 8-rank gloo worlds of
  ``tests/torch_rank_bodies.py`` (``MESHES``: (1, 2), (2, 1), (2, 2),
  (1, 4), (4, 1), (2, 4)): the serve step's outputs, the loss and every
  parameter's gradient from this rank's edges, NequIP's and MACE's
  forces, and one train step's loss, ``grad_norm``, ``lr``, updated
  parameters and moments, each within 1e-4 of its largest |value| (the
  tolerance of tests/test_torch_gnn.py and test_torch_geo.py); every
  rank's parameters and moments bit-equal (replicated state stays
  replicated).
* The all-reduces of a step are exactly those the policy asks for: one
  per live axis for each aggregation (``psum``) in the forward and for
  each ``grad_sum`` a backward runs (the node state gathered by the edges,
  ``pos``, the edge-row parameters), none for the energies (a node-row
  sum) or for parameters used on node rows only; no other collective.
* A mean of the ranks' own means planted in place of GraphSAGE's summed
  mean is caught.
* On a one-rank gloo mesh every case is the unsharded step bit for bit,
  with no collective.

Each world is one run of ``torch_rank_bodies`` under a hard timeout; the
three worlds run while the reference computes its answers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.carry import gnn_params_from_reference  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

import torch_rank_bodies as bodies  # noqa: E402

TOL = 1e-4
WORLD_TIMEOUT_S = 150.0
CASES = bodies.GNN_CASES
#: molecules of the geo cases: graphs, atoms each, random pairs each
GRAPHS, ATOMS, PAIRS = 3, 10, 24


def sage_batch(cfg, masked: bool, rng, n=24, e=48) -> dict:
    b = {"node_feat": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
         "src": rng.integers(0, n, e).astype(np.int32),
         "dst": rng.integers(0, n, e).astype(np.int32),
         "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
         "seed_mask": rng.random(n) < 0.5}
    if masked:
        b["edge_mask"] = (rng.random(e) < 0.75).astype(np.float32)
    return b


def mgn_batch(cfg, rng, n=40, e=96) -> dict:
    return {"node_feat": rng.normal(size=(n, cfg.d_node_in)).astype(
                np.float32),
            "src": rng.integers(0, n, e).astype(np.int32),
            "dst": rng.integers(0, n, e).astype(np.int32),
            "edge_feat": rng.normal(size=(e, cfg.d_edge_in)).astype(
                np.float32),
            "target": rng.normal(size=(n, cfg.d_out)).astype(np.float32),
            "edge_mask": (rng.random(e) < 0.75).astype(np.float32)}


def molecule_batch(cfg, rng) -> dict:
    """GRAPHS molecules of ATOMS atoms, each in a box of its own, random
    directed pairs inside each (all within the cutoff), padded with edges
    at node 0 (mask 0) to a multiple of 8 and at least 8 of them."""
    n = GRAPHS * ATOMS
    pos = rng.uniform(0.0, 2.5, (n, 3)) + 10.0 * np.repeat(
        np.arange(GRAPHS), ATOMS)[:, None]
    pairs = []
    for g in range(GRAPHS):
        a = rng.integers(0, ATOMS, (PAIRS, 2))
        pairs.append(a[a[:, 0] != a[:, 1]] + g * ATOMS)
    pairs = np.concatenate(pairs)
    pad = 8 + (-pairs.shape[0]) % 8
    src = np.concatenate([pairs[:, 0], np.zeros(pad, int)])
    dst = np.concatenate([pairs[:, 1], np.zeros(pad, int)])
    mask = np.concatenate([np.ones(pairs.shape[0]), np.zeros(pad)])
    return {"node_feat": np.eye(cfg.d_species, dtype=np.float32)[
                rng.integers(0, cfg.d_species, n)],
            "pos": pos.astype(np.float32),
            "src": src.astype(np.int32), "dst": dst.astype(np.int32),
            "edge_mask": mask.astype(np.float32),
            "graph_id": np.repeat(np.arange(GRAPHS), ATOMS).astype(np.int32),
            "energy_target": rng.normal(size=GRAPHS).astype(np.float32),
            "force_target": rng.normal(size=(n, 3)).astype(np.float32)}


def case_inputs(case: str, inputs: dict):
    """The reference's init and the case's batch (a case of
    ``torch_rank_bodies.GNN_CASES`` or ``NODE_CASES``), into ``inputs`` as
    ``gnn.<case>.p.<port name>`` and ``gnn.<case>.b.<key>``; returns
    (jax spec, jax cfg, jax params, numpy batch)."""
    arch, shape, masked, over, sizes = bodies.gnn_case_of(case)
    jspec = jax_configs.get(arch)
    jcfg = dataclasses.replace(
        jax_configs.cell_model_cfg(jspec, shape, smoke=True), **over)
    params = jax_base.init_params(jspec, jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(
        sorted(CASES).index(case) + 1 if case in CASES else
        100 + sorted(bodies.NODE_CASES).index(case))
    kind = type(jcfg).__name__
    b = (sage_batch(jcfg, masked, rng, **sizes) if kind == "SAGEConfig" else
         mgn_batch(jcfg, rng, **sizes) if kind == "MGNConfig" else
         molecule_batch(jcfg, rng))
    assert b["src"].shape[0] % 8 == 0
    carried = gnn_params_from_reference(jax.tree.map(np.asarray, params))
    inputs.update({f"gnn.{case}.p.{n}": t.numpy()
                   for n, t in carried.items()})
    inputs.update({f"gnn.{case}.b.{k}": v for k, v in b.items()})
    return jspec, jcfg, params, b


def reference(case: str, jspec, jcfg, params, b) -> dict:
    """The reference's single-device answers: the serve step's outputs,
    the loss and its gradients, the forces, and one train step."""
    shape = bodies.gnn_case_of(case)[1]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out = jax.jit(jax_base.make_serve_step(jspec, shape, jcfg))(params, jb)
    want = {}
    if isinstance(out, tuple):
        want["energy"], want["s"] = np.asarray(out[0]), np.asarray(out[1][0])
    else:
        want["out"] = np.asarray(out)
    lval, grads = jax.jit(jax.value_and_grad(jax_base.loss_for(
        jspec, jcfg)))(params, jb)
    want["grad_loss"] = np.asarray(lval)
    want.update({f"grad.{n}": t.numpy() for n, t in
                 gnn_params_from_reference(jax.tree.map(np.asarray,
                                                        grads)).items()})
    if "pos" in b:
        fwd = jax_base._GNN_FWD[type(jcfg)]

        def energy(p, bb, pos):
            return jnp.sum(fwd(p, jcfg, {**bb, "pos": pos})[0])
        want["forces"] = -np.asarray(jax.jit(jax.grad(energy, argnums=2))(
            params, jb, jb["pos"]))
    jopt = jax_adamw.AdamWConfig(**bodies.GNN_OPT)
    new, state, m = jax.jit(jax_base.make_train_step(jspec, jcfg, jopt))(
        params, jax_adamw.init_state(params), jb)
    want.update({k: float(v) for k, v in m.items()})
    for what, tree in (("param", new), ("mu", state["mu"]),
                       ("nu", state["nu"])):
        host = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
        want.update({f"{what}.{n}": t.numpy() for n, t in
                     gnn_params_from_reference(host).items()})
    return want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case's reference answers and every rank's results of the 2-,
    4- and 8-rank worlds, which run while the reference computes."""
    tmp = tmp_path_factory.mktemp("mesh_gnn")
    inputs, setup = {}, {}
    for case in CASES:
        setup[case] = case_inputs(case, inputs)
    path = tmp / "inputs.npz"
    np.savez(path, **inputs)
    started = {world: bodies.start_world(world, path, tmp, suite="gnn")
               for world in bodies.MESHES}
    try:
        want = {case: reference(case, *args) for case, args in setup.items()}
    except BaseException:
        for _, procs in started.values():
            for p in procs:
                p.kill()
        raise
    out = {"inp": inputs, "want": want}
    for world, run in started.items():
        out[world] = bodies.wait_world(run, WORLD_TIMEOUT_S)
    return out


def mesh_cases():
    return [(world, bodies.mesh_key(shape), case)
            for world, shapes in bodies.MESHES.items() for shape in shapes
            for case in CASES]


def close(got, want, what: str) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, f"{what}: {err:.3e} of max|want|"


@pytest.mark.parametrize("world,mesh,case", mesh_cases())
def test_edge_parallel_step_equals_reference(worlds, world, mesh, case):
    ranks, want = worlds[world], worlds["want"][case]
    key = f"{case}|{mesh}|"
    for name in want:
        close(ranks[0][key + name], want[name], f"{case} on {mesh}: {name}")
    n_leaves = sum(1 for k in want if k.startswith("param."))
    assert n_leaves == sum(1 for k in want if k.startswith("grad."))
    for r, res in enumerate(ranks[1:], 1):
        for name in want:
            if name.split(".")[0] in ("param", "mu", "nu", "loss",
                                      "grad_norm", "lr"):
                np.testing.assert_array_equal(
                    res[key + name], ranks[0][key + name],
                    err_msg=f"rank {r} of {mesh}: {name}")


def predicted_reduces(case: str, mesh: str) -> int:
    """All-reduces of one train step: per live axis, each forward
    aggregation (``psum``) and each ``grad_sum`` a backward runs.

    * GraphSAGE, L layers: the mean's sums and counts, 2 a layer; the
      node rows gathered by the edges from layer 2 on (layer 1's are the
      input features, with no gradient).
    * MeshGraphNet, L layers of MLPs of M hidden layers: one aggregation a
      layer; the edge encoder's and each edge MLP's (M + 1) weights and
      biases, and each layer's gathered node state.
    * NequIP and MACE, L layers: three aggregations a layer; the forces'
      backward sums ``pos`` and the irreps gathered from layer 2 on
      (s, V, T: layer 1's V and T are zeros, its s does not reach
      ``pos``); the step's backward sums layer 1's s, the later layers'
      s, V, T, each radial MLP's two weights and biases, and the terms of
      each aggregation's cotangent that the forces' backward passed on
      (``psum``'s backward, a ``grad_sum``): all three a layer, but
      NequIP's last layer reaches the energy through its scalars alone.
      The energies and the node-row parameters take none."""
    arch, shape, _ = CASES[case]
    cfg = configs.cell_model_cfg(configs.get(arch), shape, smoke=True)
    L = cfg.n_layers
    live = sum(1 for n in map(int, mesh.split("x")) if n > 1)
    if arch == "graphsage-reddit":
        per = 2 * L + (L - 1)
    elif arch == "meshgraphnet":
        mlp = 2 * (cfg.mlp_layers + 1)
        per = L + mlp + L * (mlp + 1)
    else:
        forces = 1 + 3 * (L - 1)
        passed = 3 * (L - 1) + (3 if arch == "mace" else 1)
        per = 3 * L + forces + (1 + 3 * (L - 1) + 4 * L) + passed
    return per * live


@pytest.mark.parametrize("world,mesh,case", mesh_cases())
def test_step_makes_the_predicted_all_reduces(worlds, world, mesh, case):
    for r, res in enumerate(worlds[world]):
        key = f"{case}|{mesh}|"
        assert int(res[key + "reduces"]) == predicted_reduces(case, mesh), (
            r, int(res[key + "reduces"]))
        assert int(res[key + "other_collectives"]) == 0


@pytest.mark.parametrize("world,mesh", [
    (world, bodies.mesh_key(shape)) for world, shapes in
    bodies.MESHES.items() for shape in shapes])
def test_a_per_rank_mean_is_caught(worlds, world, mesh):
    """The planted mean of the ranks' own means gives logits the
    reference's tolerance refuses, while the summed mean meets it."""
    want = worlds["want"]["sage"]["out"]
    got = worlds[world][0][f"planted|{mesh}|out"]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err > 100 * TOL, err
    close(worlds[world][0][f"sage|{mesh}|out"], want, "sage")


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_rank_mesh_is_the_unsharded_step_bit_for_bit(case):
    """On a one-rank gloo mesh the partition exchanges nothing: every
    output, gradient, force, metric, parameter and moment equals the
    unsharded run's exactly, with no collective."""
    inputs = {}
    case_inputs(case, inputs)
    whole = bodies.gnn_body(None, inputs, case)
    shd.reset_collectives()
    placed = bodies.gnn_body(make_smoke_mesh("cpu"), inputs, case)
    assert shd.collective_counts() == {}
    assert int(placed["reduces"]) == 0
    assert whole.keys() == placed.keys()
    for name, v in whole.items():
        np.testing.assert_array_equal(placed[name], v, err_msg=name)


def test_mind_on_a_mesh_still_raises():
    """MIND runs on a mesh (tests/test_torch_mesh_mind.py), but a batch
    of 3 users on 2 data ranks still raises: the partitioner places even
    shards only."""
    spec = configs.get("mind")
    cfg = spec.smoke_cfg
    model = configs.init_params(spec, cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    model.mesh = MeshOf(2)
    batch = {"hist_ids": torch.zeros((3, cfg.hist_len), dtype=torch.int32),
             "hist_mask": torch.ones((3, cfg.hist_len)),
             "cand_ids": torch.zeros((3, 4), dtype=torch.int32)}
    step = configs.make_serve_step(spec, "serve_p99", cfg, mesh=model.mesh)
    with pytest.raises(NotImplementedError, match="evenly"):
        step(model, batch)


def test_an_edge_count_that_does_not_divide_raises():
    """A batch of 7 edges on a mesh of 2: the partitioner places even
    shards only (padding edges, mask 0 at node 0, make it divide)."""
    inputs = {}
    case_inputs("sage", inputs)
    _, shape, cfg, model, batch = bodies.gnn_case(inputs, "sage", None)
    model.mesh = MeshOf(2)
    batch = {k: (v[:7] if k in ("src", "dst", "edge_mask") else v)
             for k, v in batch.items()}
    step = configs.make_serve_step(configs.get("graphsage-reddit"), shape,
                                   cfg, mesh=model.mesh)
    with pytest.raises(NotImplementedError, match="evenly"):
        step(model, batch)


class MeshOf:
    """A stand-in mesh of ``n`` data ranks (sizes alone)."""

    def __init__(self, n):
        self.shape = {"data": n, "model": 1}
        self.axis_names = ("data", "model")
