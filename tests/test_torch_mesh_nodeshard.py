"""The port's node-sharded GNN steps (``models.gnn.NodeShard``: the
reference's ``set_node_sharding`` hook at ``P(all_axes)``, as the dry
run's ``nodeshard`` and ``nodeshard_bf16`` variants set it) against the
JAX package's single-device step.

Under the hook the reference pins every aggregated node tensor to rows
split over all mesh axes. The port runs that layout: each rank keeps its
edges (``gnn_batch_specs``) and its ``n / world`` node rows (the node
count zero-padded to a multiple of the world), reduces each aggregation
and scatters its rows in rank order, gathers the node state whole before
each edge gather, and sums losses and energies over its rows. The
reference's own sharded test fails in this container
(tests/test_distributed.py), so every mesh is held to its single-device
step, jitted on the CPU.

* The four GNNs' smoke configs (graphsage-reddit masked, meshgraphnet,
  nequip, mace; the inputs of tests/test_torch_mesh_gnn.py), a
  GraphSAGE graph of 27 nodes (``sage_odd``, which no world divides), and
  NequIP under ``bf16_state``. On the 2-, 4- and 8-rank gloo worlds of
  ``tests/torch_rank_bodies.py`` (``MESHES``: (1, 2), (2, 1), (2, 2),
  (1, 4), (4, 1), (2, 4)): the serve step's outputs (this rank's node
  rows, concatenated in rank order), the loss and every parameter's
  gradient, NequIP's and MACE's forces, and one train step's metrics,
  parameters and moments, within 1e-4 of each leaf's largest |value|
  (1e-2 under ``bf16_state``, tests/test_torch_geo.py's); every rank's
  parameters and moments bit-equal.
* The aggregated node rows equal the edge-parallel ``psum``'s rows bit
  for bit: a sum of random partials, and GraphSAGE's first aggregated
  mean on the 27-node graph.
* The collectives of a step are those the variant asks for
  (:func:`predicted_calls`).
* On a one-rank mesh the hook spans one rank: the step is the unsharded
  one bit for bit, with no collective.

The three worlds run while the reference computes its answers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

import torch_rank_bodies as bodies  # noqa: E402
from test_torch_mesh_gnn import case_inputs, reference  # noqa: E402

TOL = 1e-4
#: NequIP's node irreps rounded to bf16 between layers
BF16_TOL = 1e-2
WORLD_TIMEOUT_S = 300.0
CASES = ("sage", "mgn", "nequip", "mace", *bodies.NODE_CASES)
#: outputs whose rows are split over the ranks (the rest are replicated)
ROW_KEYS = ("out", "s")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case's reference answers and every rank's results of the 2-,
    4- and 8-rank worlds, which run while the reference computes."""
    tmp = tmp_path_factory.mktemp("mesh_nodeshard")
    inputs, setup = {}, {}
    for case in CASES:
        setup[case] = case_inputs(case, inputs)
    rng = np.random.default_rng(61)
    inputs["ns.partial"] = rng.normal(size=(8, 27, 5)).astype(np.float32)
    path = tmp / "inputs.npz"
    np.savez(path, **inputs)
    started = {world: bodies.start_world(world, path, tmp,
                                         suite="nodeshard")
               for world in bodies.MESHES}
    try:
        want = {case: reference(case, *args) for case, args in setup.items()}
    except BaseException:
        for _, procs in started.values():
            for p in procs:
                p.kill()
        raise
    out = {"want": want}
    for world, run in started.items():
        out[world] = bodies.wait_world(run, WORLD_TIMEOUT_S)
    return out


def mesh_keys():
    return [(world, bodies.mesh_key(shape)) for world, shapes in
            bodies.MESHES.items() for shape in shapes]


def close(got, want, what: str, tol: float) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} of max|want|"


@pytest.mark.parametrize("world,mesh,case", [
    (w, m, c) for w, m in mesh_keys() for c in CASES])
def test_node_sharded_step_equals_reference(worlds, world, mesh, case):
    ranks, want = worlds[world], worlds["want"][case]
    key = f"{case}|{mesh}|"
    tol = BF16_TOL if case.endswith("bf16") else TOL
    for name in want:
        got = (np.concatenate([r[key + name] for r in ranks])
               if name in ROW_KEYS else ranks[0][key + name])
        close(got, want[name], f"{case} on {mesh}: {name}", tol)
    for r, res in enumerate(ranks[1:], 1):
        for name in want:
            if name not in ROW_KEYS:
                np.testing.assert_array_equal(
                    res[key + name], ranks[0][key + name],
                    err_msg=f"rank {r} of {mesh}: {name}")


@pytest.mark.parametrize("world,mesh", mesh_keys())
def test_node_rows_equal_the_edge_parallel_sums_bit_for_bit(worlds, world,
                                                            mesh):
    """``NodeShard.agg`` (reduce-scatter in rank order) gives this rank's
    rows of ``EdgeShard.agg``'s (all-reduce in rank order) bit for bit,
    on random partials and on GraphSAGE's first aggregated mean."""
    n = 27
    for r, res in enumerate(worlds[world]):
        key = f"agg|{mesh}|"
        lo, hi = res[key + "span"]
        np.testing.assert_array_equal(res[key + "node"],
                                      res[key + "edge"][lo:hi])
        node = res[key + "sage.node"][:max(0, min(hi, n) - lo)]
        np.testing.assert_array_equal(node, res[key + "sage.edge"][lo:hi],
                                      err_msg=f"rank {r}")


def predicted_calls(case: str, mesh: str) -> tuple:
    """(all-gathers, reduce-scatters, all-reduces) of one train step, each
    once per live axis.

    Every aggregation the forward makes is a reduce-scatter (``agg``)
    whose backward is an all-gather; every gather of the node state for
    the edges (``gather``) an all-gather whose backward is a
    reduce-scatter; a backward runs only where a gradient flows. Every
    use of a parameter takes ``grad_sum`` (its rows, node or edge, are
    this rank's): one all-reduce in the backward each; so does ``pos``
    where the forces are taken, and every sum of a loss or an energy over
    this rank's rows (``psum``) is one in the forward.

    * GraphSAGE, L layers: 2 aggregations a layer (the mean's sums and
      counts); the node state gathered from layer 2 on (layer 1's edges
      read the input features whole); backward: the gathers, and the sums
      from layer 2 on (layer 1's, of the input, and the counts carry no
      gradient). All-reduces: w_self, w_neigh and b a layer, the head,
      and the loss's two sums. (2(L - 1), 3L - 1, 3L + 3).
    * MeshGraphNet, L layers of MLPs of M hidden layers: one aggregation
      and one gather a layer, each with its backward; M + 1 weights and
      biases in each of 3 + 2L MLPs (the encoders, the decoder, each
      layer's two) and the loss's sum. (2L, 2L, 2(M + 1)(3 + 2L) + 1).
    * NequIP and MACE, L layers: the forward (F) gathers s, V, T and makes
      three aggregations a layer and sums the energies. The forces' first
      backward (B1) transposes the aggregations that reach the energy
      (NequIP's last layer reaches it through its scalars alone: a_v and
      a_t of that layer do not) and the gathers that carry ``pos``'s
      dependence (layer 2 on), and sums ``pos``. The step's backward (B2)
      transposes F's collectives that a gradient reaches (the
      aggregations reaching the energy; the gathers from layer 2 on and
      layer 1's s, which the embedding feeds) and each of B1's. Its
      all-reduces are the parameter uses that reach the loss: the
      embedding's 2, per layer the radial MLP's 4, 3 mixes, the gates'
      2 (and MACE's 6 projections), the readout's 4; NequIP's last
      layer's mix_v, mix_t and gates (4), and MACE's last v3 and t3 (2),
      reach nothing.
      NequIP: gathers 3L + (3L - 2) + (3L - 2) + 3(L - 1), scatters 3L +
      3(L - 1) + 1 + 3(L - 1) + (3L - 2): (12L - 7, 12L - 7, 9L + 4).
      MACE: (12L - 3, 12L - 5, 15L + 6)."""
    arch = bodies.gnn_case_of(case)[0]
    spec = configs.get(arch)
    cfg = configs.cell_model_cfg(spec, next(iter(spec.shapes)), smoke=True)
    L = cfg.n_layers
    live = sum(1 for n in map(int, mesh.split("x")) if n > 1)
    if arch == "graphsage-reddit":
        calls = (2 * (L - 1), 3 * L - 1, 3 * L + 3)
    elif arch == "meshgraphnet":
        calls = (2 * L, 2 * L, 2 * (cfg.mlp_layers + 1) * (3 + 2 * L) + 1)
    elif arch == "nequip":
        calls = (12 * L - 7, 12 * L - 7, 9 * L + 4)
    else:
        calls = (12 * L - 3, 12 * L - 5, 15 * L + 6)
    return tuple(n * live for n in calls)


@pytest.mark.parametrize("world,mesh,case", [
    (w, m, c) for w, m in mesh_keys() for c in CASES])
def test_step_makes_the_predicted_collectives(worlds, world, mesh, case):
    for r, res in enumerate(worlds[world]):
        key = f"{case}|{mesh}|"
        got = tuple(int(c) for c in res[key + "calls"])
        assert got == predicted_calls(case, mesh), (r, got)
        assert int(res[key + "other_collectives"]) == \
            got[0] + got[1], (r, int(res[key + "other_collectives"]))


@pytest.mark.parametrize("case", CASES)
def test_one_rank_hook_is_the_unsharded_step_bit_for_bit(case):
    """The hook on the card's one-rank mesh spans one rank: the step is
    the unsharded one, every output, gradient, force, metric, parameter
    and moment bit for bit, with no collective."""
    inputs = {}
    case_inputs(case, inputs)
    whole = bodies.gnn_body(None, inputs, case)
    mesh = make_smoke_mesh("cpu")
    shd.reset_collectives()
    placed = bodies.nodeshard_body(mesh, inputs, case)
    assert shd.collective_counts() == {}
    assert placed["calls"].tolist() == [0, 0, 0]
    assert whole.keys() == placed.keys()
    for name, v in whole.items():
        np.testing.assert_array_equal(placed[name], v, err_msg=name)
