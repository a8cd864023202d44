"""B4's plan and its decomposition on the CPU: the plan
(``segment_matmul.segment_plan``) against numpy, the plain mirror of the
card kernel's tile-and-carry walk (``ref.segment_sum_tiled``, whose order
of f32 adds the kernel repeats bit for bit) against the JAX reference's
Pallas segment sum (interpret mode) and ``jax.ops.segment_sum`` at rtol =
atol = 1e-4 (both sides add the same f32 rows in different orders), the
kernel's schedule, the ops taking plans through their first and second
gradients, the GNNs with plans equal bit for bit to the same models on the
id vectors (tests/test_torch_mgn.py, test_torch_geo.py and
test_torch_gnn.py hold the models, which build plans, against the JAX
package), and the plans each entry point builds. The kernel itself runs
only on an NVIDIA card: its tests are in test_torch_cuda.py."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import segment_matmul as jax_sm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

TOL = 1e-4
#: (E, d, S, kind): tests/test_kernels.py's four shapes with ids in and
#: out of range, hub-heavy ids (one id on 65% of the rows: 1,950 rows, 3.8
#: tiles of 512), segments mostly empty, and one row
CASES = [(10, 4, 3, "in_range"), (700, 32, 90, "in_range"),
         (1024, 128, 256, "in_range"), (513, 7, 1, "in_range"),
         (10, 4, 3, "out_of_range"), (700, 32, 90, "out_of_range"),
         (1024, 128, 256, "out_of_range"), (513, 7, 1, "out_of_range"),
         (3000, 8, 50, "hubs"), (50, 4, 300, "empty"), (1, 3, 5, "in_range")]
#: (8, 2, 8) as the kernel's levels (8 chunks a block, then steps of 2 x
#: 8); (2,) a deep tree of slots, many levels even at these sizes
FANS = [(8, 2, 8), (2,)]


def operands(E, d, S, kind):
    """(f32 values, int32 ids) from a seed, both numpy."""
    rng = np.random.default_rng(E + d + S)
    vals = rng.normal(size=(E, d)).astype(np.float32)
    ids = rng.integers(0, S, E)
    u = rng.random(E)
    if kind == "out_of_range":
        ids[u < 0.1] = -1
        ids[(u >= 0.1) & (u < 0.15)] = S + 3
        ids[(u >= 0.15) & (u < 0.2)] = S + 100_000
    elif kind == "hubs":
        ids[u < 0.65] = S // 2
        ids[(u >= 0.65) & (u < 0.7)] = -1
    return vals, ids.astype(np.int32)


@functools.lru_cache(maxsize=None)
def references(E, d, S, kind):
    """The Pallas kernel's sums and ``jax.ops.segment_sum``'s (in-range
    ids only) on the case's operands."""
    vals, ids = operands(E, d, S, kind)
    pallas = np.asarray(jax_sm.segment_sum(jnp.asarray(vals),
                                           jnp.asarray(ids), S))
    ok = (ids >= 0) & (ids < S)
    oracle = np.asarray(jax.ops.segment_sum(jnp.asarray(vals[ok]),
                                            jnp.asarray(ids[ok]), S))
    return pallas, oracle


@pytest.mark.parametrize("kind", ["in_range", "out_of_range", "hubs",
                                  "sorted", "empty"])
def test_plan_matches_numpy(kind):
    """perm is numpy's stable argsort, sorted_ids the ids in that order,
    offsets ``searchsorted`` on the left for 0..S (so the in-range ids lie
    between offsets[0] and offsets[S], -1 before, ids >= S after)."""
    E, S = 2_000, 40
    _, ids = operands(E, 1, S, "in_range" if kind in ("sorted", "empty")
                      else kind)
    if kind == "sorted":
        ids = np.sort(ids)
    elif kind == "empty":
        ids = ids // 3 * 3                  # two segments in three empty
    plan = sm.segment_plan(torch.as_tensor(ids), S)
    perm = np.argsort(ids, kind="stable")
    assert plan.num_segments == S and torch.equal(plan.ids,
                                                  torch.as_tensor(ids))
    for t in (plan.perm, plan.sorted_ids, plan.offsets):
        assert t.dtype == torch.int32
    np.testing.assert_array_equal(plan.perm.numpy(), perm)
    np.testing.assert_array_equal(plan.sorted_ids.numpy(), ids[perm])
    offsets = np.searchsorted(ids[perm], np.arange(S + 1), side="left")
    np.testing.assert_array_equal(plan.offsets.numpy(), offsets)
    assert offsets[0] == (ids < 0).sum() and offsets[S] == (ids < S).sum()
    counts = np.bincount(ids[(ids >= 0) & (ids < S)], minlength=S)
    np.testing.assert_array_equal(np.diff(offsets), counts)


@pytest.mark.parametrize("fans", FANS, ids=["fans_8_2_8", "fans_2"])
@pytest.mark.parametrize("tile", [1, 3, 512])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "_".join(map(str, c)))
def test_tiled_mirror_matches_pallas_kernel(case, tile, fans):
    E, d, S, kind = case
    vals, ids = operands(E, d, S, kind)
    plan = sm.segment_plan(torch.as_tensor(ids), S)
    got = ref.segment_sum_tiled(torch.as_tensor(vals), plan, tile, fans)
    pallas, oracle = references(E, d, S, kind)
    assert got.dtype == torch.float32 and got.shape == (S, d)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)
    empty = np.bincount(ids[(ids >= 0) & (ids < S)], minlength=S) == 0
    assert not got.numpy()[empty].any()


def test_tiled_mirror_adds_in_its_own_fixed_order():
    """Integer-valued rows sum exactly in any order: the mirror equals the
    plain version bit for bit on them, at every tile; on N(0, 1) rows a
    different tile may move the last bits, the same tile never does."""
    rng = np.random.default_rng(4)
    ids = torch.as_tensor(rng.integers(-1, 30, 4_000).astype(np.int32))
    ints = torch.as_tensor(rng.integers(-8, 9, (4_000, 3)).astype(np.float32))
    plan = sm.segment_plan(ids, 30)
    for tile in (1, 3, 16, 512):
        assert torch.equal(ref.segment_sum_tiled(ints, plan, tile, (4,)),
                           ref.segment_sum(ints, ids, 30))
    x = torch.as_tensor(rng.normal(size=(4_000, 3)).astype(np.float32))
    assert torch.equal(ref.segment_sum_tiled(x, plan, 16, (4,)),
                       ref.segment_sum_tiled(x, plan, 16, (4,)))


@pytest.mark.parametrize("E,d,want", [
    (7_732_736, 128, (256, (8, 8, 8, 8, 8))),  # meshgraphnet, ogb / 16
    (337_920, 602, (64, (8, 8, 8, 2, 8))),     # GraphSAGE layer 1
    (337_920, 128, (256, (8, 21, 8))),         # GraphSAGE layer 2
    (337_920, 1, (16, (8, 8, 8, 6, 8))),       # GraphSAGE degree counts
    (21_504, 128, (16, (8, 21, 8))),           # meshgraphnet full_graph_sm
    (16_384, 32, (16, (8, 16, 8))),            # nequip's a_s
    (1, 1, (16, (8,)))])
def test_schedule_depends_on_the_shape_alone(E, d, want):
    """``segment_tiles``: a tile of 16, 64 or 256 sorted positions, 8
    chunks (F) a level-1 block, then steps of a * F
    chunks (fans a, F) until one chunk is left; the slots the steps read
    are two per chunk of the level below each, in whole groups, and their
    arrival counters per column slice one per a chunks and one per
    group."""
    tile, fans = sm.segment_tiles(E, d)
    assert (tile, fans) == want
    F = fans[0]
    assert F == sm.SEGSUM_ROWS and len(fans) % 2
    assert all(f == F for f in fans[2::2])
    chunks, tiers, slots = [-(-(-(-E // tile)) // F)], 0, 0
    for a in fans[1::2]:
        assert a <= sm.SEGSUM_LAST_STEP
        tiers += -(-chunks[-1] // a)
        chunks.append(-(-chunks[-1] // (a * F)))
        slots += 2 * chunks[-1] * a * F
    assert chunks[-1] == 1 and all(n > 1 for n in chunks[:-1])
    assert sm._segment_slots(E, tile, fans, 3) == (
        slots, 3 * (tiers + sum(chunks[1:])))


def test_ops_take_plans_and_keep_them_for_every_gradient(monkeypatch):
    """ops.segment_sum and ops.gather_rows with a plan give what they give
    with its ids, and the first and second gradients (the sum's gather,
    the gather's sum, and their own gradients) reuse the plan: no plan is
    built after the first."""
    rng = np.random.default_rng(6)
    ids = torch.as_tensor(rng.integers(-1, 9, 60).astype(np.int32))
    x = torch.tensor(rng.normal(size=(9, 4)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(4, 3)).astype(np.float32),
                     requires_grad=True)
    gather_ids = ids.clamp(0, 8)
    built = []
    real = sm.segment_plan

    def counted(*a):
        built.append(a)
        return real(*a)
    monkeypatch.setattr(sm, "segment_plan", counted)
    plan, gplan = ops.segment_plan(ids, 9), ops.segment_plan(gather_ids, 9)
    assert len(built) == 2

    def f(p, g):
        def fn(x, w):
            rows = ops.gather_rows(x, g)
            y = ops.matmul(rows, w).tanh()
            return ops.segment_sum(y, p, 9).pow(2).sum()
        return fn

    results = []
    for p, g in ((plan, gplan), (ids, gather_ids)):
        gs = torch.autograd.grad(f(p, g)(x, w), (x, w), create_graph=True)
        hs = torch.autograd.grad(sum((t ** 2).sum() for t in gs), (x, w))
        results.append([*gs, *hs])
    assert len(built) == 2
    for a, b in zip(*results):
        assert torch.equal(a, b)
    assert torch.equal(ops.gather_rows(x, gplan), x[gather_ids.long()])
    assert torch.equal(ops.segment_sum(x[gather_ids.long()], plan, 9),
                       ops.segment_sum(x[gather_ids.long()], ids, 9))


def test_plan_arguments_are_checked():
    ids = torch.tensor([0, 2, 1, 2], dtype=torch.int32)
    plan = ops.segment_plan(ids, 3)
    with pytest.raises(ValueError):
        sm.segment_sum(torch.ones(4, 2), plan, 4)           # other S
    with pytest.raises(ValueError):
        sm.segment_sum(torch.ones(5, 2), plan, 3)           # other E
    with pytest.raises(ValueError):
        ops.gather_rows(torch.ones(4, 2), plan)             # x has 4 rows
    with pytest.raises(ValueError):
        ops.segment_plan(ids, -1)
    with pytest.raises(TypeError):
        ops.segment_plan(torch.zeros(4), 3)
    assert sm.plan_ids(plan) is plan.ids and sm.plan_ids(ids) is ids
    assert ref.segment_sum(torch.ones(4, 2), plan, 3).tolist() == \
        [[1.0, 1.0], [1.0, 1.0], [2.0, 2.0]]


#: B4 plans built by one serve step, one energy-and-forces pass and one
#: train step (chip_smoke.py's GNN_PLANS holds the same on the card)
GNN_PLANS = {
    "graphsage-reddit": {"serve": 1, "train": 2},
    "meshgraphnet": {"serve": 1, "train": 2},
    "nequip": {"serve": 2, "forces": 3, "train": 3},
    "mace": {"serve": 2, "forces": 3, "train": 3},
}


def narrow_model(arch):
    """Each GNN at its smoke shape, narrow, with one batch and its loss."""
    spec = configs.get(arch)
    shape = {"meshgraphnet": "full_graph_sm",
             "graphsage-reddit": "minibatch_lg"}.get(arch, "molecule")
    cfg = configs.cell_model_cfg(spec, shape, smoke=True)
    narrow = {"meshgraphnet": dict(d_node_in=8, d_hidden=16, n_layers=3),
              "graphsage-reddit": {}}.get(
        arch, dict(d_species=8, d_hidden=8, radial_hidden=8, n_layers=2))
    cfg = dataclasses.replace(cfg, **narrow)
    dims = dict(configs.smoke_dims(spec, shape))
    if arch == "graphsage-reddit":
        dims["n"] = 64
    batch = train.make_batch_fn(spec, cfg, dims, device="cpu")(0)
    model = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return spec, shape, cfg, model, batch


def outputs_and_grads(spec, shape, cfg, model, batch):
    out = configs.make_serve_step(spec, shape, cfg)(model, batch)
    out = out[0] if isinstance(out, tuple) else out
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = configs.loss_for(spec, cfg)(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    for p in params.values():
        p.requires_grad_(False)
    return [out, loss.detach(), *grads]


@pytest.mark.parametrize("arch", sorted(GNN_PLANS))
def test_models_with_plans_equal_the_models_on_ids(arch, monkeypatch):
    """Each GNN's served output, loss and every gradient (NequIP's and
    MACE's losses differentiate their forces again) with B4 plans, bit for
    bit the same as with ``ops.segment_plan`` handing back the id vectors
    (the plain versions sum in the same order either way)."""
    args = narrow_model(arch)
    with_plans = outputs_and_grads(*args)
    monkeypatch.setattr(ops, "segment_plan", lambda ids, num_segments: ids)
    on_ids = outputs_and_grads(*args)
    assert len(with_plans) == len(on_ids)
    for a, b in zip(with_plans, on_ids):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(GNN_PLANS))
def test_plans_built_per_step(arch, monkeypatch):
    """The plans each entry point builds: one per id vector it sums by
    (dst; NequIP's and MACE's graph_id), one for src where a gradient can
    flow (the gathers' gradients sum by it), and none in any backward pass
    or in the force loss's second one."""
    built = []
    real = sm.segment_plan

    def counted(*a):
        built.append(a[1])
        return real(*a)
    monkeypatch.setattr(sm, "segment_plan", counted)
    spec, shape, cfg, model, batch = narrow_model(arch)
    got = {}

    def count(what, fn):
        built.clear()
        fn()
        got[what] = len(built)

    count("serve", lambda: configs.make_serve_step(spec, shape, cfg)(
        model, batch))
    if "forces" in GNN_PLANS[arch]:
        count("forces", lambda: gnn.energy_and_forces(model, batch))
    count("train", lambda: outputs_and_grads(spec, shape, cfg, model,
                                             batch)[2:])
    got["train"] -= got["serve"]       # outputs_and_grads serves first
    assert got == GNN_PLANS[arch]
