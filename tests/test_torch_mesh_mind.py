"""The port's MIND steps on a ``(data, model)`` mesh
(``models.recsys.Partition``, ``configs.make_train_step(mesh=)`` and
``make_serve_step(mesh=)`` for the recsys family) against the JAX
package's single-device step.

The reference's recsys policy (``src/repro/runtime/sharding.py``) splits
the item table's rows over ``model`` and looks them up with the
vocab-parallel take (mask and ``psum`` in a ``shard_map``); everything
else is data-parallel over the batch. Its loss is a sampled softmax with
in-batch negatives over the WHOLE batch: under GSPMD the logits (B, B)
still span all B targets when the users are split over ``data``. Its own
sharded test fails in this container (tests/test_distributed.py), so
every mesh is held to the reference's single-device step, jitted on the
CPU, which a correct partition must reproduce.

* MIND's smoke config (1,024 items x 16), the reference's ``mind_init``
  weights carried by ``mind_params_from_reference(tree, mesh)``, a batch
  of 16 users from a numpy seed (every data rank's users meet the other
  ranks' targets as negatives). On the 2-, 4- and 8-rank gloo worlds of
  ``tests/torch_rank_bodies.py`` (``MESHES``: (1, 2), (2, 1), (2, 2),
  (1, 4), (4, 1), (2, 4)): serve_p99's scores (16 users x 16
  candidates), retrieval's over 64 candidates, and one train step's
  loss, ``grad_norm``, ``lr``, updated ``S`` and gathered ``item_embed``
  and both moments, each within 1e-4 of its largest |value|; every
  rank's values bit-equal.
* A per-rank softmax (each data rank's users against its own targets
  only, the ranks' means averaged: a plain data-parallel step) planted in
  place of the global one gives a loss outside the tolerance, on every
  mesh with more than one data rank.
* The collectives of a step are exactly those the policy asks for
  (:func:`predicted_calls`).
* On a one-rank gloo mesh every case is the unsharded step bit for bit,
  with no collective.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.core.carry import mind_params_from_reference  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

import torch_rank_bodies as bodies  # noqa: E402

TOL = 1e-4
WORLD_TIMEOUT_S = 300.0
USERS, CANDS, SLAB = 16, 16, 64


def mind_inputs() -> tuple:
    """The reference's smoke params and the three batches, as the rank
    bodies read them (``mind.p.*``, ``mind.serve.*``, ``mind.ret.*``,
    ``mind.train.*``); returns (inputs, jax params)."""
    jcfg = jax_configs.get("mind").smoke_cfg
    params = jax_recsys.mind_init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(71)
    n, H = jcfg.n_items, jcfg.hist_len

    def users(B):
        return {"hist_ids": rng.integers(0, n, (B, H)).astype(np.int32),
                "hist_mask": (rng.random((B, H)) < 0.8).astype(np.float32)}
    serve = {**users(USERS), "cand_ids": rng.integers(
        0, n, (USERS, CANDS)).astype(np.int32)}
    ret = {**users(1), "cand_ids": rng.integers(0, n, SLAB).astype(np.int32)}
    train = {**users(USERS), "target_id": rng.integers(0, n, USERS).astype(
        np.int32)}
    inputs = {f"mind.p.{k}": np.asarray(v) for k, v in params.items()}
    for what, b in (("serve", serve), ("ret", ret), ("train", train)):
        inputs.update({f"mind.{what}.{k}": v for k, v in b.items()})
    return inputs, params


def reference(inputs: dict, params) -> dict:
    """The reference's single-device answers."""
    jspec = jax_configs.get("mind")
    jcfg = jspec.smoke_cfg

    def batch(what):
        pre = f"mind.{what}."
        return {k[len(pre):]: jax.numpy.asarray(v) for k, v in inputs.items()
                if k.startswith(pre)}
    want = {
        "serve": np.asarray(jax.jit(jax_base.make_serve_step(
            jspec, "serve_p99", jcfg))(params, batch("serve"))),
        "ret": np.asarray(jax.jit(jax_base.make_serve_step(
            jspec, "retrieval_cand", jcfg))(params, batch("ret")))}
    jopt = jax_adamw.AdamWConfig(**bodies.MIND_OPT)
    new, state, m = jax.jit(jax_base.make_train_step(jspec, jcfg, jopt))(
        params, jax_adamw.init_state(params), batch("train"))
    want.update({k: float(v) for k, v in m.items()})
    for what, tree in (("param", new), ("mu", state["mu"]),
                       ("nu", state["nu"])):
        want.update({f"{what}.{n}": t.numpy() for n, t in
                     mind_params_from_reference(jax.tree.map(
                         np.asarray, tree)).items()})
    return want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's answers and every rank's results of the 2-, 4- and
    8-rank worlds, which run while the reference computes."""
    tmp = tmp_path_factory.mktemp("mesh_mind")
    inputs, params = mind_inputs()
    path = tmp / "inputs.npz"
    np.savez(path, **inputs)
    started = {world: bodies.start_world(world, path, tmp, suite="mind")
               for world in bodies.MESHES}
    try:
        want = reference(inputs, params)
    except BaseException:
        for _, procs in started.values():
            for p in procs:
                p.kill()
        raise
    out = {"want": want, "inputs": inputs}
    for world, run in started.items():
        out[world] = bodies.wait_world(run, WORLD_TIMEOUT_S)
    return out


def mesh_keys(data_ranks: int = 1):
    return [(world, bodies.mesh_key(shape)) for world, shapes in
            bodies.MESHES.items() for shape in shapes
            if shape[0] >= data_ranks]


def close(got, want, what: str) -> None:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, f"{what}: {err:.3e} of max|want|"


@pytest.mark.parametrize("world,mesh", mesh_keys())
def test_mind_on_a_mesh_equals_reference(worlds, world, mesh):
    ranks, want = worlds[world], worlds["want"]
    key = f"mind|{mesh}|"
    for name in want:
        close(ranks[0][key + name], want[name], f"{mesh}: {name}")
    assert {n.split(".", 1)[1] for n in want if n.startswith("param.")} == \
        {"item_embed", "S"}
    for r, res in enumerate(ranks[1:], 1):
        for name in want:
            np.testing.assert_array_equal(res[key + name],
                                          ranks[0][key + name],
                                          err_msg=f"rank {r} of {mesh}: "
                                          f"{name}")


@pytest.mark.parametrize("world,mesh", mesh_keys(data_ranks=2))
def test_a_per_rank_softmax_is_caught(worlds, world, mesh):
    """The planted softmax over each data rank's own targets gives a loss
    the tolerance refuses, while the global one meets it."""
    want = worlds["want"]["loss"]
    got = float(worlds[world][0][f"planted|{mesh}|loss"])
    assert abs(got - want) / abs(want) > 100 * TOL, (got, want)
    close(worlds[world][0][f"mind|{mesh}|loss"], want, "loss")


def predicted_calls(mesh: str) -> tuple:
    """(all-gathers, reduce-scatters, all-reduces, others) of one train
    step on a (data, model) mesh, D data and M model ranks (an axis of one
    rank takes no collective):

    * the one lookup of the history and the targets: the vp take's sum
      over ``model`` (1 all-reduce if M > 1); its backward passes the
      cotangent through;
    * the targets gathered over ``data`` (1 all-gather if D > 1), whose
      backward adds every data rank's cotangent of this rank's targets
      (1 reduce-scatter);
    * the loss's terms summed over ``data`` (1 all-reduce if D > 1);
    * the table shard's and ``S``'s gradients summed over ``data``, the
      ranks whose users used them (2 all-reduces if D > 1);
    * AdamW's norm: the table shard's squares summed over ``model`` (1 if
      M > 1); ``S`` counted once, whole on every rank."""
    D, M = map(int, mesh.split("x"))
    d, m = int(D > 1), int(M > 1)
    return (d, d, 2 * m + 3 * d, 0)


@pytest.mark.parametrize("world,mesh", mesh_keys())
def test_step_makes_the_predicted_collectives(worlds, world, mesh):
    for r, res in enumerate(worlds[world]):
        got = tuple(int(c) for c in res[f"mind|{mesh}|calls"])
        assert got == predicted_calls(mesh), (r, got)


def test_one_rank_mesh_is_the_unsharded_step_bit_for_bit():
    """On a one-rank gloo mesh the partition is the identity path: the
    scores, the metrics, every parameter and both moments equal the
    unsharded run's exactly, with no collective."""
    inputs, _ = mind_inputs()
    whole = bodies.mind_body(None, inputs)
    shd.reset_collectives()
    placed = bodies.mind_body(make_smoke_mesh("cpu"), inputs)
    assert shd.collective_counts() == {}
    assert placed["calls"].tolist() == [0, 0, 0, 0]
    assert whole.keys() == placed.keys()
    for name, v in whole.items():
        np.testing.assert_array_equal(placed[name], v, err_msg=name)
