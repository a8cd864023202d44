"""The port's partitioned dense LM step (``models.transformer.Partition``,
``runtime.sharding``'s placement and collectives, ``adamw.global_norm``
over a mesh, ``configs.make_train_step(mesh=)`` and
``make_serve_step(mesh=)``) against the JAX package's single-device step.

The reference's own test of its sharded step,
``tests/test_distributed.py::test_smoke_train_step_sharded_8way`` (a
``(2, 4)`` mesh of eight forced CPU devices), fails in this container on
every run and is no oracle here. So every mesh is held to the reference's
single-device step instead, jitted on the CPU, which a correct partition
must reproduce.

* glm4's smoke config (4 query heads over 2 kv heads, d_model 64, the
  reference test's shapes) in f32, its parameters and AdamW state carried
  from one reference step (``lm_params_from_reference(tree, mesh)``,
  ``adamw_state_from_reference(state, mesh)``), inputs from a numpy seed.
  On the 2-, 4- and 8-rank gloo worlds of ``tests/torch_rank_bodies.py``
  (``MESHES``: (1, 2), (2, 1), (2, 2), (1, 4), (4, 1), (2, 4); the kv heads
  do not divide ``model`` at (1, 4) and (2, 4)): the prefill's logits and
  four decode steps from an empty cache of ``lm_cache_spec``'s layout
  within 1e-4 of max|logit|; one train step's loss, ``grad_norm`` and
  ``lr``, every updated parameter and both moments, gathered, within 1e-4
  of each leaf's largest |value|. The key bias's gradient sums the
  positions' key gradients, which nearly cancel, so ``bk``'s first moment
  is held to ``wk``'s scale and its parameter besides to 1e-2 of the
  learning rate (:data:`LR_SHARE`).
* One bf16 case, at (2, 2): the same within 5e-2 (PERF.md section 2's
  bf16 bound), the biases' parameters besides within 2 lr.
* codeqwen's smoke config (MHA: 4 kv heads, 2 or 1 a model rank) in f32
  at (2, 2) and (1, 4), as glm4's.
* On a one-rank gloo mesh the partitioned prefill and step are the
  unsharded ones bit for bit.
* The collectives on every mesh: ``gather_at_use``'s backward sums the
  ranks' cotangents and keeps this rank's chunk (dims 0 and 1, each
  axis), ``gather`` puts column chunks back in column order, and
  ``global_norm`` of placed leaves equals the whole tree's (replicated
  leaves counted once). ``kv_heads`` at n_kv 2 on ``model`` 4.
* The hooks on placed models: the layouts the partitioner produces check
  clean, glm4's and qwen2-moe's (its experts' buffers and weights at use,
  EP or expert TP); ``seqshard`` and a MoE placement the partitioner does
  not produce raise ``NotImplementedError`` naming the spec.
* On a one-rank gloo mesh qwen2-moe's smoke step is the unsharded one bit
  for bit too (its MoE layer runs on the whole batch there).

Each world is one run of ``torch_rank_bodies`` (every mesh shape of its
size in one process group) under a hard timeout.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.carry import lm_params_from_reference  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

import torch_rank_bodies as bodies  # noqa: E402

ARCH = "glm4-9b"
B, S = 4, 16
DECODE_STEPS = 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
WORLD_TIMEOUT_S = 150.0
#: parameters whose step is held to a share of the learning rate on top of
#: the leaf's scale, per body: AdamW moves a parameter by about lr however
#: small its gradient, so where a gradient is known only to a fair share of
#: itself the step is too. In f32 the key bias's gradient, a sum of the
#: positions' key gradients that nearly cancel, comes out ~2e-3 of itself
#: apart when the batch's rows are summed in data-parallel partial sums;
#: in bf16 the biases' small gradients are mostly rounding, so a bias may
#: step either way: within 2 lr.
LR_SHARE = {"lm": {"bk": 1e-2}, "codeqwen": {"bk": 1e-2},
            "bf16": {"bq": 2.0, "bk": 2.0, "bv": 2.0}}
#: the rank bodies' (arch, dtype)
CASES = {"lm": (ARCH, "float32"), "bf16": (ARCH, "bfloat16"),
         "codeqwen": ("codeqwen1.5-7b", "float32")}


def flat(tree, prefix: str) -> dict:
    """A nested dict of arrays as ``<prefix>/a/b`` keys, in f32 (bf16
    values are exact in f32; the ranks cast them back)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(val, np.float32)
    return out


def lm_batch(vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def reference(arch: str, dtype: str, inputs: dict) -> dict:
    """The reference's single-device answers: one step from its init gives
    the carried state (``<arch>.<dtype>.*`` in ``inputs``); from there the
    prefill's logits, the decode steps' and a second step's metrics,
    parameters and moments."""
    jspec = jax_configs.get(arch)
    jcfg = dataclasses.replace(jspec.smoke_cfg, dtype=JDT[dtype])
    params = jax_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    step = jax.jit(jax_configs.make_train_step(
        jspec, jcfg, jax_adamw.AdamWConfig(**OPT)))
    b0, b1 = lm_batch(jcfg.vocab, 0), lm_batch(jcfg.vocab, 1)
    params, state, _ = step(params, jax_adamw.init_state(params),
                            {k: jnp.asarray(v) for k, v in b0.items()})
    pre = f"{arch}.{dtype}"
    inputs.update(flat(params, f"{pre}.p"))
    inputs.update(flat(state["mu"], f"{pre}.mu"))
    inputs.update(flat(state["nu"], f"{pre}.nu"))
    inputs[f"{pre}.step"] = np.asarray(state["step"])
    want = {"logits": np.asarray(jax.jit(
        lambda p, t: jax_tfm.forward(p, jcfg, t)[0])(
            params, jnp.asarray(inputs["fwd"])), np.float32)}
    cache = jax_tfm.init_cache(jcfg, B, DECODE_STEPS + 2)
    dec = jax.jit(lambda p, t, c, n: jax_tfm.decode_step(p, jcfg, t, c, n))
    for i in range(DECODE_STEPS):
        out, cache = dec(params, jnp.asarray(inputs["dec"][i]), cache,
                         jnp.int32(i))
        want[f"decode.{i}"] = np.asarray(out, np.float32)
    params, state, m = step(params, state,
                            {k: jnp.asarray(v) for k, v in b1.items()})
    want.update({k: float(v) for k, v in m.items()})
    carry = {"param": params, "mu": state["mu"], "nu": state["nu"]}
    for what, tree in carry.items():
        host = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
        for n, t in lm_params_from_reference(host).items():
            want[f"{what}.{n}"] = t.numpy()
    return want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's answers and every rank's results of the 2-, 4- and
    8-rank worlds."""
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(5)
    vocab = configs.get(ARCH).smoke_cfg.vocab
    inputs = {"fwd": rng.integers(0, vocab, (B, S)).astype(np.int32),
              "dec": rng.integers(0, vocab, (DECODE_STEPS, B, 1)).astype(
                  np.int32),
              "mat": rng.normal(size=(8, 12)).astype(np.float32),
              "w": rng.normal(size=(8, 8, 12)).astype(np.float32)}
    inputs.update(lm_batch(vocab, 1))
    for n, shape in (("wq", (8, 12)), ("wo", (12, 8)), ("embed", (16, 8)),
                     ("ln", (8,)), ("bq", (12,))):
        inputs[f"norm.{n}"] = rng.normal(size=shape).astype(np.float32)
    want = {case: reference(*case, inputs) for case in CASES.values()}
    path = tmp / "inputs.npz"
    np.savez(path, **inputs)
    out = {"inp": inputs, "want": want}
    for world in bodies.MESHES:
        out[world] = bodies.run_world(world, path, tmp, WORLD_TIMEOUT_S,
                                      suite="mesh")
    return out


def cases():
    return [(world, bodies.mesh_key(shape))
            for world, shapes in bodies.MESHES.items() for shape in shapes]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def scale_of(want: dict, key: str) -> float:
    """A leaf's largest |value|; the key bias's first moment takes its
    layer's wk gradient scale, i.e. wk's first moment's."""
    if key.startswith("mu.") and key.endswith(".bk"):
        key = key[:-3] + ".wk"
    return float(np.abs(want[key]).max())


def check_lm(ranks, want, mesh, body, tol):
    r0 = ranks[0]
    for key in ["logits"] + [f"decode.{i}" for i in range(DECODE_STEPS)]:
        got = r0[f"{body}|{mesh}|{key}"]
        assert got.shape == want[key].shape, key
        assert rel(got, want[key]) <= tol, (key, rel(got, want[key]))
    for key in ("loss", "grad_norm", "lr"):
        vals = [float(r[f"{body}|{mesh}|{key}"]) for r in ranks]
        assert len(set(vals)) == 1, (key, vals)    # global: one value
        assert abs(vals[0] - want[key]) <= tol * abs(want[key]), (
            key, vals[0], want[key])
    leaves = [k for k in want if k.split(".")[0] in ("param", "mu", "nu")]
    assert len(leaves) == 3 * len(list(tfm.abstract_params(
        configs.get(CASES[body][0]).smoke_cfg).parameters()))
    bad = []
    for key in leaves:
        got = r0[f"{body}|{mesh}|{key}"]
        assert got.shape == want[key].shape, key
        err = float(np.abs(got.astype(np.float64) - want[key]).max())
        bound = tol * scale_of(want, key)
        if key.startswith("param."):
            bound += LR_SHARE[body].get(key.rsplit(".", 1)[-1], 0.0) * \
                OPT["lr"]
        if not err <= bound:
            bad.append((key, err, bound))
    assert not bad, bad


@pytest.mark.parametrize("world,mesh", cases())
def test_partitioned_step_forward_and_decode_equal_reference(worlds, world,
                                                             mesh):
    check_lm(worlds[world], worlds["want"][CASES["lm"]], mesh, "lm",
             TOL["float32"])


def test_partitioned_bf16_step_within_bf16_bound(worlds):
    check_lm(worlds[4], worlds["want"][CASES["bf16"]], "2x2", "bf16",
             TOL["bfloat16"])


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_partitioned_codeqwen_equal_reference(worlds, mesh):
    """codeqwen's smoke config (4 query heads over 4 kv heads, 2 or 1 of
    each a model rank; its own rope theta) at f32 1e-4."""
    check_lm(worlds[4], worlds["want"][CASES["codeqwen"]], mesh,
             "codeqwen", TOL["float32"])


@pytest.mark.parametrize("world,mesh", cases())
def test_step_issues_the_partitioners_collectives(worlds, world, mesh):
    """Per step: gathers at use (forward) and reduce-scatters (their
    backward) of the FSDP weights, and all-reduces; none over an axis of
    one rank; the same on every rank (no rank skips a collective)."""
    ranks = worlds[world]
    calls = {tuple(r[f"lm|{mesh}|calls"]) for r in ranks}
    assert len(calls) == 1
    gathers, scatters, reduces = calls.pop()
    layers = configs.get(ARCH).smoke_cfg.n_layer
    # per layer: wq, wk, wv, wo, ffn.wi, ffn.wg, ffn.wo gathered over data
    # (and wk, wv, bk, bv over model where kv heads are replicated)
    d, m = map(int, mesh.split("x"))
    per_layer = 7 * (d > 1) + 4 * (2 % m != 0)
    assert gathers == layers * per_layer + (m > 1)     # + the embedding's
    assert scatters == layers * per_layer
    assert reduces > 0


@pytest.mark.parametrize("world,mesh", cases())
def test_gather_at_use_backward_reduce_scatters(worlds, world, mesh):
    ranks, inp = worlds[world], worlds["inp"]
    d, m = map(int, mesh.split("x"))
    for r, res in enumerate(ranks):
        i_d, i_m = divmod(r, m)
        for axis, n, idx in (("data", d, i_d), ("model", m, i_m)):
            group = ([j * m + i_m for j in range(d)] if axis == "data"
                     else [i_d * m + j for j in range(m)])
            total = sum(inp["w"][g] for g in group)
            for dim in (0, 1):
                key = f"collectives|{mesh}|"
                np.testing.assert_array_equal(
                    res[key + f"gather.{axis}.{dim}"], inp["mat"])
                np.testing.assert_array_equal(
                    res[key + f"plain.{axis}.{dim}"], inp["mat"])
                chunk = np.split(total, n, axis=dim)[idx]
                np.testing.assert_allclose(res[key + f"grad.{axis}.{dim}"],
                                           chunk, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world,mesh", cases())
def test_global_norm_counts_replicated_leaves_once(worlds, world, mesh):
    for res in worlds[world]:
        got = float(res[f"collectives|{mesh}|norm"])
        whole = float(res[f"collectives|{mesh}|norm_whole"])
        assert abs(got - whole) <= 1e-6 * whole, (got, whole)


@pytest.mark.parametrize("world,mesh", cases())
def test_hooks_check_what_the_partitioner_produces(worlds, world, mesh):
    for res in worlds[world]:
        key = f"hooks|{mesh}|"
        assert bool(res[key + "hooked_equal"])
        assert bool(res[key + "hooked_moe_equal"])
        raised = [str(x) for x in res[key + "raised"]]
        assert len(raised) == 2 and not any("nothing raised" in x
                                            for x in raised), raised
        seq, moe = raised
        assert "P('data', 'model', None)" in seq and "partitioner" in seq
        assert "partitioner" in moe and "P('data', None, None)" in moe


def test_kv_heads_at_two_over_four_ranks():
    """glm4 at (., 4): rank r's 8 query heads of 32 use kv head r // 2; on
    2 ranks each rank owns one kv head; a ratio neither way raises."""
    assert [tfm.kv_heads(32, 2, 4, r) for r in range(4)] == [
        (0, 1), (0, 1), (1, 2), (1, 2)]
    assert [tfm.kv_heads(32, 2, 2, r) for r in range(2)] == [(0, 1), (1, 2)]
    assert [tfm.kv_heads(32, 32, 4, r) for r in range(4)] == [
        (8 * r, 8 * r + 8) for r in range(4)]
    assert tfm.kv_heads(4, 2, 4, 3) == (1, 2)           # the smoke config
    with pytest.raises(NotImplementedError, match="kv heads"):
        tfm.kv_heads(24, 3, 2, 0)
    with pytest.raises(NotImplementedError, match="query heads"):
        tfm.kv_heads(6, 2, 4, 0)


@pytest.mark.parametrize("remat,arch", [
    (False, ARCH), (True, ARCH), (False, "qwen2-moe-a2.7b"),
    (True, "qwen2-moe-a2.7b")],
    ids=["False", "True", "qwen2-moe-False", "qwen2-moe-True"])
def test_one_rank_mesh_is_the_unsharded_step_bit_for_bit(remat, arch):
    """On a one-rank gloo mesh the partitioner makes no exchange (each
    would be a copy): the placed model's bits, prefill, loss, norm, lr,
    parameters and moments equal the unsharded run's exactly (glm4, and
    qwen2-moe's MoE layer)."""
    spec = configs.get(arch)
    cfg = dataclasses.replace(spec.smoke_cfg, dtype=torch.float32,
                              remat=remat)
    mesh = make_smoke_mesh("cpu")
    a = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        mesh=mesh)
    assert b.mesh is mesh
    for (n, x), (k, y) in zip(a.named_parameters(), b.named_parameters()):
        assert n == k and torch.equal(x, y), n
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg.vocab, 2).items()}
    assert torch.equal(
        configs.make_serve_step(spec, "prefill_32k", cfg)(a, batch),
        configs.make_serve_step(spec, "prefill_32k", cfg, mesh=mesh)(b,
                                                                     batch))
    opt = adamw.AdamWConfig(**OPT)
    sa = adamw.init_state(dict(a.named_parameters()))
    sb = adamw.init_state(dict(b.named_parameters()))
    _, sa, ma = configs.make_train_step(spec, cfg, opt)(a, sa, batch)
    shd.reset_collectives()
    _, sb, mb = configs.make_train_step(spec, cfg, opt, mesh=mesh)(b, sb,
                                                                   batch)
    assert shd.collective_counts() == {}
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    for n in sa["mu"]:
        assert torch.equal(sa["mu"][n], sb["mu"][n])
        assert torch.equal(sa["nu"][n], sb["nu"][n])


def test_steps_refuse_an_unplaced_model_and_other_families():
    spec = configs.get(ARCH)
    cfg = dataclasses.replace(spec.smoke_cfg, dtype=torch.float32)
    mesh = make_smoke_mesh("cpu")
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg.vocab, 2).items()}
    step = configs.make_train_step(spec, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="not placed"):
        step(model, adamw.init_state(dict(model.named_parameters())), batch)
    with pytest.raises(ValueError, match="not placed"):
        configs.make_serve_step(spec, "prefill_32k", cfg, mesh=mesh)(model,
                                                                     batch)
    # MIND runs on a mesh (tests/test_torch_mesh_mind.py), a placed model
    mind = configs.get("mind")
    unplaced = configs.init_params(mind, mind.smoke_cfg,
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    users = {"hist_ids": torch.zeros((2, mind.smoke_cfg.hist_len),
                                     dtype=torch.int32),
             "hist_mask": torch.ones((2, mind.smoke_cfg.hist_len)),
             "target_id": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="not placed"):
        configs.make_train_step(mind, mind.smoke_cfg, mesh=mesh)(
            unplaced, adamw.init_state(dict(unplaced.named_parameters())),
            users)
    # the GNNs run edge-parallel on a mesh (tests/test_torch_mesh_gnn.py)
    sage = configs.get("graphsage-reddit")
    scfg = configs.cell_model_cfg(sage, "minibatch_lg", smoke=True)
    placed = configs.init_params(sage, scfg, torch.Generator().manual_seed(0),
                                 device="cpu", mesh=mesh)
    rng = np.random.default_rng(0)
    graph = {"node_feat": torch.from_numpy(rng.normal(size=(8, 8)).astype(
                 np.float32)),
             "src": torch.from_numpy(rng.integers(0, 8, 16).astype(np.int32)),
             "dst": torch.from_numpy(rng.integers(0, 8, 16).astype(np.int32)),
             "labels": torch.zeros(8, dtype=torch.int32),
             "seed_mask": torch.ones(8, dtype=torch.bool)}
    _, _, m = configs.make_train_step(sage, scfg, mesh=mesh)(
        placed, adamw.init_state(dict(placed.named_parameters())), graph)
    assert bool(torch.isfinite(m["loss"]))


def test_placement_round_trips_and_keeps_shards_contiguous():
    """``shard_params`` then ``unshard_params`` gives back every leaf; each
    shard owns a contiguous tensor; an uneven split raises."""
    mesh = make_smoke_mesh("cpu")
    cfg = dataclasses.replace(configs.get(ARCH).smoke_cfg,
                              dtype=torch.float32)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    whole = {n: p.clone() for n, p in model.named_parameters()}
    specs = shd.lm_param_spec_tree(model, mesh)
    shd.shard_params(model, specs, mesh)
    assert all(p.is_contiguous() for p in model.parameters())
    back = shd.unshard_params(model, specs, mesh)
    assert all(torch.equal(back[n], whole[n]) for n in whole)
    with pytest.raises(NotImplementedError, match="evenly"):
        shd.check_divides((6, 4), shd.P("data"), MeshShapeOf(4), "x")


class MeshShapeOf:
    """A stand-in mesh of ``n`` data ranks (sizes alone)."""

    def __init__(self, n):
        self.shape = {"data": n, "model": 1}
        self.axis_names = ("data", "model")


def test_a_cuda_mesh_of_more_ranks_than_cards_raises(monkeypatch):
    """One rank per card: a CUDA mesh wider than the visible cards raises
    before any process group is made (NCCL refuses two ranks on one card;
    nothing falls back to gloo)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    with pytest.raises(RuntimeError, match="one rank on each card"):
        lmesh.init_process_group("cuda", dist.HashStore(), 0, 4)
