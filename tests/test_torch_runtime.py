"""The port's runtime (``repro_torch.runtime``, ``optim.compression``,
``launch.mesh``) against the JAX reference and against single-device
answers. Inputs are drawn with numpy from a seed.

* Specs: every family's policies equal the reference's leaf for leaf on
  the same configs, on stand-in meshes of the production sizes (16 x 16
  and 2 x 16 x 16) and on the card's (1, 1). A port layer's spec is the
  reference's without the stacked L axis's leading ``None``.
* The vp take on one rank equals the reference's on a (1, 1) mesh, ids
  ``n``, ``-1`` and ``-n-1`` included (zero rows, no gradient), forward
  exactly and the gradient within 1e-6; on 2, 4 and 8 gloo ranks the forward
  equals and the table's gradient equals the single-device one (1e-6:
  the ranks' partial sums are added in another order).
* The a2a MoE at ``capacity_factor=8.0`` within 1e-4 of max|out| of the
  reference's ``moe_ffn`` (f32), the bound the reference's own test sets
  its a2a (there absolute, at outputs near 1; this layer's reach 1e3, so
  relative, as tests/test_torch_moe.py holds the MoE layer), at 1, 2, 4
  and 8 ranks; its gradients finite, and equal to the reference's a2a
  gradients at one rank and to the single-device ones at 2, 4 and 8 ranks
  (1e-4 of each leaf's largest |value|). At a binding capacity it drops
  what the reference's a2a drops.
* Compression: ``quantize``, ``compress_update``, the error bit-equal to
  the reference's; the compressed mean at 2, 4 and 8 ranks on distinct
  per-rank gradients equal to the reference's formula; the reference's
  convergence check.
* ``remesh`` degrades axes the mesh lacks, as ``tests/test_fault.py``.

Multi-rank runs are processes of ``tests/torch_rank_bodies.py``, each
world under its own hard timeout with a ``FileStore`` under ``tmp_path``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.optim import compression as jax_comp  # noqa: E402
from repro.runtime import sharding as jax_shd  # noqa: E402
from repro.runtime.moe_a2a import make_a2a_moe as jax_make_a2a  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core.carry import mind_params_from_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, make_production_mesh,  # noqa: E402
                                     make_smoke_mesh)
from repro_torch.models import recsys  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime.moe_a2a import make_a2a_moe  # noqa: E402

import torch_rank_bodies as bodies  # noqa: E402

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "1x1": MeshShape(("data", "model"), (1, 1))}
LM_ARCHS = ["glm4-9b", "codeqwen1.5-7b", "qwen1.5-110b", "qwen2-moe-a2.7b",
            "dbrx-132b"]
ALL_ARCHS = LM_ARCHS + ["meshgraphnet", "nequip", "graphsage-reddit",
                        "mace", "mind"]


def norm(spec) -> tuple:
    """A spec's entries as tuples of axis names (``()`` replicated)."""
    out = []
    for part in tuple(spec):
        if part is None:
            out.append(())
        elif isinstance(part, str):
            out.append((part,))
        else:
            out.append(tuple(part))
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def ref_leaves(tree) -> dict:
    """``{dotted path: leaf}`` of a reference pytree (specs as leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def port_to_ref_name(name: str) -> tuple[str, bool]:
    """A port LM parameter's reference path, and whether it is stacked."""
    keys = name.split(".")
    if keys[0] == "layers":
        return ".".join(["layers"] + keys[2:]), True
    return name, False


# ----------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_and_opt_specs_equal_reference(arch, mesh):
    m = MESHES[mesh]
    jspec, spec = jax_configs.get(arch), configs.get(arch)
    jcfg = jax_configs.cell_model_cfg(jspec, "train_4k")
    cfg = configs.cell_model_cfg(spec, "train_4k")
    want = ref_leaves(jax_configs.param_specs(
        jspec, jax_configs.abstract_params(jspec, jcfg), m))
    got = configs.param_specs(spec, configs.abstract_params(spec, cfg), m)
    assert set(port_to_ref_name(n)[0] for n in got) == set(want)
    for name, s in got.items():
        ref_name, stacked = port_to_ref_name(name)
        w = tuple(want[ref_name])
        assert norm(s) == norm(w[1:] if stacked else w), (name, s, w)
    opt = configs.opt_specs(got)
    assert opt["mu"] is got and opt["nu"] is got and tuple(opt["step"]) == ()
    # EP where the experts divide the model axis, TP inside them otherwise
    if arch in ("qwen2-moe-a2.7b", "dbrx-132b"):
        ep = cfg.moe.e_total % m.shape["model"] == 0
        assert norm(got["layers.0.moe.wi"]) == (
            (("model",), ("data",)) if ep else ((), ("data",), ("model",)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_specs_equal_reference(arch, mesh):
    """Every cell's batch specs, the decode cache's too (kv heads that
    divide the model axis and that do not)."""
    m = MESHES[mesh]
    jspec, spec = jax_configs.get(arch), configs.get(arch)
    for shape in spec.shapes:
        if shape in spec.skips:
            continue
        jbatch = jax_configs.input_specs(jspec, shape)
        batch = configs.input_specs(spec, shape)
        want = ref_leaves(jax_configs.batch_specs(jspec, shape, jbatch, m))
        got = configs.batch_specs(spec, shape, batch, m)
        flat = {f"{k}.{kk}" if isinstance(v, dict) else k: vv
                for k, v in got.items()
                for kk, vv in (v.items() if isinstance(v, dict)
                               else [(None, v)])}
        assert set(flat) == set(want), (shape, set(flat) ^ set(want))
        for k, s in flat.items():
            assert norm(s) == norm(want[k]), (shape, k, s, want[k])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["meshgraphnet", "nequip",
                                  "graphsage-reddit", "mace", "mind"])
def test_gnn_and_mind_param_specs_equal_reference(arch, mesh):
    m = MESHES[mesh]
    jspec, spec = jax_configs.get(arch), configs.get(arch)
    shape = next(iter(spec.shapes))
    jcfg = jax_configs.cell_model_cfg(jspec, shape)
    cfg = configs.cell_model_cfg(spec, shape)
    want = ref_leaves(jax_configs.param_specs(
        jspec, jax_configs.abstract_params(jspec, jcfg), m))
    got = configs.param_specs(spec, configs.abstract_params(spec, cfg), m)
    assert len(got) == len(want)
    if arch == "mind":
        assert {k: norm(v) for k, v in got.items()} == \
            {k: norm(v) for k, v in want.items()}
    else:
        assert all(norm(s) == () for s in list(got.values())
                   + list(want.values()))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("n_kv", [1, 2, 8, 16, 32])
def test_lm_cache_spec_divisibility(n_kv, mesh):
    m = MESHES[mesh]
    assert {k: norm(v) for k, v in shd.lm_cache_spec(m, n_kv).items()} == \
        {k: norm(v) for k, v in jax_shd.lm_cache_spec(m, n_kv).items()}
    assert shd.dp_axes(m) == jax_shd.dp_axes(m)


def test_named_placements_on_the_smoke_mesh():
    """``named`` gives one placement per mesh axis; a spec naming an axis
    twice or one the mesh lacks raises; ``place`` distributes."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_smoke_mesh("cpu")
    assert shd.named(mesh, shd.P(None, "model")).placements == \
        (Replicate(), Shard(1))
    assert shd.named(mesh, shd.P(("data", "model"))).placements == \
        (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="twice"):
        shd.named(mesh, shd.P("data", "data"))
    with pytest.raises(ValueError, match="pod"):
        shd.named(mesh, shd.P("pod"))
    x = torch.arange(12.0).reshape(3, 4)
    placed = shd.place(x, shd.named(mesh, shd.P("data", None)))
    assert torch.equal(placed.full_tensor(), x)
    assert shd.shard_shape((17, 5), shd.P("model", None),
                           MESHES["16x16"]) == (2, 5)


# ----------------------------------------------------------------------
# the vocab-parallel lookup
# ----------------------------------------------------------------------

N_ROWS, DIM = 64, 16


def vp_inputs(seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N_ROWS, DIM)).astype(np.float32)
    ids = rng.integers(0, N_ROWS, (8, 5)).astype(np.int32)
    ids[0, :3] = [N_ROWS, -1, -N_ROWS - 1]          # out of range: 0 rows
    ids[1] = ids[2]                                 # repeated rows
    w = rng.normal(size=(8, 5, DIM)).astype(np.float32)
    return table, ids, w


def test_vp_take_one_rank_equals_reference():
    table, ids, w = vp_inputs()
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jtake = jax_shd.make_vp_take(jmesh, leading=("data",))
    want = np.asarray(jax.jit(jtake)(jnp.asarray(table), jnp.asarray(ids)))
    want_g = np.asarray(jax.jit(jax.grad(
        lambda t: jnp.sum(jtake(t, jnp.asarray(ids)) * w)))(
            jnp.asarray(table)))
    take = shd.make_vp_take(make_smoke_mesh("cpu"), leading=("data",))
    t = torch.from_numpy(table).requires_grad_(True)
    got = take(t, torch.from_numpy(ids))
    (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), t)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert not got[0, :3].any()
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)


def test_vp_take_in_range_bit_equal_to_ops_take():
    """On one rank, for ids in range, the vp take is ``ops.take``: rows and
    the table's gradient (both B4 over the same ids) bit for bit."""
    table, ids, w = vp_inputs(1)
    ids = np.abs(ids) % N_ROWS
    take = shd.make_vp_take(make_smoke_mesh("cpu"), leading=None)
    outs = []
    for fn in (take, ops.take):
        t = torch.from_numpy(table).requires_grad_(True)
        rows = fn(t, torch.from_numpy(ids))
        (g,) = torch.autograd.grad((rows * torch.from_numpy(w)).sum(), t)
        outs.append((rows.detach(), g))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("kind", ["train_batch", "serve_p99",
                                  "retrieval_cand"])
def test_mind_steps_through_vp_take_equal_default(kind):
    """MIND's steps with ``take_fn``/``cand_take_fn`` = the vp take on one
    rank give the default lookup's scores, loss and gradients bit for
    bit."""
    spec = configs.get("mind")
    cfg = dataclasses.replace(spec.smoke_cfg)
    rng = np.random.default_rng(3)
    model = recsys.MIND(cfg, device="cpu")
    with torch.no_grad():
        model.item_embed.copy_(torch.from_numpy(rng.normal(
            size=(cfg.n_items, cfg.embed_dim)).astype(np.float32) * 0.02))
        model.S.copy_(torch.from_numpy(rng.normal(
            size=(cfg.embed_dim,) * 2).astype(np.float32) / 4))
    B, H = 16, cfg.hist_len
    batch = {"hist_ids": torch.from_numpy(rng.integers(
                 0, cfg.n_items, (B, H)).astype(np.int32)),
             "hist_mask": torch.from_numpy((rng.random((B, H)) < 0.8)
                                           .astype(np.float32))}
    mesh = make_smoke_mesh("cpu")
    dp = shd.dp_axes(mesh)
    if kind == "train_batch":
        batch["target_id"] = torch.from_numpy(rng.integers(
            0, cfg.n_items, B).astype(np.int32))
        res = []
        for tf in (None, shd.make_vp_take(mesh, leading=dp)):
            params = dict(model.named_parameters())
            for p in params.values():
                p.requires_grad_(True)
            loss = configs.loss_for(spec, cfg, take_fn=tf)(model, batch)
            res.append([loss.detach()] + list(torch.autograd.grad(
                loss, list(params.values()))))
        for a, b in zip(*res):
            assert torch.equal(a, b)
        return
    if kind == "serve_p99":
        batch["cand_ids"] = torch.from_numpy(rng.integers(
            0, cfg.n_items, (B, 7)).astype(np.int32))
        tfs = (shd.make_vp_take(mesh, leading=dp),) * 2
    else:
        batch = {k: v[:1] for k, v in batch.items()}
        batch["cand_ids"] = torch.from_numpy(rng.integers(
            0, cfg.n_items, 300).astype(np.int32))
        tfs = (shd.make_vp_take(mesh, leading=None),
               shd.make_vp_take(mesh, leading=dp))
    want = configs.make_serve_step(spec, kind, cfg)(model, batch)
    got = configs.make_serve_step(spec, kind, cfg, take_fn=tfs[0],
                                  cand_take_fn=tfs[1])(model, batch)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# the a2a MoE on one rank
# ----------------------------------------------------------------------

def jax_moe_cfg(**over):
    mcfg = jax_tfm.MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                             capacity_factor=8.0, n_shared=1)
    mcfg = dataclasses.replace(mcfg, **over)
    return jax_tfm.LMConfig("t", n_layer=1, d_model=64, n_head=2, n_kv=2,
                            d_ff=0, vocab=64, d_head=16, moe=mcfg,
                            dtype=jnp.float32, remat=False)


def moe_inputs(seed=0):
    """The reference layer's parameters (numpy), x and a cotangent."""
    params = jax_tfm.init_params(jax_moe_cfg(), jax.random.PRNGKey(seed))
    lp = {k: np.asarray(v[0]) for k, v in params["layers"]["moe"].items()}
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(8, 16, 64)).astype(np.float32)
    w = rng.normal(size=(8, 16, 64)).astype(np.float32)
    return lp, x, w


def port_moe(lp, cfg):
    p = tfm.MoE(cfg, device="cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(lp[name])))
            t.requires_grad_(True)
    return p


def port_cfg(**over):
    cfg = bodies.moe_cfg()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_a2a_one_rank_equals_reference(capacity_factor):
    """At a capacity that does not bind the a2a equals the reference's
    ``moe_ffn`` (and its a2a); at one that binds (0.5: C rounded to a
    multiple of 8, not 32) it drops what the reference's a2a drops."""
    lp, x, w = moe_inputs()
    jcfg = jax_moe_cfg(capacity_factor=capacity_factor)
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    ja2a = jax_make_a2a(jmesh, ("data",))
    want, want_aux = jax.jit(lambda p, xx: ja2a(p, jcfg, xx))(jlp, x)
    want_g = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(ja2a(p, jcfg, xx)[0] * w), argnums=(0, 1)))(
            jlp, jnp.asarray(x))
    cfg = port_cfg(capacity_factor=capacity_factor)
    p = port_moe(lp, cfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = make_a2a_moe(make_smoke_mesh("cpu"), ("data",))(p, cfg, xt)
    assert rel_err(out.detach().numpy(), want) <= 1e-4
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    if capacity_factor == 8.0:
        ref_out, _ = jax.jit(jax_tfm.moe_ffn, static_argnums=1)(
            jlp, jcfg, jnp.asarray(x))
        assert rel_err(out.detach().numpy(), ref_out) <= 1e-4
    params = dict(p.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [xt, *params.values()])
    wants = [want_g[1]] + [want_g[0][n] for n in params]
    for name, g, wg in zip(["x", *params], grads, wants):
        assert np.isfinite(g.numpy()).all(), name
        assert rel_err(g.numpy(), wg) <= 1e-4, name


def test_moe_impl_hook_routes_moe_ffn():
    """``set_moe_impl`` replaces ``moe_ffn``'s routed path; None restores
    it."""
    lp, x, _ = moe_inputs(2)
    cfg = port_cfg()
    p = port_moe(lp, cfg)
    calls = []

    def impl(pp, cc, xx):
        calls.append(xx.shape)
        return xx * 0, torch.zeros(())
    tfm.set_moe_impl(impl)
    try:
        out, _ = tfm.moe_ffn(p, cfg, torch.from_numpy(x))
    finally:
        tfm.set_moe_impl(None)
    assert calls == [(8, 16, 64)] and not out.any()
    out, _ = tfm.moe_ffn(p, cfg, torch.from_numpy(x))
    assert out.abs().max() > 0


def test_sharding_hooks_identity_on_one_rank_raise_on_more():
    """The LM and GNN hooks check layouts: a forward with every hook set on
    the (1, 1) mesh equals the forward without. On a mesh of more ranks
    (16 x 16) a layout the LM partitioner produces checks clean against
    its local shard, and one it does not produce raises
    ``NotImplementedError`` naming the spec: the dry run's ``seqshard``
    residual, and a MoE placement (the partitioner runs no MoE layer on
    several ranks). The GNN hook raises on more than one rank."""
    from repro_torch.models import gnn
    spec = configs.get("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(spec.smoke_cfg, dtype=torch.float32)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    want, _ = tfm.forward(model, tokens)
    mesh = make_smoke_mesh("cpu")
    P = shd.P
    tfm.set_activation_sharding(shd.named(mesh, P("data", None, None)))
    tfm.set_moe_sharding((shd.named(mesh, P(None, "data", None)),
                          shd.named(mesh, P(None, "data", "model"))))
    tfm.set_weight_use_sharding({"attn.wq": shd.named(mesh, P(None, "model")),
                                 "moe.wi": shd.named(mesh,
                                                     P(None, None, "model"))})
    try:
        got, _ = tfm.forward(model, tokens)
        m16 = MESHES["16x16"]
        big = shd.NamedPlacement(m16, P("data", None, None))
        produced = (P("data", None, None), (32, 16, 64), m16)
        x = torch.zeros(2, 16, 64)
        assert tfm.check_layout(x, big, produced) is x
        seq = shd.NamedPlacement(m16, P("data", "model", None))
        with pytest.raises(NotImplementedError,
                           match=r"P\('data', 'model', None\)"):
            tfm.check_layout(x, seq, produced)
        tfm.set_activation_sharding(None)
        tfm.set_moe_sharding((shd.NamedPlacement(m16, P(None, "data", None)),
                              shd.NamedPlacement(m16, P(None, "data",
                                                        "model"))))
        with pytest.raises(NotImplementedError,
                           match=r"P\(None, 'data', None\).*partitioner"):
            tfm.forward(model, tokens)
        gnn.set_node_sharding(big)
        with pytest.raises(NotImplementedError, match="partitioner"):
            gnn._constrain_nodes(torch.zeros(4, 2))
    finally:
        tfm.set_activation_sharding(None)
        tfm.set_moe_sharding(None)
        tfm.set_weight_use_sharding(None)
        gnn.set_node_sharding(None)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# compression and remesh
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_compress_update_bit_equal_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(128, 64)) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, 2.5]                # ties at scale 1
    e = (rng.normal(size=g.shape) * 1e-3).astype(np.float32)
    jq, js = jax_comp.quantize(jnp.asarray(g))
    q, s = compression.quantize(torch.from_numpy(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    jq, js, je = jax_comp.compress_update(jnp.asarray(g), jnp.asarray(e))
    q, s, ne = compression.compress_update(torch.from_numpy(g),
                                           torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    assert ne.numpy().tobytes() == np.asarray(je).tobytes()
    np.testing.assert_array_equal(
        compression.dequantize(q, s).numpy(),
        np.asarray(jax_comp.dequantize(jq, js)))
    back = compression.dequantize(*compression.quantize(torch.from_numpy(g)))
    assert (back - torch.from_numpy(g)).abs().max() <= s * 0.5 + 1e-6


def test_error_feedback_converges_on_toy_problem():
    """The reference's check (tests/test_fault.py): SGD with int8
    error-feedback compression drives a quadratic to its optimum."""
    w = torch.tensor([3.0, -2.0, 1.5])
    target = torch.tensor([-1.0, 0.5, 2.0])
    err = torch.zeros_like(w)
    for _ in range(300):
        g = 2 * (w - target)
        q, s, err = compression.compress_update(g, err)
        w = w - 0.1 * compression.dequantize(q, s)
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=1e-2)


def test_compressed_mean_one_rank_within_half_a_step():
    """The reference's bound on its 8-way replicated test, here on the
    card's one-rank mesh: the mean within 0.51 scale of the gradient."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))}
    f = compression.make_compressed_grad_allreduce(make_smoke_mesh("cpu"))
    mean, _ = f(g, compression.init_error_state(g))
    scale = g["w"].abs().max() / 127.0
    assert (mean["w"] - g["w"]).abs().max() <= scale * 0.51 + 1e-6


def test_remesh_degrades_missing_axes():
    mesh = make_smoke_mesh("cpu")
    host = {"w": np.arange(16.0).reshape(4, 4)}
    placed = elastic.remesh(host, {"w": shd.P("data", "model")}, mesh)
    np.testing.assert_array_equal(placed["w"].full_tensor().numpy(),
                                  host["w"])
    placed2 = elastic.remesh(host, {"w": shd.P(("pod", "data"), None)}, mesh)
    np.testing.assert_array_equal(placed2["w"].full_tensor().numpy(),
                                  host["w"])
    assert elastic.degrade(shd.P(("pod", "data"), "x"), {"data"}) == \
        shd.P(("data",), None)
    shs = elastic.spec_tree_to_shardings({"a": [shd.P("data")]}, mesh)
    assert shs["a"][0].spec == shd.P("data")


def test_checkpoint_restore_then_remesh_bit_equal(tmp_path):
    """A MIND checkpoint restored on the host and remeshed onto the card's
    mesh under its specs, bit for bit."""
    spec = configs.get("mind")
    cfg = spec.smoke_cfg
    rng = np.random.default_rng(5)
    tree = {"item_embed": rng.normal(size=(cfg.n_items, cfg.embed_dim))
            .astype(np.float32), "S": rng.normal(size=(cfg.embed_dim,) * 2)
            .astype(np.float32)}
    state = mind_params_from_reference(tree)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    _, restored, _ = mgr.restore(device="cpu")
    mesh = make_smoke_mesh("cpu")
    placed = elastic.remesh(restored, configs.param_specs(spec, state, mesh),
                            mesh)
    for k, v in tree.items():
        assert placed[k].full_tensor().numpy().tobytes() == v.tobytes()


# ----------------------------------------------------------------------
# 2, 4 and 8 gloo ranks
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Inputs, single-device answers and every rank's results at 2, 4 and
    8 ranks (one run of ``torch_rank_bodies`` per world size)."""
    tmp = tmp_path_factory.mktemp("ranks")
    table, ids, w = vp_inputs()
    lp, x, w_moe = moe_inputs()
    rng = np.random.default_rng(9)
    g = (rng.normal(size=(4, 32, 8)) * [[[1.0]], [[3.0]], [[0.1]],
                                         [[10.0]]]).astype(np.float32)
    e = (rng.normal(size=(4, 32, 8)) * 1e-2).astype(np.float32)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, table=table, ids=ids, w=w, x=x, w_moe=w_moe, g=g, e=e,
             **{f"moe.{k}": v for k, v in lp.items()}, **double_inputs(),
             **ordered_inputs())
    inp = dict(np.load(inputs))
    mesh = make_smoke_mesh("cpu")
    single = {f"{k}": v for k, v in
              bodies.vp_take_body(mesh, inp).items()}
    single.update({f"a2a.{k}": v for k, v in
                   bodies.a2a_body(mesh, inp).items()})
    jcfg = jax_moe_cfg()
    ref_out, _ = jax.jit(jax_tfm.moe_ffn, static_argnums=1)(
        {k: jnp.asarray(v) for k, v in lp.items()}, jcfg, jnp.asarray(x))
    single["ref_moe"] = np.asarray(ref_out)
    single.update({f"double.{k}": v for k, v in
                   bodies.double_body(None, inp).items()})
    return {"inp": inp, "single": single,
            **{world: bodies.run_world(world, inputs, tmp)
               for world in bodies.MESHES}}


def cases():
    return [(world, bodies.mesh_key(shape))
            for world, shapes in bodies.MESHES.items() for shape in shapes]


def double_inputs(n=12, e=64, seed=4) -> dict:
    """``torch_rank_bodies.double_body``'s graph: f64 positions, a (3, 4)
    weight, ``e`` random edges (a multiple of 8), force targets."""
    rng = np.random.default_rng(seed)
    return {"dd.pos": rng.normal(size=(n, 3)),
            "dd.w": rng.normal(size=(3, 4)),
            "dd.src": rng.integers(0, n, e).astype(np.int32),
            "dd.dst": rng.integers(0, n, e).astype(np.int32),
            "dd.target": rng.normal(size=(n, 3))}


@pytest.mark.parametrize("world,mesh", cases())
def test_second_derivative_through_the_collectives_equals_one_rank(
        worlds, world, mesh):
    """A loss on ``grad_sum``'s backward (forces taken with
    ``create_graph``) differentiated once more: every rank's forces and
    second-order gradient equal the one-device ones (f64, 1e-12): the
    backward of ``grad_sum`` is a differentiable ``psum``, whose own
    backward sums each rank's second-order terms (a ``grad_sum``)."""
    single = worlds["single"]
    for r in worlds[world]:
        for name in ("forces", "grad"):
            got, want = r[f"double|{mesh}|{name}"], single[f"double.{name}"]
            assert rel_err(got, want) <= 1e-12, (name, rel_err(got, want))


def ordered_inputs(seed=6) -> dict:
    """``torch_rank_bodies.ordered_sum_body``'s tensors, one (9, 7) f32 a
    rank for up to 8 ranks, over magnitudes 1e-4..1e4 so that the order
    of the adds shows in the bits."""
    rng = np.random.default_rng(seed)
    return {"os.x": (rng.normal(size=(8, 9, 7))
                     * 10.0 ** rng.integers(-4, 5, (8, 9, 7))
                     ).astype(np.float32)}


def in_order(xs) -> np.ndarray:
    out = xs[0].copy()
    for x in xs[1:]:
        out = (out + x).astype(np.float32)
    return out


@pytest.mark.parametrize("world,mesh", cases())
def test_sum_adds_in_rank_order_on_both_routes(worlds, world, mesh):
    """``all_reduce``'s sum over each axis equals the ranks' tensors added
    in the group's rank order, bit for bit, by the gather and by the
    exchange (padded chunks and whole ones), and the first 2 rows summed
    alone equal those rows of the whole sum; over three or more ranks the
    data are such that the reverse order would round otherwise."""
    xs = worlds["inp"]["os.x"]
    for r in worlds[world]:
        for a in ("data", "model"):
            order = [int(i) for i in r[f"ordered|{mesh}|{a}|ranks"]]
            want = in_order([xs[i] for i in order])
            keys = ["gather", "exchange"] + (
                ["direct.whole"] if len(order) > 1 else [])
            for k in keys:
                got = r[f"ordered|{mesh}|{a}|{k}"]
                assert got.tobytes() == want.tobytes(), (a, k)
            assert r[f"ordered|{mesh}|{a}|rows"].tobytes() == \
                want[:2].tobytes(), a
            if len(order) > 1:
                assert r[f"ordered|{mesh}|{a}|direct.rows8"].tobytes() == \
                    want[:8].tobytes(), a
            if len(order) > 2:
                assert not np.array_equal(
                    in_order([xs[i] for i in order[::-1]]), want), a


def gathered(ranks, key, mesh_key):
    """The ranks' data shards of a result, concatenated in data order (the
    model ranks of one data index hold the same rows)."""
    d, m = map(int, mesh_key.split("x"))
    return np.concatenate([ranks[i * m][key] for i in range(d)])


@pytest.mark.parametrize("world,mesh", cases())
def test_vp_take_ranks_equal_single_device(worlds, world, mesh):
    ranks, single = worlds[world], worlds["single"]
    out = gathered(ranks, f"vp|{mesh}|out", mesh)
    np.testing.assert_array_equal(out, single["out"])
    for r in ranks:
        np.testing.assert_allclose(r[f"vp|{mesh}|grad"], single["grad"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world,mesh", cases())
def test_a2a_ranks_equal_reference_moe_ffn(worlds, world, mesh):
    ranks, single = worlds[world], worlds["single"]
    out = gathered(ranks, f"a2a|{mesh}|out", mesh)
    assert rel_err(out, single["ref_moe"]) <= 1e-4
    names = [k.split("|")[-1] for k in ranks[0]
             if k.startswith(f"a2a|{mesh}|grad.")]
    assert "grad.x" in names and "grad.router" in names
    for r in ranks:
        for n in names:
            g = r[f"a2a|{mesh}|{n}"]
            want = single[f"a2a.{n}"]
            assert np.isfinite(g).all(), n
            assert rel_err(g, want) <= 1e-4, n


@pytest.mark.parametrize("world,mesh", cases())
def test_compressed_mean_ranks_equal_reference_formula(worlds, world, mesh):
    """Each rank's mean is ``sum(q) * mean(scale) / n`` of the reference's
    per-rank ``compress_update``, in f32, the scales added in rank order;
    each rank's new error is its own."""
    ranks, inp = worlds[world], worlds["inp"]
    d, m = map(int, mesh.split("x"))
    qs, ss = [], []
    for i in range(d):
        q, s, ne = jax_comp.compress_update(jnp.asarray(inp["g"][i]),
                                            jnp.asarray(inp["e"][i]))
        qs.append(np.asarray(q).astype(np.int32))
        ss.append(np.float32(s))
        for j in range(m):
            got = ranks[i * m + j][f"compress|{mesh}|new_error"]
            assert got.tobytes() == np.asarray(ne).tobytes()
    acc = ss[0]
    for s in ss[1:]:
        acc = np.float32(acc + s)
    n = np.float32(d)
    want = (sum(qs).astype(np.float32) * np.float32(acc / n)) / n
    for r in ranks:
        assert r[f"compress|{mesh}|mean"].tobytes() == want.tobytes()
