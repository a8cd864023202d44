"""MeshGraphNet in the port against the JAX reference: the config surface
(cells, model configs, FLOPs, smoke dims), the weight carry, the serve
step's outputs and the loss with every gradient, at the smoke config with
and without an edge mask and at full width, the launcher's batches, and
the launcher's CLI with a checkpoint restart (MeshGraphNet, NequIP and
MACE). Inputs are drawn with numpy
from a seed; the weights are the reference's ``mgn_init``'s, carried by
``gnn_params_from_reference``; the reference runs under ``jax.jit``.

Tolerance: 1e-4 of each output's or gradient leaf's largest |value| (f32
sums and products re-associated; the rule of tests/test_torch_gnn.py);
at full depth the gradients are held in f64, within 1e-10 (see
``test_full_width_forward_and_gradients_match``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.carry import (adamw_state_from_reference,  # noqa: E402
                                    gnn_params_from_reference)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "meshgraphnet"
GNN_ARCHS = ["meshgraphnet", "nequip", "mace"]
TOL = 1e-4


def close(got, want, share=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= share, f"{what}: {err:.3e} of max|want|"


def models(cfg_over=None, smoke=True, seed=0):
    """(jax spec, jax cfg, jax params, port spec, port model) with the
    reference's weights."""
    jspec, spec = jax_configs.get(ARCH), configs.get(ARCH)
    jcfg = jax_configs.cell_model_cfg(jspec, "full_graph_sm", smoke=smoke)
    cfg = configs.cell_model_cfg(spec, "full_graph_sm", smoke=smoke)
    if cfg_over:
        jcfg = dataclasses.replace(jcfg, **cfg_over)
        cfg = dataclasses.replace(cfg, **cfg_over)
    params = jax_gnn.mgn_init(jcfg, jax.random.PRNGKey(seed))
    model = gnn.MeshGraphNet(cfg, device="cpu")
    model.load_state_dict(gnn_params_from_reference(
        jax.tree.map(np.asarray, params)))
    return jspec, jcfg, params, spec, model


def mgn_batch(cfg, n=40, e=96, masked=True, seed=1):
    rng = np.random.default_rng(seed)
    b = {"node_feat": rng.normal(size=(n, cfg.d_node_in)).astype(np.float32),
         "src": rng.integers(0, n, e).astype(np.int32),
         "dst": rng.integers(0, n, e).astype(np.int32),
         "edge_feat": rng.normal(size=(e, cfg.d_edge_in)).astype(np.float32),
         "target": rng.normal(size=(n, cfg.d_out)).astype(np.float32)}
    if masked:
        b["edge_mask"] = (rng.random(e) < 0.75).astype(np.float32)
    return b


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def port_loss_and_grads(spec, cfg, model, batch):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = configs.loss_for(spec, cfg)(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    for p in params.values():
        p.requires_grad_(False)
    return float(loss.detach()), dict(zip(params, grads))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_configs_and_flops_match_the_reference(arch):
    spec, ref = configs.get(arch), jax_configs.get(arch)
    assert (spec.family, spec.shapes, spec.skips, spec.source) == \
        (ref.family, ref.shapes, ref.skips, ref.source)
    assert dataclasses.asdict(spec.model_cfg) == \
        dataclasses.asdict(ref.model_cfg)
    assert dataclasses.asdict(spec.smoke_cfg) == \
        dataclasses.asdict(ref.smoke_cfg)
    for shape in spec.shapes:
        assert configs.smoke_dims(spec, shape) == \
            jax_configs.smoke_dims(ref, shape)
        for smoke in (False, True):
            cfg = configs.cell_model_cfg(spec, shape, smoke=smoke)
            rcfg = jax_configs.cell_model_cfg(ref, shape, smoke=smoke)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
            assert configs.model_flops(spec, shape, model_cfg=cfg) == \
                jax_configs.model_flops(ref, shape, model_cfg=rcfg)
        assert configs.model_flops(spec, shape) == \
            jax_configs.model_flops(ref, shape)


def test_carry_names_every_parameter():
    *_, spec, model = models()
    names = dict(model.named_parameters())
    assert "enc_node.0.w" in names and "layers.1.edge_mlp.2.b" in names
    cfg = model.cfg
    tree = jax_gnn.mgn_init(
        jax_configs.cell_model_cfg(jax_configs.get(ARCH), "full_graph_sm",
                                   smoke=True), jax.random.PRNGKey(3))
    state = gnn_params_from_reference(jax.tree.map(np.asarray, tree))
    assert state.keys() == names.keys()
    assert all(state[k].shape == names[k].shape for k in names)
    assert sum(p.numel() for p in names.values()) == sum(
        a.size for a in jax.tree.leaves(tree))
    assert cfg.d_node_in == 8


def test_adamw_state_carries_a_meshgraphnet_tree():
    """The reference's AdamW state of a MeshGraphNet tree carries under the
    model's names (its ``layers`` is a list, so the GNN carrier)."""
    _, _, params, _, model = models()
    jstate = jax.tree.map(np.asarray, jax_adamw.init_state(params))
    jstate["mu"] = jax.tree.map(lambda a: a + 1.5, jstate["mu"])
    state = adamw_state_from_reference(jstate)
    names = dict(model.named_parameters())
    assert state["mu"].keys() == names.keys() == state["nu"].keys()
    assert all(float(state["mu"][k].min()) == 1.5 for k in names)
    assert int(state["step"]) == 0


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_serve_step_matches_the_reference(masked):
    jspec, jcfg, params, spec, model = models()
    b = mgn_batch(model.cfg, masked=masked)
    want = jax.jit(jax_base.make_serve_step(jspec, "full_graph_sm", jcfg))(
        params, as_jax(b))
    got = configs.make_serve_step(spec, "full_graph_sm", model.cfg)(
        model, as_torch(b))
    assert got.dtype == torch.float32 and not got.requires_grad
    close(got.numpy(), want, what="outputs")


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_loss_and_every_gradient_match_jax_grad(masked):
    jspec, jcfg, params, spec, model = models()
    b = mgn_batch(model.cfg, masked=masked)
    lval, jgrads = jax.jit(jax.value_and_grad(jax_base.loss_for(
        jspec, jcfg)))(params, as_jax(b))
    loss, grads = port_loss_and_grads(spec, model.cfg, model, as_torch(b))
    assert loss == pytest.approx(float(lval), rel=1e-5)
    want = gnn_params_from_reference(jax.tree.map(np.asarray, jgrads))
    assert want.keys() == grads.keys()
    for name, g in grads.items():
        close(g.numpy(), want[name].numpy(), what=name)


def plain_f64(monkeypatch):
    """The port's plain versions in the inputs' dtype (they compute in f32,
    as the reference does with x64 off): an f64 run then holds the port's
    formulas themselves, with no f32 rounding and no relu input within
    rounding of its kink."""
    def segment_sum(vals, ids, S):
        ok = (ids >= 0) & (ids < S)
        return vals.new_zeros((S, vals.shape[1])).index_add_(
            0, ids[ok].long(), vals[ok])
    monkeypatch.setattr(ref, "matmul", lambda a, b: a @ b)
    monkeypatch.setattr(ref, "segment_sum", segment_sum)


def f64_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                        tree)


def f64_batch(b):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in b.items()}


def test_full_width_forward_and_gradients_match(monkeypatch):
    """meshgraphnet at its published width and depth (15 layers, hidden
    128, 2-layer MLPs) on a small graph: the outputs in f32 (1e-4), and
    the loss and every gradient in f64 against the reference's under
    ``jax.enable_x64`` (1e-10 of each leaf's scale). In f32 at this depth
    one relu input of this graph lies within 1e-6 of 0 and takes the
    other sign in the port's sum order, which moves a leaf's gradient by
    1.2e-4 of its scale: both gradients are then right, for two sides of
    the kink, so the gradients are held to the reference in f64."""
    jspec, jcfg, params, spec, model = models(smoke=False)
    assert (model.cfg.n_layers, model.cfg.d_hidden) == (15, 128)
    b = mgn_batch(model.cfg, n=48, e=128, seed=4)
    want = jax.jit(jax_base.make_serve_step(jspec, "full_graph_sm", jcfg))(
        params, as_jax(b))
    got = configs.make_serve_step(spec, "full_graph_sm", model.cfg)(
        model, as_torch(b))
    close(got.numpy(), want, what="outputs")
    with jax.enable_x64(True):
        lval, jgrads = jax.jit(jax.value_and_grad(jax_base.loss_for(
            jspec, jcfg)))(f64_tree(params), as_jax(f64_batch(b)))
        lval, jgrads = float(lval), jax.tree.map(np.asarray, jgrads)
    plain_f64(monkeypatch)
    loss, grads = port_loss_and_grads(spec, model.cfg, model.double(),
                                      as_torch(f64_batch(b)))
    assert loss == pytest.approx(lval, rel=1e-12)
    want = gnn_params_from_reference(jgrads)
    for name, g in grads.items():
        assert g.dtype == torch.float64
        close(g.numpy(), want[name].numpy(), share=1e-10, what=name)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_batch_fn_arrays_equal_the_references(arch):
    """``launch.train.make_batch_fn`` at the smoke dims: the reference's
    arrays, name for name, bit for bit, for two steps."""
    spec, jspec = configs.get(arch), jax_configs.get(arch)
    shape = "full_graph_sm"
    dims = configs.smoke_dims(spec, shape)
    cfg = configs.cell_model_cfg(spec, shape, smoke=True)
    jcfg = jax_configs.cell_model_cfg(jspec, shape, smoke=True)
    fn = train.make_batch_fn(spec, cfg, dims, device="cpu")
    jfn = jax_train.make_batch_fn(jspec, jcfg, dims)
    for step in (0, 3):
        got, want = fn(step), jfn(step)
        assert got.keys() == want.keys()
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_train_step_updates_the_model_and_matches_one_reference_step():
    """One ``make_train_step`` step on a launcher batch: the loss and every
    updated parameter against the reference's step from the same weights
    and AdamW state (f32: 1e-4 of each parameter's scale)."""
    jspec, jcfg, params, spec, model = models()
    dims = configs.smoke_dims(spec, "full_graph_sm")
    b = train.make_batch_fn(spec, model.cfg, dims, device="cpu")(0)
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jopt = jax_adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_base.make_train_step(jspec, jcfg, jopt))
    jparams, _, jm = jstep(params, jax_adamw.init_state(params),
                           {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    step = configs.make_train_step(spec, model.cfg, opt)
    state = adamw.init_state(dict(model.named_parameters()))
    _, _, m = step(model, state, b)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = gnn_params_from_reference(jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        close(p.detach().numpy(), want[name].numpy(), what=name)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_cli_trains_with_a_checkpoint_restart(arch, tmp_path, capsys):
    losses = train.main(["--arch", arch, "--smoke", "--steps", "6",
                         "--device", "cpu", "--log-every", "1",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                         "--inject-failure", "3"])
    out = capsys.readouterr().out
    assert "restarts=1 steps_lost=1" in out
    assert len(losses) == 7 and all(np.isfinite(losses))
    # the replayed step 2 gives the loss it gave first
    lines = [ln for ln in out.splitlines() if ln.startswith("step     2")]
    assert len(lines) == 2 and lines[0] == lines[1]
