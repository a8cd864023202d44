"""MIND (recsys) in the port against the JAX reference: the config surface
(cells, configs, FLOPs, smoke dims), the weight and AdamW carry, the
interests, label-aware attention, the loss and its gradients, serving,
retrieval, one train step, ``embedding_bag`` and ``segment_sum_sorted``,
the interaction stream, ``jnp.take``'s rules for ids out of range, the
launcher's CLI with a checkpoint restart, and the plain mirror of B5's
f32 K split. Inputs are drawn with numpy from a seed; the weights are the
reference's ``mind_init``'s, carried by ``mind_params_from_reference``.

Tolerance: rtol = atol = 1e-5 on outputs and the loss (f32 sums
re-associated over at most d = 16 terms, or the batch's logits), 1e-4 of
each gradient leaf's largest |value| (the gradients add more terms: the
table's sums every row that looked an item up)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro.data.recsys_data import \
    InteractionStream as JaxStream  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import segment_matmul as jax_sm  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.carry import (adamw_state_from_reference,  # noqa: E402
                                    mind_params_from_reference)
from repro_torch.data.recsys_data import InteractionStream  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "mind"
RTOL = ATOL = 1e-5
GRAD_TOL = 1e-4


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def grad_close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= GRAD_TOL, f"{what}: {err:.3e} of max|want|"


def models(cfg_over=None, seed=0):
    """(jax spec, jax cfg, jax params, port spec, port model) at the smoke
    config, with the reference's weights."""
    jspec, spec = jax_configs.get(ARCH), configs.get(ARCH)
    jcfg, cfg = jspec.smoke_cfg, spec.smoke_cfg
    if cfg_over:
        jcfg = dataclasses.replace(jcfg, **cfg_over)
        cfg = dataclasses.replace(cfg, **cfg_over)
    params = jax_recsys.mind_init(jcfg, jax.random.PRNGKey(seed))
    model = recsys.MIND(cfg, device="cpu")
    model.load_state_dict(mind_params_from_reference(
        jax.tree.map(np.asarray, params)))
    return jspec, jcfg, params, spec, model


def mind_batch(cfg, B=5, C=12, masked=True, seed=1):
    rng = np.random.default_rng(seed)
    H = cfg.hist_len
    mask = ((rng.random((B, H)) < 0.8) if masked
            else np.ones((B, H), bool)).astype(np.float32)
    return {"hist_ids": rng.integers(0, cfg.n_items, (B, H)).astype(np.int32),
            "hist_mask": mask,
            "target_id": rng.integers(0, cfg.n_items, B).astype(np.int32),
            "cand_ids": rng.integers(0, cfg.n_items, (B, C)).astype(np.int32)}


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}


def port_loss_and_grads(model, batch):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = recsys.mind_loss(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    for p in params.values():
        p.requires_grad_(False)
    return float(loss.detach()), dict(zip(params, grads))


def test_config_cells_and_flops_match_the_reference():
    spec, jspec = configs.get(ARCH), jax_configs.get(ARCH)
    assert (spec.family, spec.shapes, spec.skips, spec.source) == \
        (jspec.family, jspec.shapes, jspec.skips, jspec.source)
    assert configs.RECSYS_SHAPES == jax_base.RECSYS_SHAPES
    assert dataclasses.asdict(spec.model_cfg) == \
        dataclasses.asdict(jspec.model_cfg)
    assert dataclasses.asdict(spec.smoke_cfg) == \
        dataclasses.asdict(jspec.smoke_cfg)
    for shape in spec.shapes:
        assert configs.smoke_dims(spec, shape) == \
            jax_configs.smoke_dims(jspec, shape)
        for smoke in (False, True):
            cfg = configs.cell_model_cfg(spec, shape, smoke=smoke)
            rcfg = jax_configs.cell_model_cfg(jspec, shape, smoke=smoke)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
            assert configs.model_flops(spec, shape, model_cfg=cfg) == \
                jax_configs.model_flops(jspec, shape, model_cfg=rcfg)
        assert configs.model_flops(spec, shape) == \
            jax_configs.model_flops(jspec, shape)
    # the train cell's closed form: 1.76e12 at 65,536 users
    assert configs.model_flops(spec, "train_batch") == pytest.approx(
        1.76e12, rel=1e-4)


def test_carry_and_adamw_state_name_every_parameter():
    """``mind_params_from_reference`` gives the module's two parameters, of
    their shapes and f32; the reference's AdamW state of a MIND tree (a
    flat dict) carries under the same names."""
    _, _, params, _, model = models()
    names = dict(model.named_parameters())
    assert list(names) == ["item_embed", "S"]
    tree = jax.tree.map(np.asarray, params)
    state = mind_params_from_reference(tree)
    assert state.keys() == names.keys()
    for k, p in names.items():
        assert state[k].shape == p.shape and state[k].dtype == torch.float32
        np.testing.assert_array_equal(state[k].numpy(), tree[k])
    jstate = jax.tree.map(np.asarray, jax_adamw.init_state(params))
    jstate["nu"] = jax.tree.map(lambda a: a + 2.5, jstate["nu"])
    opt = adamw_state_from_reference(jstate)
    assert opt["mu"].keys() == opt["nu"].keys() == names.keys()
    assert all(float(opt["nu"][k].min()) == 2.5 for k in names)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0


def test_init_params_draws_the_references_distributions():
    cfg = dataclasses.replace(configs.get(ARCH).smoke_cfg, n_items=20_000,
                              embed_dim=32)
    model = configs.init_params(configs.get(ARCH), cfg,
                                torch.Generator().manual_seed(3),
                                device="cpu")
    assert isinstance(model, recsys.MIND) and model.cfg == cfg
    assert model.item_embed.std().item() == pytest.approx(0.02, rel=2e-2)
    assert model.S.std().item() == pytest.approx(32 ** -0.5, rel=0.1)
    assert abs(model.item_embed.mean().item()) < 1e-3
    assert not any(p.requires_grad for p in model.parameters())


def test_routing_init_is_the_references():
    """The fixed init, against the reference's jnp expression
    (``b2i_routing``'s ``init``, weakly typed f32)."""
    K, H = 4, 50
    want = jnp.sin(jnp.arange(K)[:, None] * 12.9898
                   + jnp.arange(H)[None, :] * 78.233) * 0.01
    got = recsys.routing_init(K, H)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (K, H)
    close(got.numpy(), want)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_user_interests_match_the_reference(masked):
    _, jcfg, params, _, model = models()
    b = mind_batch(model.cfg, masked=masked)
    want = jax.jit(lambda p, i, m: jax_recsys.user_interests(
        p, jcfg, i, m))(params, b["hist_ids"], b["hist_mask"])
    got = recsys.user_interests(model, torch.as_tensor(b["hist_ids"]),
                                torch.as_tensor(b["hist_mask"]))
    assert got.shape == (5, 4, 16) and got.dtype == torch.float32
    close(got.numpy(), want, "interests")


def test_squash_and_label_aware_attention_match_the_reference():
    _, jcfg, _, _, model = models()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 4, 16)).astype(np.float32)
    t = rng.normal(size=(6, 16)).astype(np.float32)
    close(recsys.squash(torch.as_tensor(x)).numpy(),
          jax_recsys.squash(jnp.asarray(x)), "squash")
    got = recsys.label_aware_attention(model.cfg, torch.as_tensor(x),
                                       torch.as_tensor(t))
    want = jax_recsys.label_aware_attention(jcfg, jnp.asarray(x),
                                            jnp.asarray(t))
    close(got.numpy(), want, "user vectors")


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_loss_and_gradients_match_jax_grad(masked):
    """``mind_loss`` (one lookup over the history and the targets) and its
    gradients of ``item_embed`` (dense, B4 on the CPU's plain version) and
    ``S`` against ``jax.grad`` of the reference's two-lookup loss."""
    jspec, jcfg, params, spec, model = models()
    b = mind_batch(model.cfg, masked=masked)
    lval, jgrads = jax.jit(jax.value_and_grad(jax_base.loss_for(
        jspec, jcfg)))(params, as_jax(b))
    loss, grads = port_loss_and_grads(model, as_torch(b))
    assert loss == pytest.approx(float(lval), rel=RTOL, abs=ATOL)
    want = mind_params_from_reference(jax.tree.map(np.asarray, jgrads))
    assert want.keys() == grads.keys()
    for name, g in grads.items():
        grad_close(g.numpy(), want[name].numpy(), name)


def test_in_batch_softmax_loss_is_log_softmax_cross_entropy():
    """The Function's loss and gradient equal eager autograd through
    ``log_softmax`` and the diagonal (the reference's arithmetic), also
    when the logsumexp runs in row chunks."""
    rng = np.random.default_rng(7)
    user = torch.as_tensor(rng.normal(size=(9, 5)).astype(np.float32) * 3)
    tgt = torch.as_tensor(rng.normal(size=(9, 5)).astype(np.float32))
    for chunk in (recsys._LSE_ELEMS, 18):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(recsys, "_LSE_ELEMS", chunk)
            u, t = user.clone().requires_grad_(), tgt.clone().requires_grad_()
            got = recsys.in_batch_softmax_loss(u, t)
            du, dt = torch.autograd.grad(got, (u, t))
        u2, t2 = user.clone().requires_grad_(), tgt.clone().requires_grad_()
        want = -torch.log_softmax(u2 @ t2.T, dim=-1).diagonal().mean()
        wu, wt = torch.autograd.grad(want, (u2, t2))
        close(got.detach(), want.detach(), "loss")
        close(du, wu, "d user")
        close(dt, wt, "d target")


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
def test_serve_step_matches_the_reference(shape):
    jspec, jcfg, params, spec, model = models()
    dims = configs.smoke_dims(spec, shape)
    b = mind_batch(model.cfg, B=dims["batch"], C=dims["cands"], seed=2)
    del b["target_id"]
    want = jax.jit(jax_base.make_serve_step(jspec, shape, jcfg))(
        params, as_jax(b))
    got = configs.make_serve_step(spec, shape, model.cfg)(model, as_torch(b))
    assert got.shape == (4, 16) and not got.requires_grad
    close(got.numpy(), want, "scores")


def test_retrieval_matches_the_reference_with_ids_out_of_range():
    """One user against every item and ids out of range on both sides:
    -n..-1 wrap, the rest score NaN, as jnp.take gives them."""
    jspec, jcfg, params, spec, model = models()
    n = model.cfg.n_items
    b = mind_batch(model.cfg, B=1, seed=3)
    b = {"hist_ids": b["hist_ids"], "hist_mask": b["hist_mask"],
         "cand_ids": np.arange(-n - 5, n + 7, dtype=np.int32)}
    want = np.asarray(jax.jit(jax_base.make_serve_step(
        jspec, "retrieval_cand", jcfg))(params, as_jax(b)))
    got = configs.make_serve_step(spec, "retrieval_cand", model.cfg)(
        model, as_torch(b)).numpy()
    assert got.shape == (2 * n + 12,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).sum() == 12
    close(got[~np.isnan(want)], want[~np.isnan(want)], "scores")


def test_take_follows_jnp_take_for_ids_out_of_range():
    """Ids n, -1 and -n-1 on an n-row table: a NaN row, the last row and a
    NaN row forward; in the gradient only -1 adds (to row n - 1), as
    ``jax.grad`` of ``jnp.take`` adds."""
    rng = np.random.default_rng(5)
    n, d = 6, 3
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.array([[n, -1, 2], [-n - 1, -n, 2]], np.int32)
    w = rng.normal(size=(2, 3, d)).astype(np.float32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    jgrad = np.asarray(jax.grad(lambda t: jnp.nansum(
        jnp.take(t, jnp.asarray(ids), axis=0) * w))(jnp.asarray(table)))
    tt = torch.as_tensor(table).requires_grad_()
    got = ops.take(tt, torch.as_tensor(ids))
    plain = ref.take(torch.as_tensor(table), torch.as_tensor(ids))
    for out in (got.detach().numpy(), plain.numpy()):
        assert out.shape == (2, 3, d)
        np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
        np.testing.assert_array_equal(out[~np.isnan(out)],
                                      want[~np.isnan(want)])
    assert np.isnan(want[0, 0]).all() and np.isnan(want[1, 0]).all()
    np.testing.assert_array_equal(want[0, 1], table[n - 1])
    (grad,) = torch.autograd.grad(torch.nansum(got * torch.as_tensor(w)), tt)
    close(grad.numpy(), jgrad, "gradient")
    assert np.abs(jgrad[n - 1]).sum() > 0 and np.abs(jgrad[1]).sum() == 0


@pytest.mark.parametrize("weighted", [True, False],
                         ids=["weights", "no-weights"])
def test_embedding_bag_matches_the_reference(weighted):
    """``ops.embedding_bag`` (gradient B4), ``segment_matmul
    .embedding_bag`` and ``ref.embedding_bag`` against the reference's
    ``segment_matmul.embedding_bag`` and ``ref.embedding_bag``; the
    gradient against ``jax.grad``."""
    rng = np.random.default_rng(6)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    ids = rng.integers(0, 40, (7, 5)).astype(np.int32)
    wts = rng.random((7, 5)).astype(np.float32) if weighted else None
    jw = None if wts is None else jnp.asarray(wts)
    want = np.asarray(jax_sm.embedding_bag(jnp.asarray(table),
                                           jnp.asarray(ids), jw))
    close(np.asarray(jax_ref.embedding_bag(jnp.asarray(table),
                                           jnp.asarray(ids), jw)), want)
    tw = None if wts is None else torch.as_tensor(wts)
    tt = torch.as_tensor(table).requires_grad_()
    got = ops.embedding_bag(tt, torch.as_tensor(ids), tw)
    for out in (got.detach(), sm.embedding_bag(tt.detach(),
                                               torch.as_tensor(ids), tw),
                ref.embedding_bag(tt.detach(), torch.as_tensor(ids), tw)):
        assert out.shape == (7, 8)
        close(out.numpy(), want, "bags")
    up = rng.normal(size=(7, 8)).astype(np.float32)
    jgrad = jax.grad(lambda t: jnp.sum(jax_sm.embedding_bag(
        t, jnp.asarray(ids), jw) * up))(jnp.asarray(table))
    (grad,) = torch.autograd.grad((got * torch.as_tensor(up)).sum(), tt)
    grad_close(grad.numpy(), jgrad, "gradient")


def test_segment_sum_sorted_matches_the_references():
    rng = np.random.default_rng(8)
    vals = rng.normal(size=(300, 6)).astype(np.float32)
    for ids in (np.sort(rng.integers(0, 50, 300)),
                rng.integers(-3, 55, 300)):
        ids = ids.astype(np.int32)
        want = np.asarray(jax_ref.segment_sum_sorted(
            jnp.asarray(vals), jnp.asarray(ids), 50))
        got = ref.segment_sum_sorted(torch.as_tensor(vals),
                                     torch.as_tensor(ids), 50)
        assert got.shape == (50, 6) and got.dtype == torch.float32
        close(got.numpy(), want)


def test_interaction_stream_batches_equal_the_references():
    """In one process the port's stream gives the reference's arrays, bit
    for bit, at two steps, hosts and batch sizes."""
    for host in (0, 1):
        got = InteractionStream(1024, 8, seed=0, host_id=host)
        want = JaxStream(1024, 8, seed=0, host_id=host)
        np.testing.assert_array_equal(got.cluster_base, want.cluster_base)
        for step, batch in ((0, 4), (5, 33)):
            g, w = got.batch(step, batch), want.batch(step, batch)
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert ((g["hist_ids"] >= 0) & (g["hist_ids"] < 1024)).all()


def test_batch_fn_arrays_equal_the_references():
    spec, jspec = configs.get(ARCH), jax_configs.get(ARCH)
    dims = configs.smoke_dims(spec, "train_batch")
    fn = train.make_batch_fn(spec, spec.smoke_cfg, dims, device="cpu")
    jfn = jax_train.make_batch_fn(jspec, jspec.smoke_cfg, dims)
    for step in (0, 3):
        got, want = fn(step), jfn(step)
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                          err_msg=k)


def test_train_step_matches_one_reference_step():
    """One ``make_train_step`` step on a launcher batch: the loss, every
    updated parameter and both moments against the reference's step from
    the same weights and AdamW state."""
    jspec, jcfg, params, spec, model = models()
    b = train.make_batch_fn(spec, model.cfg, dict(kind="train", batch=5),
                            device="cpu")(0)
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jopt = jax_adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jstate = jax_adamw.init_state(params)
    jparams, jstate, jm = jax.jit(jax_base.make_train_step(
        jspec, jcfg, jopt))(params, jstate, as_jax(
            {k: v.numpy() for k, v in b.items()}))
    step = configs.make_train_step(spec, model.cfg, opt)
    state = adamw.init_state(dict(model.named_parameters()))
    got_model, state, m = step(model, state, b)
    assert got_model is model and int(state["step"]) == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=GRAD_TOL)
    want = mind_params_from_reference(jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        grad_close(p.detach().numpy(), want[name].numpy(), name)
    for moment in ("mu", "nu"):
        wm = mind_params_from_reference(jax.tree.map(np.asarray,
                                                     jstate[moment]))
        for name in wm:
            grad_close(state[moment][name].numpy(), wm[name].numpy(),
                       f"{moment} {name}")


def test_serve_step_refuses_a_train_cell_and_another_model():
    spec = configs.get(ARCH)
    with pytest.raises(NotImplementedError, match="train"):
        configs.make_serve_step(spec, "train_batch")
    serve = configs.make_serve_step(spec, "serve_p99", spec.smoke_cfg)
    other = recsys.MIND(dataclasses.replace(spec.smoke_cfg, hist_len=4),
                        device="cpu")
    with pytest.raises(ValueError, match="made for"):
        serve(other, {})


def test_cli_trains_mind_with_a_checkpoint_restart(tmp_path, capsys):
    base = ["--arch", ARCH, "--smoke", "--steps", "6", "--device", "cpu",
            "--log-every", "1"]
    clean = train.main(base)
    losses = train.main(base + ["--ckpt-dir", str(tmp_path),
                                "--ckpt-every", "2", "--inject-failure",
                                "3"])
    out = capsys.readouterr().out
    assert "restarts=1 steps_lost=1" in out
    # steps 0-2, the failure at 3 rolls back to the step-2 checkpoint
    assert losses == clean[:3] + clean[2:]
    assert all(np.isfinite(clean))


@pytest.mark.parametrize("M,N,K", [(64, 200, 5_000), (40, 30, 9_000),
                                   (7, 64, 3_000)])
def test_f32_split_k_plain_mirror_matches_matmul(M, N, K):
    """The plain mirror of B5's f32 K split (``ref.matmul_split_k`` at the
    plan's ``k_split``: a product per K range, the partials added in
    order) agrees with ``ref.matmul`` within f32 rounding (B5's rtol 1e-4,
    atol 1e-6 * K)."""
    p = sm.plan(M, N, K, torch.float32)
    assert p.route == "f32" and p.splits > 1
    rng = np.random.default_rng(K)
    a = torch.as_tensor(rng.normal(size=(M, K)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(K, N)).astype(np.float32))
    got = ref.matmul_split_k(a, b, p.k_split)
    assert got.shape == (M, N) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref.matmul(a, b), rtol=1e-4,
                               atol=1e-6 * K)
