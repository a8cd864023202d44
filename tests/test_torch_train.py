"""The training path of the port (losses, gradients, train steps, the
kernels' plain backward formulas, the training CLI) against the JAX
reference, at the smoke sizes of glm4-9b (GQA), codeqwen1.5-7b (MHA) and
graphsage-reddit, with the reference's weights and optimizer state carried
over by ``core.carry``. Inputs are drawn with numpy.

Tolerances:
* f32 LMs: the loss within rtol 1e-5, each parameter's gradient within
  1e-4 of that leaf's largest |gradient| (the same f32 arithmetic summed in
  another order).
* bf16 LMs: the loss within 2e-2 relative and each gradient within 5e-2
  of its leaf's largest |gradient| (PERF.md section 2's logits bound): the
  reference's inline attention rounds P to bf16 where the port's B6 keeps
  it in f32, and every later bf16 rounding decorrelates.
* GraphSAGE (f32): the loss within rtol 1e-5, gradients within 1e-4 of the
  leaf's largest (tests/test_kernels.py's segment-sum tolerance).
* Train steps from carried parameters and optimizer state: every step's
  loss within rtol 1e-4 of the reference's, the parameters after the last
  step within 1e-4 of each leaf's largest value plus 1e-3 of the learning
  rate. AdamW divides each gradient by its running scale, so a gradient
  that is rounding noise still moves its parameter by about lr per step:
  the key bias's is such (it shifts every score of a row alike, which the
  softmax cancels).
* The plain backward formulas of ``kernels/ref.py`` against
  ``torch.autograd`` of the plain forwards in f32 (rtol 1e-4, atol 1e-5
  of the largest |gradient|), and in f64 by ``torch.autograd.gradcheck``.
* The CLI with an injected failure: the replayed losses equal the
  uninterrupted run's bit for bit (the plain versions are deterministic).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.carry import (adamw_state_from_reference,  # noqa: E402
                                    lm_params_from_reference,
                                    sage_params_from_reference)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import gnn, transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

LM_ARCHS = ["glm4-9b", "codeqwen1.5-7b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SAGE = "graphsage-reddit"


def lm_models(arch, dtype, seed=0, **over):
    """(jax spec, jax cfg, jax params, port spec, port cfg, port model)."""
    jdt, tdt = DTYPES[dtype]
    jspec, spec = jax_configs.get(arch), configs.get(arch)
    jcfg = dataclasses.replace(jspec.smoke_cfg, dtype=jdt, **over)
    cfg = dataclasses.replace(spec.smoke_cfg, dtype=tdt, **over)
    params = jax_tfm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params)))
    return jspec, jcfg, params, spec, cfg, model


def lm_batch(vocab, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def sage_models(seed=0):
    jspec, spec = jax_configs.get(SAGE), configs.get(SAGE)
    jcfg = jax_configs.cell_model_cfg(jspec, "minibatch_lg", smoke=True)
    cfg = configs.cell_model_cfg(spec, "minibatch_lg", smoke=True)
    params = jax_gnn.sage_init(jcfg, jax.random.PRNGKey(seed))
    model = gnn.GraphSAGE(cfg, device="cpu")
    model.load_state_dict(sage_params_from_reference(
        jax.tree.map(np.asarray, params)))
    return jspec, jcfg, params, spec, cfg, model


def sage_batch(n=24, e=48, d=8, classes=5, seed=1):
    rng = np.random.default_rng(seed)
    return {"node_feat": rng.normal(size=(n, d)).astype(np.float32),
            "src": rng.integers(0, n, e).astype(np.int32),
            "dst": rng.integers(0, n, e).astype(np.int32),
            "edge_mask": (rng.random(e) < 0.75).astype(np.float32),
            "labels": rng.integers(0, classes, n).astype(np.int32),
            "seed_mask": rng.random(n) < 0.4}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def port_loss_and_grads(spec, cfg, model, batch):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = configs.loss_for(spec, cfg)(model, torch_batch(batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def carried_grads(jgrads, lm: bool) -> dict:
    tree = jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads)
    return (lm_params_from_reference if lm else sage_params_from_reference)(
        tree)


def assert_grads_close(got: dict, want: dict, share: float):
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name].float()
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        scale = float(w.abs().max())
        err = float((g.float() - w).abs().max())
        assert err <= share * scale + 1e-30, (name, err, scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_gradients_match_the_reference(arch, dtype):
    jspec, jcfg, params, spec, cfg, model = lm_models(arch, dtype)
    batch = lm_batch(cfg.vocab)
    want, jgrads = jax.value_and_grad(jax_configs.base.loss_for(jspec, jcfg))(
        params, jax_batch(batch))
    got, grads = port_loss_and_grads(spec, cfg, model, batch)
    assert all(g.dtype == cfg.dtype or name.endswith(("ln1", "ln2", "ln_f"))
               for name, g in grads.items())
    if dtype == "f32":
        np.testing.assert_allclose(got, float(want), rtol=1e-5)
        assert_grads_close(grads, carried_grads(jgrads, True), 1e-4)
    else:
        np.testing.assert_allclose(got, float(want), rtol=2e-2)
        assert_grads_close(grads, carried_grads(jgrads, True), 5e-2)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_recomputes_the_same_gradients(arch):
    """Per-layer recomputation (``remat=True``) changes where the forward
    runs, not what it computes: loss and gradients bit-equal to the run
    that keeps the activations."""
    out = []
    for remat in (False, True):
        *_, spec, cfg, model = lm_models(arch, "f32", remat=remat)
        out.append(port_loss_and_grads(spec, cfg, model, lm_batch(cfg.vocab)))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_loss_fn_takes_the_label_logit_and_aux_weight():
    """The gather of the label logit equals the reference's one-hot sum,
    and the loss is the mean of log-sum-exp minus it."""
    *_, spec, cfg, model = lm_models("glm4-9b", "f32")
    batch = torch_batch(lm_batch(cfg.vocab))
    with torch.no_grad():
        logits, aux = tfm.train_forward(model, batch["tokens"])
        onehot = torch.nn.functional.one_hot(batch["labels"].long(),
                                             cfg.vocab).float()
        want = (torch.logsumexp(logits, -1) - (logits * onehot).sum(-1)).mean()
        got = tfm.loss_fn(model, batch["tokens"], batch["labels"],
                          aux_weight=3.0)
    assert float(aux) == 0.0
    assert torch.equal(got, want)


def test_sage_loss_and_gradients_match_the_reference():
    jspec, jcfg, params, spec, cfg, model = sage_models()
    batch = sage_batch(classes=cfg.n_classes)
    want, jgrads = jax.value_and_grad(jax_configs.base.loss_for(jspec, jcfg))(
        params, jax_batch(batch))
    got, grads = port_loss_and_grads(spec, cfg, model, batch)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    assert_grads_close(grads, carried_grads(jgrads, False), 1e-4)


def test_sage_loss_counts_no_seed_as_one():
    *_, spec, cfg, model = sage_models()
    batch = sage_batch(classes=cfg.n_classes)
    batch["seed_mask"][:] = False
    assert float(gnn.sage_loss(model, torch_batch(batch))) == 0.0


def reference_steps(jspec, jcfg, params, jstate, batches, opt_cfg):
    step = jax.jit(jax_configs.make_train_step(
        jspec, jcfg, jax_adamw.AdamWConfig(**opt_cfg.__dict__)))
    losses = []
    for b in batches:
        params, jstate, m = step(params, jstate, jax_batch(b))
        losses.append(float(m["loss"]))
    return params, jstate, losses


@pytest.mark.parametrize("arch", LM_ARCHS + [SAGE])
def test_train_steps_track_the_reference(arch):
    """One reference step gives a non-zero optimizer state; it and the
    parameters are carried, then three steps on each side from there."""
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    if arch == SAGE:
        jspec, jcfg, params, spec, cfg, model = sage_models()
        batches = [sage_batch(classes=cfg.n_classes, seed=s)
                   for s in range(4)]
        carry = sage_params_from_reference
    else:
        jspec, jcfg, params, spec, cfg, model = lm_models(arch, "f32")
        batches = [lm_batch(cfg.vocab, seed=s) for s in range(4)]
        carry = lm_params_from_reference
    params, jstate, _ = reference_steps(
        jspec, jcfg, params, jax_adamw.init_state(params), batches[:1],
        opt_cfg)
    host = jax.tree.map(np.asarray, (params, jstate))
    model.load_state_dict(carry(host[0]))
    state = adamw_state_from_reference(host[1])
    assert int(state["step"]) == 1
    params, jstate, want = reference_steps(jspec, jcfg, params, jstate,
                                           batches[1:], opt_cfg)
    step = configs.make_train_step(spec, cfg, opt_cfg)
    got = []
    for b in batches[1:]:
        out, state, m = step(model, state, torch_batch(b))
        assert out is model and set(m) == {"loss", "grad_norm", "lr"}
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(state["step"]) == int(jstate["step"]) == 4
    final = carry(jax.tree.map(np.asarray, params))
    for name, p in model.named_parameters():
        w = final[name].float()
        err = float((p.detach().float() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-3 * opt_cfg.lr, (
            name, err)


def test_adamw_state_carries_from_the_reference():
    _, jcfg, params, *_ = lm_models("glm4-9b", "bf16")
    jstate = jax_adamw.init_state(params)
    jstate["step"] = jnp.int32(7)
    state = adamw_state_from_reference(jax.tree.map(np.asarray, jstate))
    model = tfm.Transformer(configs.get("glm4-9b").smoke_cfg, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert set(state["mu"]) == set(state["nu"]) == names
    assert all(m.dtype == torch.float32 for m in state["mu"].values())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 7


@pytest.mark.parametrize("arch", LM_ARCHS + [SAGE])
def test_smoke_dims_match_the_reference(arch):
    spec, jspec = configs.get(arch), jax_configs.get(arch)
    for shape in spec.shapes:
        assert configs.smoke_dims(spec, shape) == \
            jax_configs.smoke_dims(jspec, shape)
    if arch != SAGE:
        assert spec.model_cfg.remat == jspec.model_cfg.remat
        assert spec.smoke_cfg.remat == jspec.smoke_cfg.remat


def test_unported_families_raise_naming_a8():
    moe = tfm.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16)
    cfg = tfm.LMConfig("m", n_layer=1, d_model=32, n_head=2, n_kv=2, d_ff=0,
                       vocab=64, d_head=16, moe=moe)
    for family, shapes in (("lm-moe", configs.LM_SHAPES),
                           ("recsys", configs.LM_SHAPES)):
        spec = configs.ArchSpec(id="x", family=family, model_cfg=cfg,
                                smoke_cfg=cfg, shapes=shapes, skips={})
        for fn in (configs.make_train_step, configs.loss_for):
            with pytest.raises(NotImplementedError, match="A8"):
                fn(spec, cfg)
        with pytest.raises(NotImplementedError, match="A8"):
            configs.init_params(spec, cfg, torch.Generator(), device="cpu")
    mgn = configs.ArchSpec(id="mgn", family="gnn", model_cfg=object(),
                           smoke_cfg=object(), shapes=configs.GNN_SHAPES,
                           skips={})
    with pytest.raises(NotImplementedError, match="A8"):
        configs.make_train_step(mgn, None)
    with pytest.raises(NotImplementedError, match="A8"):
        train.make_batch_fn(mgn, object(), dict(n=24), device="cpu")


def test_train_step_refuses_a_model_of_another_config():
    *_, spec, cfg, model = lm_models("glm4-9b", "f32")
    step = configs.make_train_step(spec, spec.smoke_cfg)
    with pytest.raises(ValueError, match="made for"):
        step(model, adamw.init_state(dict(model.named_parameters())),
             torch_batch(lm_batch(cfg.vocab)))


# -- the plain backward formulas ---------------------------------------------

def autograd_of(fn, *xs):
    """Gradients of sum(fn(*xs) * w) for a fixed random cotangent w, and w."""
    xs = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in xs]
    out = fn(*xs)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64).to(out.dtype)
    grads = torch.autograd.grad((out * w).sum(),
                                [x for x in xs if x.requires_grad])
    return grads, w, out.detach()


def close_to(got, want, rtol=1e-4, share=1e-5):
    got, want = got.double(), want.double()
    assert got.shape == want.shape
    tol = rtol * want.abs() + share * float(want.abs().max())
    assert bool(((got - want).abs() <= tol).all()), float(
        (got - want).abs().max())


ATTN_CASES = {
    "causal GQA G=2": (2, 20, 20, 4, 2, 16, True, 20),
    "causal S != T": (1, 12, 30, 6, 3, 8, True, 30),
    "t_real, not causal": (2, 5, 40, 4, 1, 16, False, 29),
    "MHA dh 12": (1, 9, 9, 2, 2, 12, True, 9),
    "decode G=16": (2, 1, 50, 16, 1, 16, False, 37),
    "wide dh 136": (1, 6, 6, 4, 2, 136, True, 6),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_backward_formula_matches_autograd(case):
    B, S, T, H, Hkv, dh, causal, t_real = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (torch.tensor(rng.normal(size=shape).astype(np.float32))
               for shape in ((B, S, H, dh), (B, T, Hkv, dh), (B, T, Hkv, dh)))
    (dq, dk, dv), do, o = autograd_of(
        lambda q, k, v: ref.flash_attention(q, k, v, causal=causal,
                                            t_real=t_real), q, k, v)
    gq, gk, gv, lse = ref.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                              t_real=t_real)
    for got, want in ((gq, dq), (gk, dk), (gv, dv)):
        close_to(got, want)
    assert float(gk[:, t_real:].abs().sum()) == 0.0
    assert float(gv[:, t_real:].abs().sum()) == 0.0
    # lse against the scores' log-sum-exp, written out
    G = H // Hkv
    kh = k[:, :t_real].repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, kh) / dh ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(S, t_real).triu(1).bool(),
                          float("-inf"))
    close_to(lse, torch.logsumexp(s, -1), share=1e-6)
    # the wrapper and the differentiable op take the formula on the CPU
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, t_real=t_real)
    assert all(torch.equal(a, b) for a, b in zip(got, (gq, gk, gv, lse)))
    (oq, ok, ov), _, _ = autograd_of(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal,
                                            t_real=t_real), q, k, v)
    assert torch.equal(oq, gq) and torch.equal(ok, gk) and torch.equal(ov, gv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_gather_formula_matches_autograd(dtype):
    rng = np.random.default_rng(4)
    E, d, S = 60, 7, 11
    ids = rng.integers(0, S, E)
    ids[rng.random(E) < 0.15] = -1
    ids[rng.random(E) < 0.1] = S + 2
    ids = torch.as_tensor(ids.astype(np.int32))
    vals = torch.tensor(rng.normal(size=(E, d)).astype(np.float32)).to(dtype)
    (dvals,), dout, _ = autograd_of(
        lambda x: ref.segment_sum(x, ids, S), vals)
    got = ref.segment_gather(dout, ids, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, dvals.to(dtype))
    assert bool((got[(ids < 0) | (ids >= S)] == 0).all())
    assert torch.equal(sm.segment_gather(dout, ids, dtype), got)
    (ov,), _, _ = autograd_of(lambda x: ops.segment_sum(x, ids, S), vals)
    assert torch.equal(ov, got)


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "bf16 x f32"])
def test_matmul_gradient_formula_matches_autograd(dtypes):
    rng = np.random.default_rng(6)
    a = torch.tensor(rng.normal(size=(13, 9)).astype(np.float32)).to(dtypes[0])
    b = torch.tensor(rng.normal(size=(9, 5)).astype(np.float32)).to(dtypes[1])
    (da, db), dc, _ = autograd_of(ref.matmul, a, b)
    if dtypes[0] == dtypes[1] == torch.bfloat16:
        dc = dc.bfloat16().float()         # the products' bf16 cotangent
        (da, db), _, _ = autograd_of(
            lambda a, b: ref.matmul(a, b).bfloat16(), a, b)
    ga, gb = ref.matmul_grads(a, b, dc)
    assert ga.dtype == a.dtype and gb.dtype == b.dtype
    close_to(ga.float(), da.float(), rtol=1e-2 if a.dtype != torch.float32
             else 1e-4)
    close_to(gb.float(), db.float(), rtol=1e-2 if b.dtype != torch.float32
             else 1e-4)
    assert ref.matmul_grads(a, b, dc, need_a=False)[0] is None
    assert torch.equal(sm.matmul_grads(a, b, dc)[1], gb)
    (oa, ob), _, _ = autograd_of(ops.matmul, a, b)
    if dtypes[0] == torch.float32:
        assert torch.equal(oa, ga) and torch.equal(ob, gb)


class _F64(torch.autograd.Function):
    """An f64 forward written out in the test, with ``ref``'s backward
    formula: what gradcheck holds against finite differences."""

    @staticmethod
    def forward(ctx, kind, *xs):
        ctx.kind = kind
        if kind == "matmul":
            a, b = xs
            ctx.save_for_backward(a, b)
            return a @ b
        if kind == "segment_sum":
            vals, ids, S = xs
            ctx.save_for_backward(ids)
            out = vals.new_zeros((S, vals.shape[1]))
            ok = (ids >= 0) & (ids < S)
            return out.index_add_(0, ids[ok].long(), vals[ok])
        q, k, v, causal, t_real = xs
        B, S, H, dh = q.shape
        G = H // k.shape[2]
        kh = k[:, :t_real].repeat_interleave(G, dim=2)
        vh = v[:, :t_real].repeat_interleave(G, dim=2)
        s = torch.einsum("bshd,bthd->bhst", q, kh) / dh ** 0.5
        if causal:
            s = s.masked_fill(torch.ones(S, t_real, dtype=torch.bool).triu(1),
                              float("-inf"))
        o = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), vh)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = (causal, t_real)
        return o

    @staticmethod
    def backward(ctx, g):
        if ctx.kind == "matmul":
            a, b = ctx.saved_tensors
            return (None, *ref.matmul_grads(a, b, g))
        if ctx.kind == "segment_sum":
            (ids,) = ctx.saved_tensors
            return None, ref.segment_gather(g, ids, g.dtype), None, None
        q, k, v, o = ctx.saved_tensors
        causal, t_real = ctx.args
        dq, dk, dv, _ = ref.flash_attention_bwd(q, k, v, o, g, causal=causal,
                                                t_real=t_real)
        return None, dq, dk, dv, None, None


def test_backward_formulas_pass_gradcheck_in_f64():
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float64,
                            requires_grad=True)

    assert torch.autograd.gradcheck(
        lambda a, b: _F64.apply("matmul", a, b), (t(5, 4), t(4, 3)))
    ids = torch.tensor([0, 3, -1, 3, 9, 1, 0], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda x: _F64.apply("segment_sum", x, ids, 4), (t(7, 3),))
    for causal, t_real in ((True, 6), (False, 4)):
        assert torch.autograd.gradcheck(
            lambda q, k, v: _F64.apply("attention", q, k, v, causal, t_real),
            (t(1, 5, 4, 3), t(1, 6, 2, 3), t(1, 6, 2, 3)))


def test_gather_rows_gradient_is_a_segment_sum():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(9, 4)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 9, 30).astype(np.int32))
    (dx,), dy, y = autograd_of(lambda x: ops.gather_rows(x, idx), x)
    assert torch.equal(y, x[idx.long()])
    close_to(dx, torch.zeros_like(x).index_add_(0, idx.long(), dy),
             rtol=1e-6, share=1e-7)


def test_cpu_training_launches_no_kernel():
    *_, spec, cfg, model = lm_models("glm4-9b", "f32")
    before = (sm.matmul.launches, fa.flash_attention.launches,
              fa.flash_attention_bwd.launches, sm.segment_gather.launches)
    port_loss_and_grads(spec, cfg, model, lm_batch(cfg.vocab))
    assert (sm.matmul.launches, fa.flash_attention.launches,
            fa.flash_attention_bwd.launches,
            sm.segment_gather.launches) == before


def test_backward_kernels_refuse_a_cpu_device_and_wide_heads():
    """Heads wider than 128 have a backward kernel now (the ``wide``
    route, for every dtype, where they raised before); the other routes
    by dtype and width; arguments the kernels cannot take raise."""
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        assert fa.bwd_plan(1, 8, 2, 1, 8, True, 136, dt) == ("wide", 136, 1)
    assert fa.bwd_plan(3, 1, 8, 2, 300, False, 256, torch.float32).route \
        == "wide"
    assert fa.bwd_plan(2, 96, 4, 2, 96, True, 16, torch.bfloat16) == (
        "mma", 16, 1)
    assert fa.bwd_plan(1, 50, 6, 2, 50, True, 24, torch.float16) == (
        "mma", 32, 1)
    assert fa.bwd_plan(2, 40, 4, 2, 40, True, 128, torch.float32) == (
        "f32", 128, 1)
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_bwd(q, q, q, q, q[:, :2])
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q, q, q, q, lse=torch.zeros(1, 4, 2))
    pairs = 8_390_656                     # causal 4,096: 4,096 * 4,097 / 2
    assert fa.bwd_bound_ms(1, 4096, 32, 2, 4096, 4096, True) == pytest.approx(
        10 * 128 * 32 * pairs / 989e12 * 1e3)
    assert fa.bwd_bound_ms(1, 4096, 32, 2, 4096, 4096, True, products=7) \
        == pytest.approx(14 * 128 * 32 * pairs / 989e12 * 1e3)


LSE_CASES = {
    "causal S = T, GQA G=4": (2, 24, 24, 8, 2, 16, True, 24),
    "causal S = T, MHA": (1, 17, 17, 3, 3, 8, True, 17),
    "kv_len_mask, t_real < T": (2, 5, 30, 8, 4, 16, False, 19),
    "kv_len_mask, decode G=16": (3, 1, 16, 16, 1, 16, False, 11),
}


@pytest.mark.parametrize("case", sorted(LSE_CASES))
def test_flash_attention_backward_from_the_forward_lse_matches_jax_vjp(case):
    """The plain backward fed the forward's lse (``return_lse``) equals the
    one that recomputes it, and both equal ``jax.vjp`` of the reference
    model's ``gqa_attention`` in f32: causal at S = T, or over the first
    t_real keys through ``kv_len_mask`` (the decode mask). Keys at or past
    t_real get no gradient."""
    B, S, T, H, Hkv, dh, causal, t_real = LSE_CASES[case]
    rng = np.random.default_rng(len(case) + T)
    qn, kn, vn, don = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, H, dh), (B, T, Hkv, dh), (B, T, Hkv, dh), (B, S, H, dh)))
    q, k, v, do = (torch.tensor(x) for x in (qn, kn, vn, don))
    o, lse = ref.flash_attention(q, k, v, causal=causal, t_real=t_real,
                                 return_lse=True)
    fed = ref.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                  t_real=t_real, lse=lse)
    own = ref.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                  t_real=t_real)
    for a, b in zip(fed, own):
        close_to(a, b, rtol=1e-5, share=1e-6)
    assert torch.equal(fed[3], lse)
    mask = None if causal else jnp.broadcast_to(
        jnp.arange(T)[None, :] < t_real, (B, T))
    out, vjp = jax.vjp(lambda q, k, v: jax_tfm.gqa_attention(
        q, k, v, causal=causal, kv_len_mask=mask), *map(jnp.asarray,
                                                        (qn, kn, vn)))
    close_to(o, torch.tensor(np.asarray(out)).view(B, S, H, dh))
    grads = vjp(jnp.asarray(don.reshape(B, S, H * dh)))
    for got, want in zip(fed[:3], grads):
        close_to(got, torch.tensor(np.asarray(want)))
    assert not fed[1][:, t_real:].any() and not fed[2][:, t_real:].any()


# -- the CLI --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["glm4-9b", SAGE])
def test_cli_replays_an_injected_failure_exactly(arch, tmp_path, capsys):
    base = ["--arch", arch, "--smoke", "--steps", "6", "--device", "cpu",
            "--log-every", "1"]
    clean = train.main(base)
    losses = train.main(base + ["--ckpt-dir", str(tmp_path / "a"),
                                "--ckpt-every", "2", "--inject-failure", "3"])
    # steps 0-2, the failure at 3 rolls back to the step-2 checkpoint, and
    # steps 2-5 run again: the replayed step 2 gives the same loss
    assert losses == clean[:3] + clean[2:]
    assert all(np.isfinite(clean))
    out = capsys.readouterr().out
    assert "restarts=1 steps_lost=1" in out
    resumed = train.main(base[:4] + ["2"] + base[5:] + [
        "--ckpt-dir", str(tmp_path / "a"), "--resume", "auto"])
    assert "[resume] from step 6" in capsys.readouterr().out
    assert len(resumed) == 2 and all(np.isfinite(resumed))


def test_cli_raises_for_unported_architectures():
    with pytest.raises(KeyError):
        train.main(["--arch", "dbrx-132b", "--smoke", "--device", "cpu"])


def test_out_of_vocabulary_ids_follow_the_reference():
    """TokenStream's f32 CDF ends below 1, so it emits the id ``vocab``
    now and then: the reference's indexing clamps such a token and its
    one-hot gives such a label a label logit of 0; the port does the
    same."""
    jspec, jcfg, params, spec, cfg, model = lm_models("glm4-9b", "f32")
    batch = lm_batch(cfg.vocab)
    batch["tokens"][0, 3] = batch["labels"][1, 5] = cfg.vocab
    want, jgrads = jax.value_and_grad(jax_configs.base.loss_for(jspec, jcfg))(
        params, jax_batch(batch))
    got, grads = port_loss_and_grads(spec, cfg, model, batch)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    assert_grads_close(grads, carried_grads(jgrads, True), 1e-4)
