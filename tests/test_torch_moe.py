"""The MoE LMs of the port (qwen2-moe-a2.7b, dbrx-132b) and qwen1.5-110b
against the JAX reference, with the reference's weights carried over by
``lm_params_from_reference``. Inputs are drawn with numpy from a seed.

The MoE layer is held to the reference's on identical inputs: its routing
(the experts of every token), its dispatch (``keep``, ``dest``, the dropped
assignments) and its aux loss exactly or within 1e-6, its output within
1e-4 of max|out| in f32 and 3e-2 of max|out| in bf16 (the transformer
tests' bf16 bound). Every routing comparison prints the smallest
top-K margin (the K-th largest router probability minus the next one) and
fails with the count of differing assignments. Whole models are compared
in f32 only, within 2e-3 of max|logit| and 1e-4 of each gradient leaf's
largest |gradient|: in bf16 the packages' attention rounds differently
(ROADMAP section C), and a route flipped by an ulp moves a whole expert's
term.

The reference's functions run under ``jax.jit``, compiled once per
configuration: op by op they cost most of this file's time."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.carry import lm_params_from_reference  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

MOE_ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]
NEW_ARCHS = MOE_ARCHS + ["qwen1.5-110b"]
LM_ARCHS = NEW_ARCHS + ["glm4-9b", "codeqwen1.5-7b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

#: MoE layer variants on the qwen2-moe smoke layer (6 experts, top-2,
#: d_ff_expert 32, one shared expert): capacity 0.5 drops assignments,
#: groups 2 routes two groups, groups 3 does not divide T (one group), pad
#: experts add two never-routed experts, n_shared 0 drops the shared one
LAYER_CASES = {
    "base": {},
    "capacity_0.5": dict(capacity_factor=0.5),
    "groups_2": dict(groups=2),
    "groups_3_not_dividing": dict(groups=3),
    "pad_experts_2": dict(pad_experts=2),
    "no_shared": dict(n_shared=0),
    "groups_2_capacity_0.5_pad": dict(groups=2, capacity_factor=0.5,
                                      pad_experts=2),
}

#: the reference's functions, each compiled once per configuration
jax_moe_ffn = jax.jit(jax_tfm.moe_ffn, static_argnums=1)
jax_moe_group = jax.jit(jax_tfm._moe_group, static_argnums=(1, 3))
jax_forward = jax.jit(jax_tfm.forward, static_argnums=1)
jax_decode_step = jax.jit(jax_tfm.decode_step, static_argnums=1)


def pair(arch, dtype, seed=0, **over):
    """(jax cfg, jax params, port model) with the same weights."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_configs.get(arch).smoke_cfg, dtype=jdt,
                               **over)
    cfg = dataclasses.replace(configs.get(arch).smoke_cfg, dtype=tdt, **over)
    params = jax_tfm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, model


def layer_pair(case, dtype, seed=0):
    """A 1-layer qwen2-moe smoke model with the case's MoE settings: (jax
    cfg, jax params, port model)."""
    arch = "qwen2-moe-a2.7b"
    jdt, tdt = DTYPES[dtype]
    moe = dataclasses.replace(configs.get(arch).smoke_cfg.moe,
                              **LAYER_CASES[case])
    cfg = dataclasses.replace(configs.get(arch).smoke_cfg, dtype=tdt,
                              n_layer=1, moe=moe)
    jcfg = dataclasses.replace(jax_configs.get(arch).smoke_cfg, dtype=jdt,
                               n_layer=1, moe=jax_tfm.MoEConfig(
                                   **dataclasses.asdict(moe)))
    params = jax_tfm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, model


def moe_layer(case, dtype):
    """(jax cfg, the jax layer's ``moe`` dict, port cfg, the port's
    ``MoE``) of :func:`layer_pair`'s model."""
    jcfg, params, model = layer_pair(case, dtype)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    return jcfg, jp, model.cfg, model.layers[0].moe


def activations(d, B=2, S=128, seed=3):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def reference_routing(jp, mcfg, xt, C):
    """The reference's routing and dispatch of one token group, as
    ``repro.models.transformer._moe_group`` computes them (its lines up to
    the buffer), with the probabilities for the margin."""
    Tg, _ = xt.shape
    E, K = mcfg.e_total, mcfg.top_k
    logits = xt.astype(jnp.float32) @ jp["router"]
    if mcfg.pad_experts:
        logits = jnp.where((jnp.arange(E) >= mcfg.n_experts)[None, :], -1e30,
                           logits)
    probs = jax.nn.softmax(logits, axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    flat_e = eidx.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(Tg, dtype=jnp.int32), K)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    starts = jnp.searchsorted(se, jnp.arange(E, dtype=se.dtype), side="left")
    pos = jnp.arange(Tg * K, dtype=jnp.int32) - starts[se].astype(jnp.int32)
    keep = pos < C
    dest = jnp.where(keep, se.astype(jnp.int32) * C + pos, E * C)
    return {name: np.asarray(a) for name, a in dict(
        probs=probs, eidx=eidx, order=order, se=se, st=st, pos=pos,
        keep=keep, dest=dest).items()}


def margin(probs: np.ndarray, K: int) -> float:
    """The smallest gap between a token's K-th and (K+1)-th largest router
    probability: how far the routing is from a tie."""
    top = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    return float((top[:, K - 1] - top[:, K]).min())


def assert_routes_equal(got: np.ndarray, want: np.ndarray, probs, K, what):
    m = margin(probs, K)
    print(f"{what}: smallest top-{K} margin {m:.3e}")
    differ = int((np.sort(got, -1) != np.sort(want, -1)).sum())
    assert differ == 0, (f"{what}: {differ} assignments route to other "
                         f"experts than the reference's (smallest top-{K} "
                         f"margin {m:.3e})")


class Recorder:
    """Wraps ``transformer.route`` and ``transformer.dispatch``, keeping
    every call's outputs in call order."""

    def __init__(self, monkeypatch):
        self.routes, self.dispatches = [], []
        route, dispatch = tfm.route, tfm.dispatch

        def rec_route(probs, k):
            out = route(probs, k)
            self.routes.append((probs.detach().float().numpy(),
                                out.numpy()))
            return out

        def rec_dispatch(eidx, E, C):
            out = dispatch(eidx, E, C)
            self.dispatches.append([a.numpy() for a in out])
            return out

        monkeypatch.setattr(tfm, "route", rec_route)
        monkeypatch.setattr(tfm, "dispatch", rec_dispatch)


def assert_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    share = 1e-4 if dtype == "f32" else 3e-2
    assert np.abs(got - want).max() <= share * np.abs(want).max()


# -- the MoE layer --------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_ffn_matches_the_reference(case, dtype, monkeypatch):
    """``moe_ffn`` on identical inputs: every token's experts, ``keep``,
    ``dest`` and the dropped set equal to the reference's, aux within 1e-6,
    the output within the dtype's tolerance."""
    jcfg, jp, cfg, p = moe_layer(case, dtype)
    mcfg = cfg.moe
    x = activations(cfg.d_model)
    jdt, tdt = DTYPES[dtype]
    want, want_aux = jax_moe_ffn(jp, jcfg, jnp.asarray(x, jdt))
    rec = Recorder(monkeypatch)
    with torch.no_grad():
        got, aux = tfm.moe_ffn(p, cfg, torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt and aux.dtype == torch.float32
    T = x.shape[0] * x.shape[1]
    G, C = tfm.capacity(mcfg, T)
    assert len(rec.routes) == G
    xg = jnp.asarray(x, jdt).reshape(G, T // G, -1)
    dropped = 0
    for g in range(G):
        r = reference_routing(jp, mcfg, xg[g], C)
        assert_routes_equal(rec.routes[g][1], r["eidx"], r["probs"],
                            mcfg.top_k, f"{case} {dtype} group {g}")
        # the same experts in the same top-k order
        np.testing.assert_array_equal(rec.routes[g][1], r["eidx"])
        order, se, st, pos, keep, dest = rec.dispatches[g]
        for name, a in dict(order=order, se=se, st=st, pos=pos, keep=keep,
                            dest=dest).items():
            np.testing.assert_array_equal(a, r[name], err_msg=name)
        dropped += int((~keep).sum())
    if case.startswith(("capacity", "groups_2_capacity")):
        assert dropped > 0
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    assert_close(got.float(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["base", "capacity_0.5", "pad_experts_2"])
def test_moe_group_matches_the_reference(case, dtype):
    """``_moe_group`` alone, one group of 256 tokens at the case's capacity:
    output and aux."""
    jcfg, jp, cfg, p = moe_layer(case, dtype)
    jdt, tdt = DTYPES[dtype]
    xt = activations(cfg.d_model).reshape(-1, cfg.d_model)
    _, C = tfm.capacity(cfg.moe, xt.shape[0])
    want, want_aux = jax_moe_group(jp, jcfg.moe, jnp.asarray(xt, jdt), C)
    r = reference_routing(jp, jcfg.moe, jnp.asarray(xt, jdt), C)
    print(f"{case} {dtype}: {int((~r['keep']).sum())} of {r['keep'].size} "
          f"assignments dropped at C = {C}; smallest margin "
          f"{margin(r['probs'], cfg.moe.top_k):.3e}")
    with torch.no_grad():
        got, aux = tfm._moe_group(p, cfg.moe, torch.as_tensor(xt).to(tdt), C)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    assert_close(got.float(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("T,groups,want", [
    (4096, 1, (1, 352)), (4, 1, (1, 32)), (48, 2, (2, 32)), (48, 5, (1, 32)),
    (4096, 4, (4, 96))])
def test_capacity_is_the_reference_formula(T, groups, want):
    """qwen2-moe at prefill (4,096 tokens) gets C = 352 and at decode (4
    tokens) C = 32; groups divide T or fall back to one."""
    mcfg = dataclasses.replace(configs.get("qwen2-moe-a2.7b").model_cfg.moe,
                               groups=groups)
    assert tfm.capacity(mcfg, T) == want
    G = groups if T % groups == 0 else 1
    C = max(1, min(int(np.ceil(T // G * mcfg.top_k / mcfg.n_experts
                               * mcfg.capacity_factor)), T // G))
    assert want == (G, int(np.ceil(C / 32)) * 32)


def test_dbrx_capacity_at_prefill():
    assert tfm.capacity(configs.get("dbrx-132b").model_cfg.moe, 4096) == \
        (1, 1280)


def test_combine_adds_in_ascending_expert_order():
    """One token routed to all three experts, whose bf16 contributions are
    about 1, 256 and -256: the output is their sum taken one by one in
    ascending expert order, as the reference's scatter-add meets them (its
    assignments sorted by expert), though the top-k order is 2, 1, 0; the
    other order rounds to another value here."""
    mcfg = tfm.MoEConfig(n_experts=3, top_k=3, d_ff_expert=8,
                         capacity_factor=4.0)
    cfg = tfm.LMConfig("m", n_layer=1, d_model=8, n_head=1, n_kv=1, d_ff=0,
                       vocab=8, d_head=8, dtype=torch.bfloat16, moe=mcfg)
    p = tfm.MoE(cfg, device="cpu")
    x = torch.zeros(1, 1, 8, dtype=torch.bfloat16)
    x[..., 0] = 1.0
    with torch.no_grad():
        p.router.zero_()
        p.router[0] = torch.tensor([0.0, 1.0, 2.0])
        probs = torch.softmax(p.router[0], -1)
        gate = probs / probs.sum()
        p.wg.fill_(10.0)
        p.wi.fill_(0.125)
        for e, v in enumerate((1.0, 256.0, -256.0)):
            p.wo[e].fill_(v / float(gate[e]) / 8 / 1.25)
        out, _ = tfm.moe_ffn(p, cfg, x)
        xt = x.reshape(1, 8)
        g = gate.to(torch.bfloat16)
        terms = []
        for e in range(3):
            h = tfm.silu(tfm.linear(xt, p.wg[e])) * tfm.linear(xt, p.wi[e])
            terms.append(tfm.linear(h, p.wo[e])[0] * g[e])
    assert tfm.route(probs[None], 3).tolist() == [[2, 1, 0]]
    ascending = (terms[0] + terms[1]) + terms[2]
    descending = (terms[2] + terms[1]) + terms[0]
    assert not torch.equal(ascending, descending)
    assert torch.equal(out[0, 0], ascending)


def test_moe_gradients_match_the_reference():
    """The MoE layer's gradient with respect to its input and every weight
    in f32 (the gate's through the router, the experts' through B5's
    plain gradient) within 1e-4 of each leaf's largest |gradient|, at a
    capacity that drops assignments."""
    jcfg, jp, cfg, p = moe_layer("groups_2_capacity_0.5_pad", "f32")
    x = activations(cfg.d_model)
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(jp, x):
        out, aux = jax_tfm.moe_ffn(jp, jcfg, x)
        return jnp.sum(out * w) + aux

    jg, jx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    params = dict(p.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    out, aux = tfm.moe_ffn(p, cfg, xt)
    loss = (out * torch.as_tensor(w)).sum() + aux
    grads = torch.autograd.grad(loss, [xt] + list(params.values()))
    want = [np.asarray(jx)] + [np.asarray(jg[n]) for n in params]
    for name, g, w_ in zip(["x"] + list(params), grads, want):
        scale = float(np.abs(w_).max())
        err = float(np.abs(g.numpy() - w_).max())
        assert err <= 1e-4 * scale + 1e-30, (name, err, scale)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_silu_gradient_is_the_references_where_exp_overflows(dtype):
    """``silu``'s gradient over -120..120 (below -88 ``exp(-x)`` overflows;
    qwen2-moe's shared experts reach such pre-activations under the
    reference's init): finite, and equal to jax's gradient of
    ``jax.nn.silu`` within 1e-6 (f32) or bf16's rounding of it."""
    jdt, tdt = DTYPES[dtype]
    x = np.linspace(-120, 120, 2401).astype(np.float32)
    w = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum((jax.nn.silu(v) * jnp.asarray(
        w, jdt)).astype(jnp.float32)))(jnp.asarray(x, jdt))
    xt = torch.as_tensor(x).to(tdt).requires_grad_(True)
    out = tfm.silu(xt)
    got, = torch.autograd.grad((out * torch.as_tensor(w).to(tdt)).float()
                               .sum(), xt)
    assert bool(torch.isfinite(got).all())
    want = np.asarray(want, np.float32)
    tol = 1e-6 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    with torch.no_grad():
        assert torch.equal(tfm.silu(xt), out.detach())


# -- whole models ---------------------------------------------------------------

def tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference_f32(arch, monkeypatch):
    jcfg, params, model = pair(arch, "f32")
    toks = tokens(jcfg.vocab, 2, 16)
    rec = Recorder(monkeypatch)
    want, want_aux = jax_forward(params, jcfg, jnp.asarray(toks))
    got, aux = tfm.forward(model, torch.as_tensor(toks))
    assert len(rec.routes) == jcfg.n_layer
    m = min(margin(pr, jcfg.moe.top_k) for pr, _ in rec.routes)
    print(f"{arch}: smallest top-{jcfg.moe.top_k} margin over the layers "
          f"{m:.3e}")
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 2e-3 * np.abs(want).max()
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * jcfg.n_layer
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_reference_f32(arch):
    jcfg, params, model = pair(arch, "f32")
    toks = tokens(jcfg.vocab, 2, 6)
    jcache = jax_tfm.init_cache(jcfg, 2, 16)
    cache = tfm.init_cache(model.cfg, 2, 16, device="cpu")
    full, _ = tfm.forward(model, torch.as_tensor(toks))
    for i in range(toks.shape[1]):
        want, jcache = jax_decode_step(params, jcfg,
                                       jnp.asarray(toks[:, i:i + 1]),
                                       jcache, jnp.int32(i))
        got, cache = tfm.decode_step(model, torch.as_tensor(toks[:, i:i + 1]),
                                     cache, i)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 2e-3 * np.abs(want).max()
        # decode against prefill: one token per step never overflows C
        assert (got - full[:, i]).abs().max() <= 2e-3 * full[:, i].abs().max()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_reference_f32(arch):
    """The loss (cross entropy + 0.01 aux) and every parameter's gradient,
    the router's through the gates and the aux loss, within 1e-4 of each
    leaf's largest |gradient|, with remat on (the recompute routes
    again)."""
    jcfg, params, model = pair(arch, "f32", remat=True)
    spec, jspec = configs.get(arch), jax_configs.get(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, jgrads = jax.jit(jax.value_and_grad(jax_configs.base.loss_for(
        jspec, jcfg)))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    ps = dict(model.named_parameters())
    for t in ps.values():
        t.requires_grad_(True)
    loss = configs.loss_for(spec, model.cfg)(
        model, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    wg = lm_params_from_reference(jax.tree.map(
        lambda g: np.asarray(g, np.float32), jgrads))
    assert grads.keys() == wg.keys()
    for name, g in grads.items():
        scale = float(wg[name].abs().max())
        err = float((g - wg[name]).abs().max())
        assert err <= 1e-4 * scale + 1e-30, (name, err, scale)
    assert float(grads["layers.0.moe.router"].abs().max()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_routes_as_the_first_pass(arch, monkeypatch):
    """With remat, the backward pass recomputes each layer and routes it
    again: the recomputed routes equal the first pass's, layer by layer,
    and the gradients equal those without remat bit for bit."""
    _, _, model = pair(arch, "f32", remat=True)
    spec = configs.get(arch)
    toks = tokens(model.cfg.vocab, 2, 17, seed=4)
    batch = {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])}
    rec = Recorder(monkeypatch)
    ps = dict(model.named_parameters())
    for t in ps.values():
        t.requires_grad_(True)
    g1 = torch.autograd.grad(configs.loss_for(spec, model.cfg)(model, batch),
                             list(ps.values()))
    L = model.cfg.n_layer
    assert len(rec.routes) == 2 * L
    first, again = rec.routes[:L], rec.routes[L:][::-1]
    for (_, a), (_, b) in zip(first, again):
        np.testing.assert_array_equal(a, b)
    model.cfg = dataclasses.replace(model.cfg, remat=False)
    g2 = torch.autograd.grad(configs.loss_for(spec, model.cfg)(model, batch),
                             list(ps.values()))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_qwen110b_smoke_forward_matches_reference():
    for dtype in ("f32", "bf16"):
        jcfg, params, model = pair("qwen1.5-110b", dtype)
        toks = tokens(jcfg.vocab, 2, 16)
        want, want_aux = jax_forward(params, jcfg, jnp.asarray(toks))
        got, aux = tfm.forward(model, torch.as_tensor(toks))
        want = np.asarray(want, np.float32)
        assert float(aux) == float(want_aux) == 0
        if dtype == "f32":
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
        else:
            assert np.abs(got.numpy() - want).max() <= 3e-2 * np.abs(
                want).max()


@pytest.mark.parametrize("case", ["base", "capacity_0.5",
                                  "groups_2_capacity_0.5_pad"])
def test_one_layer_model_with_drops_matches_reference_f32(case,
                                                          monkeypatch):
    """A 1-layer model (attention, then the MoE layer) over 2 x 128 tokens
    in f32, where capacity 0.5 drops assignments: the logits within 2e-3
    of max|logit| and aux within 1e-6 of the reference's."""
    jcfg, params, model = layer_pair(case, "f32")
    toks = tokens(jcfg.vocab, 2, 128)
    rec = Recorder(monkeypatch)
    want, want_aux = jax_forward(params, jcfg, jnp.asarray(toks))
    got, aux = tfm.forward(model, torch.as_tensor(toks))
    dropped = sum(int((~d[4]).sum()) for d in rec.dispatches)
    m = min(margin(pr, jcfg.moe.top_k) for pr, _ in rec.routes)
    print(f"{case}: {dropped} assignments dropped, smallest top-"
          f"{jcfg.moe.top_k} margin {m:.3e}")
    assert dropped > 0 or "capacity" not in case
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 2e-3 * np.abs(want).max()
    assert abs(float(aux) - float(want_aux)) <= 1e-6


# -- configs, counts, carry, the CLI ---------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_the_reference(arch):
    spec, ref = configs.get(arch), jax_configs.get(arch)
    assert (spec.family, spec.shapes, spec.skips, spec.source) == \
        (ref.family, ref.shapes, ref.skips, ref.source)
    for cfg, rcfg in ((spec.model_cfg, ref.model_cfg),
                      (spec.smoke_cfg, ref.smoke_cfg)):
        for f in ("name", "n_layer", "d_model", "n_head", "n_kv", "d_ff",
                  "vocab", "d_head", "rope_theta", "qkv_bias", "remat"):
            assert getattr(cfg, f) == getattr(rcfg, f), f
        if rcfg.moe is None:
            assert cfg.moe is None
        else:
            assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(rcfg.moe)
            assert cfg.moe.e_total == rcfg.moe.e_total
    assert spec.model_cfg.dtype == torch.bfloat16
    for shape in spec.shapes:
        for smoke in (False, True):
            cfg = configs.cell_model_cfg(spec, shape, smoke=smoke)
            rcfg = jax_configs.cell_model_cfg(ref, shape, smoke=smoke)
            assert configs.model_flops(spec, shape, model_cfg=cfg) == \
                jax_configs.model_flops(ref, shape, model_cfg=rcfg)
            assert configs.smoke_dims(spec, shape) == \
                jax_configs.smoke_dims(ref, shape)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_parameter_counts_match_the_reference(arch):
    cfg, rcfg = configs.get(arch).model_cfg, jax_configs.get(arch).model_cfg
    assert cfg.param_count == rcfg.param_count
    assert cfg.active_param_count == rcfg.active_param_count
    meta = tfm.abstract_params(cfg)
    n = sum(p.numel() for p in meta.parameters())
    assert n == cfg.param_count          # no pad experts in these configs


def test_qwen2_moe_counts():
    cfg = configs.get("qwen2-moe-a2.7b").model_cfg
    assert (cfg.param_count, cfg.active_param_count) == \
        (14_315_735_040, 2_689_124_352)
    assert configs.get("dbrx-132b").model_cfg.active_param_count < \
        configs.get("dbrx-132b").model_cfg.param_count


def test_model_flops_count_active_parameters():
    spec = configs.get("qwen2-moe-a2.7b")
    cfg = spec.model_cfg
    dims = dict(spec.shapes["prefill_32k"], batch=1, seq=4096)
    want = (2.0 * cfg.active_param_count * 4096
            + 2.0 * cfg.n_layer * 4096 * 4096 * cfg.n_head * cfg.d_head)
    assert configs.model_flops(spec, "prefill_32k", dims=dims) == want


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_carry_keeps_moe_names_and_shapes(arch):
    """``lm_params_from_reference`` carries every MoE leaf under the
    port's name, in its dtype, unchanged; the reference draws
    ``shared_wi`` and ``shared_wg`` from one key, so they stay equal."""
    jcfg = dataclasses.replace(jax_configs.get(arch).smoke_cfg,
                               dtype=jnp.bfloat16)
    params = jax_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    state = lm_params_from_reference(jax.tree.map(np.asarray, params))
    cfg = dataclasses.replace(configs.get(arch).smoke_cfg,
                              dtype=torch.bfloat16)
    meta = tfm.Transformer(cfg, device="meta").state_dict()
    assert set(state) == set(meta)
    for name, t in state.items():
        assert (t.shape, t.dtype) == (meta[name].shape, meta[name].dtype)
    assert state["layers.1.moe.router"].dtype == torch.float32
    moe = params["layers"]["moe"]
    for leaf in moe:
        np.testing.assert_array_equal(
            state[f"layers.1.moe.{leaf}"].float().numpy(),
            np.asarray(moe[leaf][1], np.float32))
    if jcfg.moe.n_shared:
        assert torch.equal(state["layers.0.moe.shared_wi"],
                           state["layers.0.moe.shared_wg"])


def test_init_params_scale_expert_weights_as_the_reference():
    """The port's init draws (E, d, f) expert weights at 1/sqrt(E) (the
    reference's ``_dense_init`` takes shape[0] as fan-in) and the router
    at 1/sqrt(d), in f32."""
    cfg = tfm.LMConfig("m", n_layer=1, d_model=256, n_head=2, n_kv=2,
                       d_ff=0, vocab=64, d_head=16,
                       moe=tfm.MoEConfig(n_experts=16, top_k=2,
                                         d_ff_expert=256, n_shared=4))
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    p = model.layers[0].moe
    assert p.router.dtype == torch.float32
    for t, scale in ((p.router, 256 ** -0.5), (p.wi, 16 ** -0.5),
                     (p.wo, 16 ** -0.5), (p.shared_wg, 4 ** -0.5)):
        assert abs(float(t.float().std()) / scale - 1) < 0.05


def test_serve_steps_of_a_moe_model():
    spec = configs.get("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(spec.smoke_cfg, dtype=torch.float32)
    model = configs.init_params(spec, cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    toks = torch.as_tensor(tokens(cfg.vocab, 2, 6))
    sm.reset_counts()
    logits = configs.make_serve_step(spec, "prefill_32k", cfg)(
        model, {"tokens": toks})
    assert logits.shape == (2, 6, cfg.vocab)
    decode = configs.make_serve_step(spec, "decode_32k", cfg)
    cache = tfm.init_cache(cfg, 2, 8, device="cpu")
    for i in range(6):
        step, cache = decode(model, {"tokens": toks[:, i:i + 1],
                                     "cache": cache, "cache_len": i})
        torch.testing.assert_close(step, logits[:, i], rtol=2e-3, atol=2e-3)
    assert sm.matmul.launches == 0           # CPU tensors launch nothing


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_runs_a_moe_model(arch):
    """``make_train_step`` on a MoE smoke model in bf16: every parameter's
    gradient finite and, but for the QKV biases', nonzero (the router's
    through the gates and the aux loss, every expert's through its rows);
    two steps with finite losses."""
    from repro_torch.optim import adamw
    spec = configs.get(arch)
    cfg = spec.smoke_cfg
    model = configs.init_params(spec, cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    fn = train.make_batch_fn(spec, cfg, configs.smoke_dims(spec, "train_4k"),
                             device="cpu")
    ps = dict(model.named_parameters())
    for t in ps.values():
        t.requires_grad_(True)
    grads = torch.autograd.grad(configs.loss_for(spec, cfg)(model, fn(0)),
                                list(ps.values()))
    for n, g in zip(ps, grads):
        assert bool(torch.isfinite(g.float()).all()), n
        assert n.endswith(("bq", "bk", "bv")) or bool(g.abs().max() > 0), n
    state = adamw.init_state(ps)
    step = configs.make_train_step(spec, cfg)
    losses = []
    for i in range(2):
        model, state, m = step(model, state, fn(i))
        losses.append(float(m["loss"]))
    assert all(math.isfinite(x) for x in losses)


def test_cli_trains_qwen2_moe_smoke(capsys):
    losses = train.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--steps",
                         "2", "--device", "cpu", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "[done]" in capsys.readouterr().out


# -- ties among router probabilities ------------------------------------------

def tied_probs(T=64, E=8, seed=5):
    """(T, E) f32 probabilities with exact ties: rows of random values
    where columns 3 and 4 copy column 1 and column 6 copies column 2, so
    ties fall inside the top K, across the K-th boundary and below it;
    plus rows all equal and rows with only the pad experts' zeros tied."""
    rng = np.random.default_rng(seed)
    p = rng.random((T, E)).astype(np.float32)
    p[:, 3] = p[:, 4] = p[:, 1]
    p[:, 6] = p[:, 2]
    p[: T // 8] = 1.0 / E
    p[T // 8: T // 4, E - 2:] = 0.0
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_route_breaks_ties_as_jax_top_k(K):
    """``route`` on probabilities with exact ties picks the experts,
    in the order, that ``jax.lax.top_k`` picks on the same array: the lower
    index first among equal values."""
    probs = tied_probs()
    _, want = jax.lax.top_k(jnp.asarray(probs), K)
    got = tfm.route(torch.as_tensor(probs), K)
    top = -np.sort(-probs, axis=-1)
    assert (top[:, K - 1] == top[:, K]).sum() >= 8     # boundary ties occur
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["base", "pad_experts_2"])
def test_moe_group_with_tied_router_columns_matches_the_reference(
        case, monkeypatch):
    """Ties through the layer: router columns copied so that every token's
    logits tie exactly (experts 3 and 4 copy expert 1, 5 copies 2), at the
    K-th boundary too; the port's ``eidx`` and ``dest`` equal the
    reference's ``jax.lax.top_k`` routing and dispatch, and the aux loss
    the reference's within 1e-6."""
    jcfg, jp, cfg, p = moe_layer(case, "f32")
    router = np.asarray(jp["router"]).copy()
    router[:, 3] = router[:, 4] = router[:, 1]
    router[:, 5] = router[:, 2]
    jp = dict(jp, router=jnp.asarray(router))
    with torch.no_grad():
        p.router.copy_(torch.as_tensor(router))
    xt = activations(cfg.d_model).reshape(-1, cfg.d_model)
    _, C = tfm.capacity(cfg.moe, xt.shape[0])
    K = cfg.moe.top_k
    r = reference_routing(jp, jcfg.moe, jnp.asarray(xt), C)
    _, want_aux = jax_moe_group(jp, jcfg.moe, jnp.asarray(xt), C)
    rec = Recorder(monkeypatch)
    with torch.no_grad():
        _, aux = tfm._moe_group(p, cfg.moe, torch.as_tensor(xt), C)
    probs, eidx = rec.routes[0]
    top = -np.sort(-probs, axis=-1)
    assert (top[:, K - 1] == top[:, K]).any()           # boundary ties occur
    np.testing.assert_array_equal(eidx, r["eidx"])
    np.testing.assert_array_equal(rec.dispatches[0][5], r["dest"])
    assert abs(float(aux) - float(want_aux)) <= 1e-6
