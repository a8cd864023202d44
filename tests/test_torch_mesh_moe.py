"""The port's MoE layer under the partitioner (``models.transformer``'s
:func:`moe_ffn` on a model placed on a ``(data, model)`` mesh: the experts
over ``model`` where they divide it, TP inside each expert where not, the
dispatch buffer's C rows over ``data``) against the JAX package's
single-device step.

As in ``tests/test_torch_mesh.py``, the reference's own sharded tests
(``tests/test_distributed.py``) fail in this container on every run, so
every mesh is held to the reference's single-device step, jitted on the
CPU: a correct partition reproduces one device's ``moe_ffn`` over the
global batch, whose drops depend on every data rank's tokens.

* qwen2-moe's smoke config (6 experts, top-2, one shared expert: EP on 2
  model ranks, expert TP on 4) and dbrx's (4 experts; 2 kv heads on 4
  model ranks) in f32, the parameters and AdamW state carried from one
  reference step (``lm_params_from_reference(tree, mesh)``,
  ``adamw_state_from_reference(state, mesh)``), 4 x 19 tokens from a
  numpy seed. Cases (``torch_rank_bodies.MOE_CASES``): qwen2-moe at
  capacity factor 1.25 (binding: C = 32 for 76 tokens' 152 assignments,
  remat on) with one group and with two (on 4 data ranks each group spans
  two), dbrx at 8.0 (not binding). On the
  2-, 4- and 8-rank gloo worlds (``MESHES``): the prefill's logits and
  four decode steps within 1e-4 of max|logit|; one train step's loss,
  ``grad_norm``, ``lr``, every updated parameter and both moments,
  gathered, within 1e-4 of each leaf's largest |value|. The key bias's
  gradient is 0 in exact arithmetic (it shifts every score of a query
  alike, and the softmax cancels it), so what is left is rounding: its
  first moment is held to ``wk``'s scale and its parameter besides to
  1e-2 of the learning rate, as ``test_torch_mesh.py`` holds glm4's.
* The prefill's routes (every token's experts), every group's ``dest``
  (so the kept and dropped assignments) equal the reference's, and its
  aux loss within 1e-6 a layer; the smallest top-K margin is printed.
* qwen2-moe in bf16 at (2, 2), held to the port's own step on whole
  tensors with its routes replayed, within 5e-2 (PERF.md section 2's bf16
  bound); the assignments the ranks' own routing would flip are counted.
* ``set_moe_impl``'s a2a on a placed model raises.
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
from repro_torch.core.carry import lm_params_from_reference  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

import torch_rank_bodies as bodies  # noqa: E402

B, S = 4, 19
DECODE_STEPS = 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: a world's hard timeout from the moment the fixture waits for it: the
#: three worlds run at once, beside the reference's answers
WORLD_TIMEOUT_S = 300.0
#: the key bias, whose gradient is rounding alone (module docstring): its
#: step within this share of the learning rate on top of its scale
LR_SHARE = {"bk": 1e-2}


def flat(tree, prefix: str) -> dict:
    """A nested dict of arrays as ``<prefix>/a/b`` keys, in f32."""
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


def jax_cfg(case: str):
    """The reference's config of a case: its smoke config with the
    port's overrides."""
    cfg = bodies.moe_case_cfg(case)
    arch, over, _ = bodies.MOE_CASES[case]
    return dataclasses.replace(
        jax_configs.get(arch).smoke_cfg, dtype=jnp.float32, **over,
        moe=jax_tfm.MoEConfig(**dataclasses.asdict(cfg.moe)))


def layer_inputs(params, jcfg, toks):
    """The reference forward's MoE inputs ``rms_norm(x, ln2)`` of every
    layer, its own functions in its order (``_layer_fn``)."""
    x = params["embed"][toks]
    positions = jnp.arange(toks.shape[1], dtype=jnp.int32)[None, :]
    hs = []
    for i in range(jcfg.n_layer):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        a, _ = jax_tfm.attention_block(lp, jcfg, jax_tfm.rms_norm(
            x, lp["ln1"]), positions)
        hs.append(jax_tfm.rms_norm(x + a, lp["ln2"]))
        x, _, _ = jax_tfm._layer_fn(jcfg, x, lp, positions)
    return hs


def group_routing(router, mcfg, xt, C):
    """One group's routing and dispatch, the reference's ``_moe_group``'s
    lines up to the buffer: probabilities, expert ids, ``dest``."""
    Tg, _ = xt.shape
    E, K = mcfg.e_total, mcfg.top_k
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = jnp.searchsorted(se, jnp.arange(E, dtype=se.dtype), side="left")
    pos = jnp.arange(Tg * K, dtype=jnp.int32) - starts[se].astype(jnp.int32)
    dest = jnp.where(pos < C, se.astype(jnp.int32) * C + pos, E * C)
    return probs, eidx, dest


def carried(case: str, inputs: dict):
    """One reference step from its init, whose state the ranks carry
    (``moe.<case>.*`` in ``inputs``): ``(jitted step, params, state)``."""
    jcfg = jax_cfg(case)
    arch = bodies.MOE_CASES[case][0]
    params = jax_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    step = jax.jit(jax_configs.make_train_step(
        jax_configs.get(arch), jcfg, jax_adamw.AdamWConfig(**OPT)))
    b0 = lm_batch(jcfg.vocab, 0)
    params, state, _ = step(params, jax_adamw.init_state(params),
                            {k: jnp.asarray(v) for k, v in b0.items()})
    pre = f"moe.{case}"
    inputs.update(flat(params, f"{pre}.p"))
    inputs.update(flat(state["mu"], f"{pre}.mu"))
    inputs.update(flat(state["nu"], f"{pre}.nu"))
    inputs[f"{pre}.step"] = np.asarray(state["step"])
    return step, params, state


def reference(case: str, inputs: dict, step, params, state) -> dict:
    """The reference's single-device answers of a case from its carried
    state: the prefill's logits, aux, routes and every group's ``dest``,
    the decode steps' logits, and a second step's metrics, parameters and
    moments."""
    jcfg = jax_cfg(case)
    mcfg, T = jcfg.moe, B * S
    G, C = tfm.capacity(bodies.moe_case_cfg(case).moe, T)
    Tg = T // G

    @jax.jit
    def prefill(p, t):
        """The forward's logits and aux, and each layer's routing."""
        out = []
        for i, h in enumerate(layer_inputs(p, jcfg, t)):
            router = p["layers"]["moe"]["router"][i]
            xt = h.reshape(T, -1)
            out.append([group_routing(router, mcfg, xt[g * Tg:(g + 1) * Tg],
                                      C) for g in range(G)])
        return jax_tfm.forward(p, jcfg, t), out

    (logits, aux), routes = prefill(params, jnp.asarray(inputs["moe.fwd"]))
    want = {"logits": np.asarray(logits, np.float32), "aux": float(aux)}
    for i, groups in enumerate(routes):
        want[f"probs.{i}"] = np.concatenate([np.asarray(g[0]) for g in groups])
        want[f"route.{i}"] = np.concatenate([np.asarray(g[1]) for g in groups])
    want["dest"] = np.stack([np.asarray(g[2]) for groups in routes
                             for g in groups])
    cache = jax_tfm.init_cache(jcfg, B, DECODE_STEPS + 2)
    dec = jax.jit(lambda p, t, c, n: jax_tfm.decode_step(p, jcfg, t, c, n))
    for i in range(DECODE_STEPS):
        out, cache = dec(params, jnp.asarray(inputs["moe.dec"][i]), cache,
                         jnp.int32(i))
        want[f"decode.{i}"] = np.asarray(out, np.float32)
    params, state, m = step(params, state, {
        k: jnp.asarray(inputs[f"moe.{k}"]) for k in ("tokens", "labels")})
    want.update({k: float(v) for k, v in m.items()})
    carry = {"param": params, "mu": state["mu"], "nu": state["nu"]}
    for what, tree in carry.items():
        host = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
        for n, t in lm_params_from_reference(host).items():
            want[f"{what}.{n}"] = t.numpy()
    return want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's answers of every case and every rank's results of
    the 2-, 4- and 8-rank worlds. The worlds start as soon as the carried
    states are drawn and run while the reference computes its answers."""
    tmp = tmp_path_factory.mktemp("mesh_moe")
    rng = np.random.default_rng(7)
    vocab = min(bodies.moe_case_cfg(c).vocab for c in bodies.MOE_CASES)
    inputs = {"moe.fwd": rng.integers(0, vocab, (B, S)).astype(np.int32),
              "moe.dec": rng.integers(0, vocab, (DECODE_STEPS, B, 1)).astype(
                  np.int32)}
    inputs.update({f"moe.{k}": v for k, v in lm_batch(vocab, 1).items()})
    states = {case: carried(case, inputs) for case in bodies.MOE_CASES}
    path = tmp / "inputs.npz"
    np.savez(path, **inputs)
    started = {world: bodies.start_world(world, path, tmp, suite="moe")
               for world in bodies.MESHES}
    want = {case: reference(case, inputs, *states[case])
            for case in bodies.MOE_CASES}
    out = {"want": want}
    for world, run in started.items():
        out[world] = bodies.wait_world(run, WORLD_TIMEOUT_S)
    return out


def cases():
    return [(world, bodies.mesh_key(shape), case)
            for world, shapes in bodies.MESHES.items() for shape in shapes
            for case in bodies.MOE_CASES]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def scale_of(want: dict, key: str) -> float:
    """A leaf's largest |value|; the key bias's first moment takes its
    layer's wk's."""
    if key.startswith("mu.") and key.endswith(".bk"):
        key = key[:-3] + ".wk"
    return float(np.abs(want[key]).max())


class Shape:
    """A (data, model) mesh by its sizes alone, for the spec policy."""

    def __init__(self, mesh: str):
        self.shape = dict(zip(("data", "model"), map(int, mesh.split("x"))))
        self.axis_names = ("data", "model")


def leaves_of(ranks, key: str, mesh: str, cfg) -> dict:
    """Every parameter and moment, whole, from the ranks' shards."""
    specs = shd.lm_param_spec_tree(tfm.abstract_params(cfg), Shape(mesh))
    shape = tuple(Shape(mesh).shape.values())
    out = {}
    for what in ("param", "mu", "nu"):
        for n, spec in specs.items():
            out[f"{what}.{n}"] = bodies.assemble(
                [r[f"{key}{what}.{n}"] for r in ranks], spec, shape)
    return out


def check_step(ranks, want, key, tol, leaves):
    """The prefill's and decode's logits, the step's metrics (one value
    on every rank) and every leaf (``leaves``, assembled), as
    ``test_torch_mesh.check_lm``."""
    r0 = ranks[0]
    for name in ["logits"] + [f"decode.{i}" for i in range(DECODE_STEPS)]:
        got = r0[f"{key}{name}"]
        assert got.shape == want[name].shape, name
        assert rel(got, want[name]) <= tol, (name, rel(got, want[name]))
    for name in ("loss", "grad_norm", "lr"):
        vals = [float(r[f"{key}{name}"]) for r in ranks]
        assert len(set(vals)) == 1, (name, vals)
        assert abs(vals[0] - float(want[name])) <= tol * abs(float(
            want[name])), (name, vals[0], want[name])
    names = [k for k in want if k.split(".")[0] in ("param", "mu", "nu")]
    assert sorted(names) == sorted(leaves)
    bad = []
    for name in names:
        got = leaves[name]
        assert got.shape == want[name].shape, name
        err = float(np.abs(got.astype(np.float64) - want[name]).max())
        bound = tol * scale_of(want, name)
        if name.startswith("param."):
            bound += LR_SHARE.get(name.rsplit(".", 1)[-1], 0.0) * OPT["lr"]
        if not err <= bound:
            bad.append((name, err, bound))
    assert not bad, bad


@pytest.mark.parametrize("world,mesh,case", cases())
def test_partitioned_moe_step_equals_reference(worlds, world, mesh, case):
    key = f"{case}|{mesh}|"
    check_step(worlds[world], worlds["want"][case], key, TOL["float32"],
               leaves_of(worlds[world], key, mesh,
                         bodies.moe_case_cfg(case)))


@pytest.mark.parametrize("world,mesh,case", cases())
def test_moe_routes_drops_and_aux_equal_reference(worlds, world, mesh,
                                                  case):
    """Every token's experts and every group's ``dest`` (the kept and the
    dropped assignments), on every rank, equal the reference's; the aux
    loss within 1e-6 a layer. Capacity 1.25 binds, 8.0 does not."""
    want = worlds["want"][case]
    cfg = bodies.moe_case_cfg(case)
    L, K = cfg.n_layer, cfg.moe.top_k
    top = -np.sort(-np.stack([want[f"probs.{i}"] for i in range(L)]), -1)
    margin = float((top[..., K - 1] - top[..., K]).min())
    print(f"{case} on {mesh}: smallest top-{K} margin {margin:.3e}")
    _, C = tfm.capacity(cfg.moe, B * S)
    dropped = int((want["dest"] == cfg.moe.e_total * C).sum())
    for r in worlds[world]:
        key = f"{case}|{mesh}|"
        for i in range(L):
            got = r[f"{key}route.{i}"]
            differ = int((np.sort(got, -1) != np.sort(want[f"route.{i}"],
                                                      -1)).sum())
            assert differ == 0, (i, differ, margin)
        np.testing.assert_array_equal(r[f"{key}dest"], want["dest"])
        assert abs(float(r[f"{key}aux"]) - want["aux"]) <= 1e-6 * L
    if cfg.moe.capacity_factor == 1.25:
        assert dropped > 0
    else:
        assert dropped == 0


def test_partitioned_moe_bf16_step_within_bf16_bound(worlds):
    """qwen2-moe in bf16 on (2, 2) against the port's own step on whole
    tensors, its routes replayed on the ranks: logits, metrics, every leaf
    within 5e-2; the key, query and value biases' parameters besides
    within 2 lr (their small bf16 gradients are mostly rounding, so AdamW
    may step them either way, as ``test_torch_mesh.py`` holds glm4's)."""
    ranks = worlds[4]
    r0 = ranks[0]
    want = {k.split("|", 2)[2][len("want."):]: v for k, v in r0.items()
            if k.startswith("moe_bf16|2x2|want.")}
    got_key = "moe_bf16|2x2|got."
    flips = sum(int(r[got_key + "flips"]) for r in ranks)
    print(f"bf16 on (2, 2): {flips} assignments the ranks' own routing "
          f"would send to another expert")
    tol = TOL["bfloat16"]
    for name in ["logits"] + [f"decode.{i}" for i in range(DECODE_STEPS)]:
        assert rel(r0[got_key + name], want[name]) <= tol, name
    for name in ("loss", "grad_norm", "lr"):
        assert abs(float(r0[got_key + name]) - float(want[name])) <= \
            tol * abs(float(want[name])), name
    got = leaves_of(ranks, got_key, "2x2",
                    bodies.lm_cfg("qwen2-moe-a2.7b", "bfloat16"))
    bad = []
    for name in (k for k in want if k.split(".")[0] in ("param", "mu",
                                                         "nu")):
        err = float(np.abs(got[name].astype(np.float64)
                           - want[name]).max())
        bound = tol * scale_of(want, name)
        if name.startswith("param.") and name.rsplit(".", 1)[-1] in (
                "bq", "bk", "bv"):
            bound += 2.0 * OPT["lr"]
        if not err <= bound:
            bad.append((name, err, bound))
    assert not bad, bad


def test_a2a_on_a_placed_model_raises(worlds):
    for r in worlds[4]:
        msg = str(r["a2a_placed|2x2|raised"])
        assert "set_moe_impl" in msg and "shards" in msg, msg
