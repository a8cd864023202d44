"""The port's optimizer, token stream and restart runtime against the JAX
reference (``repro.optim.adamw``, ``repro.data.lm_data``,
``repro.runtime.fault_tolerance``), inputs drawn with numpy.

Tolerances:
* AdamW: the schedule, the global norm and every updated f32 parameter,
  ``mu`` and ``nu`` within rtol 1e-6 (the same f32 operations in the same
  order), plus 1e-6 of the leaf's largest value: the global norm sums its
  leaves in another order, so the clip scale can differ in its last bit,
  and where ``b1 * mu`` and ``(1 - b1) * g`` nearly cancel that bit is a
  larger share of the element. bf16 parameters within one unit in the
  last place. Both sides get the same gradients: AdamW's first step is
  about ``lr * sign(g)``, so a gradient near 0 of another sign would move
  a parameter by 2 lr.
* TokenStream: array-equal, within one process (the step seed comes from
  Python's ``hash``, which ``PYTHONHASHSEED`` changes between processes).
* The runner, injector and heartbeat: tests/test_fault.py's cases on the
  port's copies, exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import lm_data as jax_lm_data  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.lm_data import TokenStream  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FailureInjector, HeartbeatMonitor, RecoverableError, RestartingRunner)

CFGS = {
    "default": adamw.AdamWConfig(),
    "short warmup": adamw.AdamWConfig(lr=1e-2, warmup_steps=2,
                                      total_steps=10, clip_norm=0.5),
    "no decay, loose clip": adamw.AdamWConfig(lr=3e-3, weight_decay=0.0,
                                              clip_norm=100.0,
                                              warmup_steps=1,
                                              total_steps=5),
}


def jax_cfg(cfg: adamw.AdamWConfig) -> jax_adamw.AdamWConfig:
    return jax_adamw.AdamWConfig(**cfg.__dict__)


def ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One unit in the last place of bf16 values (as f32)."""
    x = np.abs(np.asarray(x, np.float32))
    exp = np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny)))
    return np.exp2(exp - 7)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_schedule_matches_the_reference(name):
    cfg = CFGS[name]
    for step in (0, 1, 2, 3, 5, 50, 99, 100, 101, 5_000, 9_999, 10_000,
                 20_000):
        got = float(adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(jax_adamw.schedule(jax_cfg(cfg), jnp.int32(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def tree(seed: int, dtypes=("f32", "bf16")):
    """Parameters and gradients of a few shapes, numpy f32, with a name per
    leaf and its dtype."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (37, 8), "layers.0.wq": (8, 12), "ln_f": (8,),
              "head": (8, 37), "layers.0.b": (12,)}
    leaves = {}
    for i, (name, shape) in enumerate(shapes.items()):
        dt = dtypes[i % len(dtypes)]
        leaves[name] = (dt, rng.normal(size=shape).astype(np.float32))
    return leaves, rng


def to_jax(a: np.ndarray, dt: str):
    return jnp.asarray(a, jnp.bfloat16 if dt == "bf16" else jnp.float32)


def to_torch(a, dt: str):
    t = torch.as_tensor(np.asarray(a, np.float32))
    return t.bfloat16() if dt == "bf16" else t


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("dtypes", [("f32",), ("bf16",), ("f32", "bf16")],
                         ids=["f32", "bf16", "mixed"])
def test_apply_updates_matches_the_reference(name, dtypes):
    """Three steps on the same parameters with the same gradients: the
    norm, the learning rate, every parameter and both moments."""
    cfg = CFGS[name]
    leaves, rng = tree(3, dtypes)
    jp = {n: to_jax(a, dt) for n, (dt, a) in leaves.items()}
    tp = {n: to_torch(a, dt) for n, (dt, a) in leaves.items()}
    js, ts = jax_adamw.init_state(jp), adamw.init_state(tp)
    assert all(m.dtype == torch.float32 for m in ts["mu"].values())
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for _ in range(3):
        grads = {n: rng.normal(size=a.shape).astype(np.float32)
                 * rng.choice([1e-3, 1.0, 30.0])
                 for n, (_, a) in leaves.items()}
        # both sides take the gradient in the parameter's dtype
        jg = {n: to_jax(g, leaves[n][0]) for n, g in grads.items()}
        tg = {n: torch.tensor(np.asarray(jg[n], np.float32)).to(
            tp[n].dtype) for n in grads}
        jp, js, jm = jax_adamw.apply_updates(jax_cfg(cfg), jp, jg, js)
        params, ts, tm = adamw.apply_updates(cfg, tp, tg, ts)
        assert params is tp
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        assert int(ts["step"]) == int(js["step"])
        for n, (dt, _) in leaves.items():
            for got, want in ((ts["mu"][n], js["mu"][n]),
                              (ts["nu"][n], js["nu"][n])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-6,
                    atol=1e-6 * np.abs(want).max())
            got = tp[n].float().numpy()
            want = np.asarray(jp[n], np.float32)
            if dt == "bf16":
                assert tp[n].dtype == torch.bfloat16
                assert (np.abs(got - want) <= ulp_bf16(want)).all(), n
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())


def test_global_norm_matches_the_reference():
    leaves, _ = tree(5)
    got = adamw.global_norm({n: to_torch(a, dt)
                             for n, (dt, a) in leaves.items()})
    want = jax_adamw.global_norm({n: to_jax(a, dt)
                                  for n, (dt, a) in leaves.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adamw_moves_toward_minimum():
    """tests/test_fault.py's toy problem on the port's AdamW."""
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=400, clip_norm=10.0)
    params = {"w": torch.tensor([4.0, -3.0])}
    state = adamw.init_state(params)
    for _ in range(400):
        adamw.apply_updates(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.2


def test_state_checkpoints_as_it_is(tmp_path):
    """The state is a plain dict of tensors: the port's CheckpointManager
    round-trips it bit for bit, bf16 parameters included."""
    leaves, _ = tree(7)
    params = {n: to_torch(a, dt) for n, (dt, a) in leaves.items()}
    state = adamw.init_state(params)
    adamw.apply_updates(adamw.AdamWConfig(), params,
                        {n: torch.ones_like(p) for n, p in params.items()},
                        state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params, "opt": state})
    step, back, _ = mgr.restore(device="cpu")
    assert step == 1
    for n, p in params.items():
        assert back["params"][n].dtype == p.dtype
        assert torch.equal(back["params"][n], p)
        assert torch.equal(back["opt"]["mu"][n], state["mu"][n])
        assert torch.equal(back["opt"]["nu"][n], state["nu"][n])
    assert torch.equal(back["opt"]["step"], state["step"])


@pytest.mark.parametrize("vocab,batch,seq", [(256, 2, 32), (1000, 3, 17),
                                             (151_552, 1, 8)])
@pytest.mark.parametrize("host", [(0, 1), (1, 4)])
def test_token_stream_equals_the_reference(vocab, batch, seq, host):
    ours = TokenStream(vocab, seed=3, host_id=host[0], n_hosts=host[1])
    theirs = jax_lm_data.TokenStream(vocab, seed=3, host_id=host[0],
                                     n_hosts=host[1])
    np.testing.assert_array_equal(ours.trans, theirs.trans)
    np.testing.assert_array_equal(ours.emit_logits, theirs.emit_logits)
    for step in (0, 1, 7):
        (t, lab), (wt, wlab) = (ours.batch(step, batch, seq),
                                theirs.batch(step, batch, seq))
        assert t.dtype == wt.dtype == np.int32
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(lab, wlab)
        np.testing.assert_array_equal(t[:, 1:], lab[:, :-1])
        assert 0 <= t.min() and t.max() < vocab


class TestRestartingRunner:
    def test_recovers_from_injected_faults(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        state0 = {"x": torch.zeros(())}

        def step_fn(state, step):
            return {"x": state["x"] + 1.0}

        def save_fn(step, state):
            mgr.save(step, state)

        def restore_fn():
            step, state, _ = mgr.restore(device="cpu")
            return step, state

        injector = FailureInjector(fail_at={7: "preemption", 23: "link flap"})
        runner = RestartingRunner(step_fn, save_fn, restore_fn,
                                  ckpt_every=5, injector=injector)
        save_fn(0, state0)
        end, state = runner.run(state0, 0, 30)
        assert end == 30
        assert float(state["x"]) == 30.0          # exactly-once semantics
        assert runner.restarts == 2
        assert runner.steps_lost > 0

    def test_gives_up_after_max_restarts(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(0, {"x": torch.zeros(())})
        injector = FailureInjector(fail_at={i: "flaky" for i in range(1, 50)})

        def step_fn(state, step):
            injector.fired.discard(step)
            return state

        runner = RestartingRunner(step_fn, lambda s, st: mgr.save(s, st),
                                  lambda: mgr.restore(device="cpu")[:2],
                                  ckpt_every=100, max_restarts=3,
                                  injector=injector)
        with pytest.raises(RecoverableError):
            runner.run({"x": torch.zeros(())}, 0, 10)


class TestHeartbeat:
    def test_straggler_flagged(self):
        mon = HeartbeatMonitor(n_hosts=4, threshold=1.5)
        for step in range(20):
            for h in range(4):
                mon.report(h, 1.0 if h != 2 else 3.0)
        assert mon.stragglers() == [2]

    def test_healthy_fleet_clean(self):
        mon = HeartbeatMonitor(n_hosts=4, threshold=2.0)
        rng = np.random.default_rng(0)
        for _ in range(50):
            for h in range(4):
                mon.report(h, 1.0 + 0.05 * rng.random())
        assert mon.stragglers() == []

    def test_callback_and_ratio(self):
        seen = []
        mon = HeartbeatMonitor(n_hosts=2, threshold=1.5,
                               on_straggler=lambda h, r: seen.append((h, r)))
        mon.report(0, 1.0)
        mon.report(1, 4.0)
        assert seen and seen[0][0] == 1 and seen[0][1] > 1.5


def test_injector_fires_once():
    inj = FailureInjector({2: "x"})
    inj.check(1)
    with pytest.raises(RecoverableError, match="step 2: x"):
        inj.check(2)
    inj.check(2)
