"""Fault tolerance of the training driver: the restarting step loop, a
heartbeat/straggler monitor and failure injection. The port's copy of
``repro.runtime.fault_tolerance`` (DESIGN.md §4), numpy and the standard
library only.

* **Checkpoint/restart** — :class:`RestartingRunner` runs the step loop;
  a step raising :class:`RecoverableError` rolls back to the latest
  checkpoint and resumes, up to ``max_restarts``; the checkpoint cadence
  bounds the lost work.
* **Straggler detection** — :class:`HeartbeatMonitor` keeps an EWMA of
  per-host step latencies and flags hosts slower than ``threshold`` x the
  median.
* **Failure injection** — :class:`FailureInjector` raises scripted faults
  at chosen steps, so the restart path is itself under test.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


class RecoverableError(RuntimeError):
    """A fault the runner recovers from (preemption, link flap...)."""


@dataclasses.dataclass
class FailureInjector:
    """Raise scripted failures at given steps (once each)."""

    fail_at: dict[int, str] = dataclasses.field(default_factory=dict)
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RecoverableError(
                f"injected fault at step {step}: {self.fail_at[step]}")


class HeartbeatMonitor:
    """Per-host step-latency EWMA with a straggler callback.

    ``report(host, seconds)`` after every step; a host whose EWMA exceeds
    ``threshold`` x the median EWMA is flagged through ``on_straggler``.
    """

    def __init__(self, n_hosts: int, threshold: float = 2.0,
                 alpha: float = 0.3,
                 on_straggler: Callable[[int, float], None] | None = None):
        self.ewma = np.zeros(n_hosts)
        self.seen = np.zeros(n_hosts, bool)
        self.threshold = threshold
        self.alpha = alpha
        self.on_straggler = on_straggler or (lambda host, ratio: None)
        self.flagged: list[tuple[int, float]] = []

    def report(self, host: int, seconds: float):
        if not self.seen[host]:
            self.ewma[host] = seconds
            self.seen[host] = True
        else:
            self.ewma[host] = (self.alpha * seconds
                               + (1 - self.alpha) * self.ewma[host])
        if self.seen.all():
            med = float(np.median(self.ewma))
            ratio = self.ewma[host] / max(med, 1e-9)
            if ratio > self.threshold:
                self.flagged.append((host, ratio))
                self.on_straggler(host, ratio)

    def stragglers(self) -> list[int]:
        return sorted({h for h, _ in self.flagged})


class RestartingRunner:
    """Run a step loop with checkpoint-restart on recoverable faults.

    ``state`` is any tree of tensors; ``step_fn(state, step) -> state``;
    ``save_fn(step, state)`` and ``restore_fn() -> (step, state)`` plug
    into the ``CheckpointManager``. The loop saves every ``ckpt_every``
    steps and once at the end.
    """

    def __init__(self, step_fn, save_fn, restore_fn, *,
                 ckpt_every: int = 50, max_restarts: int = 5,
                 injector: FailureInjector | None = None,
                 monitor: HeartbeatMonitor | None = None):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.monitor = monitor
        self.restarts = 0
        self.steps_lost = 0

    def run(self, state, start_step: int, num_steps: int):
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                t0 = time.perf_counter()
                if self.injector is not None:
                    self.injector.check(step)
                state = self.step_fn(state, step)
                if self.monitor is not None:
                    self.monitor.report(0, time.perf_counter() - t0)
                step += 1
                if step % self.ckpt_every == 0:
                    self.save_fn(step, state)
            except RecoverableError:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                restored_step, state = self.restore_fn()
                self.steps_lost += step - restored_step
                step = restored_step
        self.save_fn(step, state)
        return step, state
