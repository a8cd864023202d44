"""Shape-bucketed micro-batcher (DESIGN.md §7.1). PyTorch port of
``repro.serving.batcher`` (host code).

Heavy traffic arrives as independent single queries; the device plane wants
thousands per launch. The micro-batcher is the adapter: callers get a
``concurrent.futures.Future`` back immediately, a worker thread collects
pending requests and flushes a batch when either

* the batch is full (``max_batch`` requests), or
* the oldest pending request has waited ``flush_ms`` (the latency SLO knob), or
* someone forces a flush (``flush()``, ``drain()``, ``close()``).

One batcher per index handle — requests against different workload
indexes can never share a device launch, so the engine keys batchers by
handle. Downstream shape bucketing (executor.py) pads each flushed batch to
a power of two, so the flush size need not be exact for a fixed set of
launch shapes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Sequence

from repro_torch.obs.locks import named_condition


@dataclasses.dataclass
class Request:
    """One TCCS query in flight.

    ``spec`` is the canonical :class:`repro_torch.core.query_api.TCCSQuery` the
    engine resolved (mode, k, clamped window); the positional ``u/ts/te``
    mirror it for the device plane's array packing and for legacy callers
    that construct bare requests.
    """

    u: int
    ts: int
    te: int
    future: Future
    t_submit: float          # engine submit time (e2e latency anchor)
    t_enqueue: float = 0.0   # batcher enqueue time (queue-wait anchor)
    spec: object | None = None  # canonical TCCSQuery (query API v2)
    # open root query span (repro_torch.obs.trace.Span) riding across the thread
    # boundary: the engine opens it on the caller thread, the planner hangs
    # queue/route/execute children off it on the worker thread (explicit
    # context propagation, DESIGN.md §11.2). None for bare legacy requests.
    span: object | None = None


class MicroBatcher:
    """Collects requests into batches and hands them to ``execute_fn``.

    ``execute_fn(batch) -> list[result]`` runs on the worker thread and must
    return one result per request, in order. The batcher resolves futures
    and records queue-wait / end-to-end latency; a raising ``execute_fn``
    fails every future in the batch (no request is silently dropped).
    """

    def __init__(self, execute_fn: Callable[[list[Request]], list],
                 *, max_batch: int = 256, flush_ms: float = 2.0,
                 name: str = "batcher", metrics=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._execute = execute_fn
        self.max_batch = max_batch
        self.flush_s = flush_ms / 1e3
        self._metrics = metrics
        self._pending: deque[Request] = deque()
        self._cond = named_condition("batcher")
        self._stop = False
        self._force_flush = False
        self._inflight = 0
        self._worker = threading.Thread(target=self._loop, daemon=True, name=name)
        self._worker.start()

    # -- producer side ---------------------------------------------------
    def submit(self, req: Request) -> Future:
        return self.submit_many([req])[0]

    def submit_many(self, reqs: Sequence[Request]) -> list[Future]:
        now = time.perf_counter()
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher is closed")
            for r in reqs:
                r.t_enqueue = now
                self._pending.append(r)
            self._cond.notify_all()
        return [r.future for r in reqs]

    def flush(self) -> None:
        """Dispatch whatever is pending without waiting for the deadline.
        A no-op when nothing is pending: the flag must not leak into the
        next batch's deadline wait."""
        with self._cond:
            if self._pending:
                self._force_flush = True
                self._cond.notify_all()

    def drain(self, timeout: float | None = None) -> None:
        """Block until every submitted request has been resolved.

        Raises ``TimeoutError`` only while work is genuinely outstanding.
        The predicate re-check directly before the raise makes that
        contract locally self-evident (and robust to future edits that
        might release the lock inside the loop body); under the current
        single condition lock the loop-top test already guarantees it —
        a deadline racing the worker's final notify re-tests the
        predicate at the top and drains cleanly."""
        end = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while self._pending or self._inflight:
                if self._pending:
                    self._force_flush = True
                self._cond.notify_all()
                wait = 0.05
                if end is not None:
                    wait = min(wait, end - time.perf_counter())
                    if wait <= 0:
                        if not (self._pending or self._inflight):
                            return      # emptied at the deadline: drained
                        raise TimeoutError("batcher drain timed out")
                self._cond.wait(timeout=wait)

    def close(self) -> None:
        """Flush remaining work and stop the worker."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._pending)

    # -- worker side -----------------------------------------------------
    def _count(self, name: str) -> None:
        if self._metrics is not None:
            self._metrics.count(name)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if self._stop and not self._pending:
                    return
                deadline = self._pending[0].t_enqueue + self.flush_s
                while (len(self._pending) < self.max_batch
                       and not self._force_flush and not self._stop):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                if len(self._pending) >= self.max_batch:
                    self._count("flush_full")
                elif self._stop:
                    self._count("flush_close")
                elif self._force_flush:
                    self._count("flush_forced")
                else:
                    self._count("flush_deadline")
                take = min(len(self._pending), self.max_batch)
                # Clear the force flag only once this dispatch drains the
                # queue. Clearing unconditionally would (a) swallow a
                # flush() aimed at requests beyond a simultaneously-full
                # batch (they'd sit out a whole deadline), and (b) if the
                # flag were ever set with nothing pending, leak it into the
                # next unrelated batch as a premature, miscounted
                # flush_forced dispatch.
                if take == len(self._pending):
                    self._force_flush = False
                batch = [self._pending.popleft() for _ in range(take)]
                self._inflight += take
            self._run_batch(batch)
            with self._cond:
                self._inflight -= len(batch)
                self._cond.notify_all()

    def _run_batch(self, batch: list[Request]) -> None:
        t0 = time.perf_counter()
        if self._metrics is not None:
            for r in batch:
                self._metrics.observe("queue_wait", t0 - r.t_enqueue)
        try:
            results = self._execute(batch)
            if len(results) != len(batch):
                raise RuntimeError(
                    f"execute_fn returned {len(results)} results for a "
                    f"batch of {len(batch)}")
        except BaseException as e:  # noqa: BLE001 — fail the futures, keep serving
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        now = time.perf_counter()
        for r, res in zip(batch, results):
            r.future.set_result(res)
            if self._metrics is not None:
                self._metrics.observe("e2e", now - r.t_submit)
