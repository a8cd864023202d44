"""Named locks, the declared lock hierarchy, and the runtime lock witness
(DESIGN.md §12.2). PyTorch port of ``repro.obs.locks`` (stdlib only,
copied so the port stands alone).

The serving plane is a small zoo of locks: the engine's batcher table, the
index registry's entry map, each micro-batcher's condition, the result
cache, the metrics registry, every latency histogram, the tracer ring and
the slow-query log. This module makes the order in which they may nest
explicit and machine-checkable:

* :data:`LOCK_HIERARCHY` is the **declared acquisition order**: a thread
  holding lock at rank *i* may only acquire locks of strictly greater rank.
  Any program whose acquisitions respect one total order cannot deadlock on
  these locks (a wait-for cycle needs at least one rank inversion).
* :func:`named_lock` / :func:`named_condition` are drop-in factories the
  subsystems use instead of bare ``threading.Lock()`` /
  ``threading.Condition()``. In production they return the plain stdlib
  primitive — zero overhead. With the witness enabled (the
  ``REPRO_LOCK_WITNESS`` env var) they return instrumented wrappers that
  report every acquisition to the process-wide :data:`WITNESS`.
* :class:`LockWitness` records the **acquisition edges** actually taken
  (outer held → inner acquired, with owning thread names so a report
  identifies the subsystem) and cross-checks them against the declared
  hierarchy: rank inversions, undeclared locks, and cycles in the observed
  edge graph are violations. The port's tests read its report.

The hierarchy lives here (next to the locks it ranks) rather than in a
config file: the witness must not depend on a file being readable at
import time. The ``store`` and ``checkpoint`` levels rank the disk tier's
and the checkpoint manager's locks, which arrive with ROADMAP A6.
"""

from __future__ import annotations

import os
import threading

#: Declared acquisition order, outermost first. A thread may acquire a lock
#: only while every lock it already holds has a strictly smaller rank.
#: Ordering rationale:
#:   engine    — ServingEngine._lock (batcher table, retention policies)
#:   registry  — IndexRegistry._lock (entries, graphs, epochs, pending)
#:   batcher   — MicroBatcher._cond (pending queue; workers count flushes
#:               into metrics while holding it)
#:   cache     — ResultCache._lock (LRU map, epoch floors)
#:   store     — IndexStore._lock (commit/load counters *only*: every byte
#:               of segment file I/O runs outside it; store code counts
#:               into metrics, so store ranks above metrics, and registry
#:               workers persist/demote while logically inside the
#:               registry plane, so it ranks below registry)
#:   metrics   — MetricsRegistry._lock (counters/gauges/hist table; the
#:               registry worker counts evictions under its own lock, so
#:               metrics must rank below registry)
#:   histogram — LatencyHistogram._lock (sample reservoir)
#:   slowlog   — SlowQueryLog._lock (entry ring)
#:   tracer    — Tracer._lock (finished-span ring; Span.end may be called
#:               under any of the above, so the tracer ranks below them)
#:   checkpoint— CheckpointManager._lock (worker slot + last error)
LOCK_HIERARCHY: tuple[str, ...] = (
    "engine", "registry", "batcher", "cache", "store", "metrics",
    "histogram", "slowlog", "tracer", "checkpoint",
)

_ENV_FLAG = "REPRO_LOCK_WITNESS"


def witness_enabled() -> bool:
    """True when the process-wide witness is armed (env flag). Checked at
    lock *construction* time: objects built before the flag flips keep
    plain locks, so the flag must be set before the engine is built."""
    return os.environ.get(_ENV_FLAG, "") not in ("", "0", "false", "no")


class LockWitness:
    """Records lock-acquisition edges per thread and checks them against a
    declared hierarchy.

    Thread-safe; the witness's own bookkeeping lock is a plain
    ``threading.Lock`` (it is not itself witnessed — it nests strictly
    innermost and is never held across user code). Violations are
    deduplicated by (kind, outer, inner) so a hot loop cannot grow the
    report without bound.
    """

    def __init__(self, hierarchy: tuple[str, ...] = LOCK_HIERARCHY):
        self.hierarchy = tuple(hierarchy)
        self._ranks = {name: i for i, name in enumerate(self.hierarchy)}
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (outer, inner) -> {"count": int, "threads": set[str]}
        self._edges: dict[tuple[str, str], dict] = {}
        # (kind, outer, inner) -> {"count": int, "threads": set[str]}
        self._violations: dict[tuple[str, str | None, str], dict] = {}
        self.acquisitions = 0

    # -- per-thread hold stack -------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held(self) -> tuple[str, ...]:
        """The calling thread's current hold stack, outermost first."""
        return tuple(self._stack())

    # -- instrumentation callbacks ---------------------------------------
    def on_acquire(self, name: str) -> None:
        st = self._stack()
        tname = threading.current_thread().name
        with self._mu:
            self.acquisitions += 1
            if st:
                outer = st[-1]
                edge = self._edges.setdefault(
                    (outer, name), {"count": 0, "threads": set()})
                edge["count"] += 1
                edge["threads"].add(tname)
                ro = self._ranks.get(outer)
                ri = self._ranks.get(name)
                if ro is None or ri is None:
                    bad = outer if ro is None else name
                    self._note("undeclared-lock", outer, name, tname,
                               f"lock {bad!r} is not in the declared "
                               f"hierarchy")
                elif ri <= ro:
                    self._note("lock-order", outer, name, tname,
                               f"acquired {name!r} (rank {ri}) while "
                               f"holding {outer!r} (rank {ro}); the "
                               "hierarchy requires strictly increasing "
                               "rank")
            elif name not in self._ranks:
                self._note("undeclared-lock", None, name, tname,
                           f"lock {name!r} is not in the declared "
                           f"hierarchy")
        st.append(name)

    def on_release(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    def _note(self, kind: str, outer: str | None, inner: str,
              thread: str, message: str) -> None:
        v = self._violations.setdefault(
            (kind, outer, inner),
            {"kind": kind, "outer": outer, "inner": inner,
             "message": message, "count": 0, "threads": set()})
        v["count"] += 1
        v["threads"].add(thread)

    # -- reading ----------------------------------------------------------
    def edges(self) -> list[dict]:
        with self._mu:
            return [
                {"outer": o, "inner": i, "count": e["count"],
                 "threads": sorted(e["threads"])}
                for (o, i), e in sorted(self._edges.items())
            ]

    def violations(self) -> list[dict]:
        with self._mu:
            return [dict(v, threads=sorted(v["threads"]))
                    for v in self._violations.values()]

    def _find_cycle(self) -> list[str] | None:
        """One cycle in the observed edge graph, if any (DFS). Rank
        inversions already imply one, but undeclared locks can form a
        cycle the rank check never sees."""
        with self._mu:
            adj: dict[str, list[str]] = {}
            for (o, i) in self._edges:
                adj.setdefault(o, []).append(i)
        state: dict[str, int] = {}          # 1 = on stack, 2 = done
        path: list[str] = []

        def visit(node: str) -> list[str] | None:
            state[node] = 1
            path.append(node)
            for nxt in adj.get(node, ()):
                if state.get(nxt) == 1:
                    return path[path.index(nxt):] + [nxt]
                if state.get(nxt) is None:
                    cyc = visit(nxt)
                    if cyc is not None:
                        return cyc
            path.pop()
            state[node] = 2
            return None

        for node in list(adj):
            if state.get(node) is None:
                cyc = visit(node)
                if cyc is not None:
                    return cyc
        return None

    def check(self) -> list[dict]:
        """Deduplicated problems: rank inversions, undeclared locks, and
        any cycle in the observed acquisition-edge graph. Empty means the
        run respected the declared hierarchy."""
        problems = self.violations()
        cycle = self._find_cycle()
        if cycle is not None:
            problems.append({
                "kind": "lock-cycle",
                "cycle": cycle,
                "message": "observed acquisition edges form a cycle "
                           f"(potential deadlock): {' -> '.join(cycle)}",
            })
        return problems

    def report(self) -> dict:
        """JSON-able summary of the edges and problems."""
        return {
            "hierarchy": list(self.hierarchy),
            "acquisitions": self.acquisitions,
            "edges": self.edges(),
            "problems": self.check(),
        }

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._violations.clear()
            self.acquisitions = 0


#: Process-wide witness instance the instrumented wrappers report into.
WITNESS = LockWitness()


class WitnessLock:
    """A ``threading.Lock`` reporting acquisitions to a witness."""

    __slots__ = ("name", "_witness", "_inner")

    def __init__(self, name: str, witness: LockWitness):
        self.name = name
        self._witness = witness
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.on_acquire(self.name)
        return got

    def release(self) -> None:
        self._witness.on_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"WitnessLock({self.name!r})"


class WitnessCondition:
    """A ``threading.Condition`` whose monitor acquisitions report to a
    witness. ``wait`` releases and re-acquires the underlying lock inside
    the stdlib condition; the witness keeps the level on the waiter's hold
    stack throughout — the waiting thread still logically owns the monitor
    section and acquires nothing else while blocked."""

    __slots__ = ("name", "_witness", "_cond")

    def __init__(self, name: str, witness: LockWitness):
        self.name = name
        self._witness = witness
        self._cond = threading.Condition()

    def acquire(self, *args) -> bool:
        got = self._cond.acquire(*args)
        if got:
            self._witness.on_acquire(self.name)
        return got

    def release(self) -> None:
        self._witness.on_release(self.name)
        self._cond.release()

    def __enter__(self) -> "WitnessCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def wait(self, timeout: float | None = None) -> bool:
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"WitnessCondition({self.name!r})"


def named_lock(name: str, witness: LockWitness | None = None):
    """A lock carrying a hierarchy level name.

    Returns a plain ``threading.Lock`` unless the witness is armed
    (``REPRO_LOCK_WITNESS``) or an explicit ``witness`` is passed — the
    production fast path pays nothing for the instrumentation hook."""
    w = witness if witness is not None else (
        WITNESS if witness_enabled() else None)
    if w is None:
        return threading.Lock()
    return WitnessLock(name, w)


def named_condition(name: str, witness: LockWitness | None = None):
    """Condition-variable analogue of :func:`named_lock`."""
    w = witness if witness is not None else (
        WITNESS if witness_enabled() else None)
    if w is None:
        return threading.Condition()
    return WitnessCondition(name, w)
