"""Unified metrics registry: counters, gauges, histograms, stat sources
(DESIGN.md §11.4). PyTorch port of ``repro.obs.registry`` (stdlib only).

One object absorbs everything the serving plane counts or times:

* **counters** — monotonically increasing ints (cache hits, routed
  queries, kernel builds);
* **gauges** — point-in-time values, either set directly or registered as
  callables resolved at snapshot time (resident device count, kernel
  builds);
* **histograms** — :class:`LatencyHistogram` per stage (queue wait,
  device exec, end-to-end), summarized as p50/p95/p99/mean with linear
  interpolation;
* **sources** — pluggable callables returning stat dicts (the result
  cache's and index registry's ``stats()``), pulled into the same
  snapshot so one export carries the whole serving plane.

``snapshot()`` is the single read surface;
:func:`repro_torch.obs.export.metrics_to_json` round-trips it. The serving
engine's ``EngineMetrics`` subclasses this registry, so every existing
``count``/``observe`` call site feeds the unified surface unchanged.
"""

from __future__ import annotations

import math
import random
from typing import Callable

from .locks import named_lock


class LatencyHistogram:
    """Latency samples (seconds) with percentile summaries.

    Keeps exact samples up to ``cap``; beyond that, new samples replace a
    uniformly random slot (classic reservoir), so long benches keep an
    unbiased view without unbounded memory. ``count``/``total`` stay exact.

    Thread-safe: ``add`` and the readers share one internal lock —
    batcher workers, caller threads resolving cache hits, and the stats
    reader all touch the same object (the §11.4 audit gave the histogram
    its own lock instead of relying on callers to serialize).

    Percentiles interpolate linearly between adjacent order statistics
    (the numpy ``"linear"`` convention) rather than rounding to the
    nearest rank, so p99 is stable at small sample counts instead of
    snapping between extreme samples.
    """

    def __init__(self, cap: int = 65536, seed: int = 0):
        self._cap = cap
        self._rng = random.Random(seed)
        self._lock = named_lock("histogram")
        self._samples: list[float] = []
        self.count = 0
        self.total = 0.0

    def add(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            if len(self._samples) < self._cap:
                self._samples.append(seconds)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._samples[j] = seconds

    @staticmethod
    def _pct(sorted_samples: list[float], q: float) -> float:
        """Linear-interpolated percentile of pre-sorted samples."""
        if not sorted_samples:
            return 0.0
        n = len(sorted_samples)
        pos = min(max(q, 0.0), 100.0) / 100.0 * (n - 1)
        lo = int(math.floor(pos))
        frac = pos - lo
        if frac <= 0.0 or lo + 1 >= n:
            return sorted_samples[lo]
        return sorted_samples[lo] + frac * (sorted_samples[lo + 1]
                                            - sorted_samples[lo])

    def _sorted_snapshot(self) -> tuple[list[float], int, float]:
        with self._lock:
            return sorted(self._samples), self.count, self.total

    def percentile(self, q: float) -> float:
        s, _, _ = self._sorted_snapshot()
        return self._pct(s, q)

    def summary(self) -> dict:
        ms = 1e3
        s, count, total = self._sorted_snapshot()
        return {
            "count": count,
            "mean_ms": (total / count * ms) if count else 0.0,
            "p50_ms": self._pct(s, 50) * ms,
            "p95_ms": self._pct(s, 95) * ms,
            "p99_ms": self._pct(s, 99) * ms,
            "max_ms": (s[-1] * ms) if s else 0.0,
        }


class MetricsRegistry:
    """Thread-safe registry of counters + gauges + per-stage latency
    histograms + external stat sources, behind one snapshot surface."""

    def __init__(self):
        self._lock = named_lock("metrics")
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, object] = {}          # value or callable
        self._hists: dict[str, LatencyHistogram] = {}
        self._sources: dict[str, Callable[[], dict]] = {}

    # -- counters ---------------------------------------------------------
    def count(self, name: str, inc: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # -- gauges -----------------------------------------------------------
    def gauge(self, name: str, value) -> None:
        """Set a point-in-time gauge. ``value`` may be a number or a
        zero-arg callable resolved lazily at snapshot time."""
        with self._lock:
            self._gauges[name] = value

    def gauge_value(self, name: str):
        with self._lock:
            v = self._gauges.get(name)
        return v() if callable(v) else v

    # -- histograms -------------------------------------------------------
    def observe(self, stage: str, seconds: float) -> None:
        # get-or-create under the registry lock; the sample lands under
        # the histogram's own lock so concurrent observers of one stage
        # don't serialize on the whole registry
        with self._lock:
            h = self._hists.get(stage)
            if h is None:
                h = self._hists[stage] = LatencyHistogram()
        h.add(seconds)

    def histogram(self, stage: str) -> LatencyHistogram | None:
        with self._lock:
            return self._hists.get(stage)

    # -- sources ----------------------------------------------------------
    def register_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Attach an external stats provider (``cache.stats``,
        ``registry.stats``): its dict is pulled into every snapshot under
        ``sources[name]``."""
        with self._lock:
            self._sources[name] = fn

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    # -- read surface -----------------------------------------------------
    def snapshot(self, include_sources: bool = True) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            sources = dict(self._sources)
        snap = {
            "counters": counters,
            # callables resolve outside the registry lock: a source or
            # gauge may take its own lock (cache/registry stats do)
            "gauges": {k: (v() if callable(v) else v)
                       for k, v in gauges.items()},
            "latency": {k: h.summary() for k, h in hists.items()},
        }
        if include_sources:
            snap["sources"] = {k: fn() for k, fn in sources.items()}
        return snap

    def reset(self) -> None:
        """Clear counters, gauges and histograms; registered sources stay
        (they describe live objects, not accumulated state)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def format(self) -> str:
        snap = self.snapshot(include_sources=False)
        lines = []
        for name in sorted(snap["counters"]):
            lines.append(f"  {name:<24} {snap['counters'][name]}")
        for name in sorted(snap["gauges"]):
            lines.append(f"  {name:<24} {snap['gauges'][name]}")
        for stage in sorted(snap["latency"]):
            s = snap["latency"][stage]
            lines.append(
                f"  {stage:<24} n={s['count']:<7} mean={s['mean_ms']:.3f}ms "
                f"p50={s['p50_ms']:.3f}ms p95={s['p95_ms']:.3f}ms "
                f"p99={s['p99_ms']:.3f}ms"
            )
        return "\n".join(lines)
