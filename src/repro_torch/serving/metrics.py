"""Per-stage serving metrics (DESIGN.md §7.5, §11.4). PyTorch port of
``repro.serving.metrics``.

The engine is instrumented at every pipeline stage: queue wait inside the
micro-batcher, planner routing, host/device execution, end-to-end request
latency. Latencies go into :class:`repro_torch.obs.LatencyHistogram` (exact
samples up to a cap, then uniform reservoir replacement) and are
summarized as p50/p95/p99/mean with linear interpolation; everything
countable (cache hits, routed queries, padded slots, flushes by cause,
kernel builds, propagation rounds) goes into monotonically increasing counters.

:class:`EngineMetrics` is a thin subclass of
:class:`repro_torch.obs.MetricsRegistry` — the unified registry that also
carries gauges and pluggable stat sources (the result cache's and index
registry's ``stats()``), so one ``snapshot()`` (and one
``repro_torch.obs.export.metrics_to_json``) covers the whole serving
plane.

All methods are thread-safe: the batcher worker threads, the caller
threads resolving cache hits, and the stats reader all touch the same
object — and the histograms carry their own lock, so direct
``LatencyHistogram.add`` calls are safe too.
"""

from __future__ import annotations

from repro_torch.obs.registry import LatencyHistogram, MetricsRegistry

__all__ = ["EngineMetrics", "LatencyHistogram"]


class EngineMetrics(MetricsRegistry):
    """The serving engine's metrics sink: a :class:`MetricsRegistry` kept
    under its historical name so engine/batcher/planner/registry call
    sites (and tests) read naturally."""
