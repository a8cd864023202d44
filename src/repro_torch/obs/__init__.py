"""Serving-plane observability (DESIGN.md §11): query-lifecycle tracing,
unified metrics, and export surfaces. PyTorch port of ``repro.obs``:
stdlib only, copied so the port stands alone.

Three modules, deliberately dependency-free (stdlib + numpy only) so every
layer — core, serving, launch, benchmarks — can import them without cycles:

* :mod:`repro_torch.obs.trace` — spans with explicit parent/child context that
  propagate across thread boundaries (submit -> batcher worker -> device
  launch; ingest -> FIFO refresh worker), recorded into a bounded
  lock-protected ring buffer, plus the slow-query log.
* :mod:`repro_torch.obs.registry` — :class:`MetricsRegistry`: counters, gauges,
  latency histograms and pluggable stat *sources* (cache/registry stats)
  behind one snapshot-and-export surface. The serving engine's
  ``EngineMetrics`` is a thin subclass.
* :mod:`repro_torch.obs.export` — Chrome trace-event JSON (loadable in Perfetto /
  ``chrome://tracing``) with a schema validator, and the metrics snapshot
  JSON round-trip.
* :mod:`repro_torch.obs.locks` — the declared lock hierarchy, ``named_lock`` /
  ``named_condition`` factories every subsystem uses, and the runtime
  :class:`LockWitness` that records acquisition edges during tests and
  cross-checks them against the hierarchy (DESIGN.md §12.2).
"""

from .locks import (LOCK_HIERARCHY, WITNESS, LockWitness, named_condition,
                    named_lock, witness_enabled)
from .trace import (NULL_SPAN, SlowQueryLog, Span, SpanContext, Tracer)
from .registry import LatencyHistogram, MetricsRegistry
from .export import (chrome_trace_events, metrics_from_json,
                     metrics_to_json, validate_chrome_trace,
                     write_chrome_trace)

__all__ = [
    "Tracer", "Span", "SpanContext", "SlowQueryLog", "NULL_SPAN",
    "MetricsRegistry", "LatencyHistogram",
    "LOCK_HIERARCHY", "LockWitness", "WITNESS",
    "named_lock", "named_condition", "witness_enabled",
    "chrome_trace_events", "write_chrome_trace", "validate_chrome_trace",
    "metrics_to_json", "metrics_from_json",
]
