"""Query-lifecycle spans with cross-thread context propagation
(DESIGN.md §11.1-§11.3). PyTorch port of ``repro.obs.trace`` (stdlib only).

A :class:`Span` is one timed operation (a query's end-to-end life, its wait
in the batcher queue, one device launch, one background index refresh).
Spans form trees: every span carries ``(trace_id, span_id, parent_id)``,
where ``trace_id`` is the root's span id, so a whole tree can be recovered
from a flat buffer. Two propagation rules (§11.2):

* **Within a thread** — entering a span as a context manager makes it the
  thread-local *current* span; spans started without an explicit parent
  nest under it.
* **Across threads** — context never propagates implicitly (a batcher
  worker serves interleaved requests from many callers; thread identity
  means nothing). The *producer* captures ``span.ctx`` and hands it over
  explicitly: the engine attaches the open root span to each
  :class:`~repro_torch.serving.batcher.Request`, and epoch mutations pass the
  ingest/retain span's context into the registry so the FIFO refresh
  worker parents its refresh spans correctly.

Finished spans are recorded into the :class:`Tracer`'s bounded,
lock-protected ring buffer (oldest dropped first, ``dropped`` counted —
tracing must never grow without bound under sustained load). Open spans
are not resident anywhere except with their owner, so an abandoned span
costs nothing. A disabled tracer hands out the :data:`NULL_SPAN`
singleton, making every instrumentation site a few attribute lookups.

The :class:`SlowQueryLog` hangs off the root-span finish path: a completed
query whose duration crosses the threshold captures its full span tree
(scanned from the ring buffer by trace id) plus the canonical query spec.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

from .locks import named_lock


class SpanContext(NamedTuple):
    """The portable identity of a span: what crosses a thread boundary."""

    trace_id: str
    span_id: str


#: Process-wide span-id source. ``next()`` on ``itertools.count`` is atomic
#: under the GIL, so ids are unique across every tracer and thread.
_IDS = itertools.count(1)


def _next_id() -> str:
    return format(next(_IDS), "x")


#: Sentinel: "use the thread-local current span" (vs None = explicit root).
_IMPLICIT = object()


class Span:
    """One timed operation. Created by :meth:`Tracer.start_span`; recorded
    into the tracer's ring buffer on :meth:`end` (idempotent)."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "t_start", "t_end", "tid", "thread_name", "attrs",
                 "_tracer", "_ended")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: str, span_id: str, parent_id: str | None,
                 t_start: float, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.t_end: float | None = None
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name
        self.attrs = attrs
        self._ended = False

    # -- identity --------------------------------------------------------
    @property
    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def ids(self) -> tuple[str | None, str | None]:
        """(trace_id, span_id) — the pair stamped into ``Provenance``."""
        return self.trace_id, self.span_id

    @property
    def duration_s(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return max(0.0, end - self.t_start)

    # -- mutation --------------------------------------------------------
    def set(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def child(self, name: str, *, cat: str | None = None,
              t0: float | None = None, **attrs) -> "Span":
        """Start a child span (explicit parent = self; never thread-local)."""
        return self._tracer.start_span(name, parent=self,
                                       cat=cat or self.cat, t0=t0, **attrs)

    def end(self, t: float | None = None) -> None:
        if self._ended:
            return
        self._ended = True
        self.t_end = t if t is not None else time.perf_counter()
        if self.t_end < self.t_start:      # retrospective spans clamp
            self.t_end = self.t_start
        self._tracer._record(self)

    # -- context-manager use (thread-local current) ----------------------
    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._tracer._pop(self)
        if exc is not None:
            self.attrs["error"] = repr(exc)
        self.end()

    def to_dict(self) -> dict:
        return {
            "name": self.name, "cat": self.cat,
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start": self.t_start, "t_end": self.t_end,
            "duration_ms": self.duration_s * 1e3,
            "tid": self.tid, "thread": self.thread_name,
            "attrs": dict(self.attrs),
        }

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, parent={self.parent_id}, "
                f"dur={self.duration_s*1e3:.3f}ms)")


class _NullSpan:
    """The do-nothing span a disabled tracer hands out. ``ctx``/``ids``
    are None-shaped so instrumentation sites never branch on enablement."""

    __slots__ = ()
    ctx = None
    ids = (None, None)
    name = cat = trace_id = span_id = parent_id = None
    attrs: dict = {}
    duration_s = 0.0

    def set(self, key, value):
        return self

    def child(self, name, **kw):
        return self

    def end(self, t=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def to_dict(self) -> dict:
        return {}


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + bounded ring buffer of finished spans.

    Thread-safe throughout: span *starts* touch only thread-local state
    (and an atomic id counter); span *ends* append to the ring under one
    lock. ``capacity`` bounds resident memory; overflow drops the oldest
    span and increments ``dropped`` — the export is a window, never a
    leak. ``enabled=False`` short-circuits every start to
    :data:`NULL_SPAN` (the off-switch costs one attribute check).
    """

    def __init__(self, capacity: int = 16384, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._lock = named_lock("tracer")
        self._spans: deque[Span] = deque()
        self.dropped = 0
        self._local = threading.local()
        #: perf_counter origin: Chrome export timestamps are relative to it
        self.t0 = time.perf_counter()

    # -- thread-local current span ---------------------------------------
    def current(self) -> Span | None:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def _push(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()

    # -- span lifecycle ---------------------------------------------------
    def start_span(self, name: str, *, parent=_IMPLICIT, cat: str = "serving",
                   t0: float | None = None, **attrs):
        """Start a span.

        ``parent`` is a :class:`Span`, a :class:`SpanContext`, ``None``
        (an explicit root — cross-thread producers must *choose*), or
        omitted (nest under the thread-local current span, if any).
        ``t0`` backdates the start (retrospective queue-wait spans).
        """
        if not self.enabled:
            return NULL_SPAN
        if parent is _IMPLICIT:
            parent = self.current()
        if parent is None or parent is NULL_SPAN:
            span_id = _next_id()
            return Span(self, name, cat, span_id, span_id, None,
                        t0 if t0 is not None else time.perf_counter(), attrs)
        if isinstance(parent, Span):
            parent = parent.ctx
        return Span(self, name, cat, parent.trace_id, _next_id(),
                    parent.span_id,
                    t0 if t0 is not None else time.perf_counter(), attrs)

    def span(self, name: str, **kw):
        """``with tracer.span("stage"): ...`` convenience — same arguments
        as :meth:`start_span`; the context manager pushes/pops the
        thread-local current span and ends it on exit."""
        return self.start_span(name, **kw)

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._spans.popleft()
                self.dropped += 1
            self._spans.append(span)

    # -- reading ----------------------------------------------------------
    def spans(self, name: str | None = None,
              trace_id: str | None = None) -> list[Span]:
        """Snapshot of finished spans, oldest first, optionally filtered."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def trace_tree(self, trace_id: str) -> list[dict]:
        """Every finished span of one trace as dicts (slow-query capture).
        The ring may have dropped early spans of an old trace — the
        capture is best-effort by design, bounded either way."""
        return [s.to_dict() for s in self.spans(trace_id=trace_id)]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "capacity": self.capacity,
                    "spans": len(self._spans), "dropped": self.dropped}


class SlowQueryLog:
    """Bounded log of queries whose end-to-end span crossed a latency
    threshold (DESIGN.md §11.5).

    ``threshold_ms=None`` disables the log entirely (the default: the
    engine always constructs one, the config decides whether it bites).
    Each entry captures the root span, the *full span tree* re-scanned
    from the tracer's ring buffer, and the canonical query spec — enough
    to answer "where did this one slow query spend its time" without
    replaying anything.
    """

    def __init__(self, threshold_ms: float | None = None,
                 tracer: Tracer | None = None, cap: int = 256):
        self.threshold_ms = threshold_ms
        self.tracer = tracer
        self.cap = cap
        self._lock = named_lock("slowlog")
        self._entries: deque[dict] = deque(maxlen=cap)
        self.observed = 0

    @property
    def enabled(self) -> bool:
        return self.threshold_ms is not None

    def observe(self, root_span, query=None) -> bool:
        """Called as a root query span finishes; returns True if logged."""
        if self.threshold_ms is None or root_span is NULL_SPAN:
            return False
        dur_ms = root_span.duration_s * 1e3
        if dur_ms < self.threshold_ms:
            return False
        entry = {
            "trace_id": root_span.trace_id,
            "span_id": root_span.span_id,
            "duration_ms": dur_ms,
            "query": repr(query) if query is not None else None,
            "attrs": dict(root_span.attrs),
            "spans": (self.tracer.trace_tree(root_span.trace_id)
                      if self.tracer is not None else []),
        }
        with self._lock:
            self._entries.append(entry)
            self.observed += 1
        return True

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def format(self) -> str:
        """Human-readable report: one block per slow query, children
        indented under the root with per-span durations."""
        lines = []
        for e in self.entries():
            lines.append(f"slow query {e['duration_ms']:.3f}ms "
                         f"trace={e['trace_id']} {e['query'] or ''}")
            by_parent: dict = {}
            for s in e["spans"]:
                by_parent.setdefault(s["parent_id"], []).append(s)

            def walk(parent_id, depth):
                for s in by_parent.get(parent_id, []):
                    lines.append(f"  {'  ' * depth}{s['name']:<12} "
                                 f"{s['duration_ms']:9.3f}ms  "
                                 f"[{s['thread']}]")
                    walk(s["span_id"], depth + 1)

            walk(None, 0)
        return "\n".join(lines) if lines else "(no slow queries)"
