"""Export surfaces: Chrome trace-event JSON and the metrics snapshot
round-trip (DESIGN.md §11.6). PyTorch port of ``repro.obs.export``
(stdlib only).

The trace export emits the Trace Event Format's JSON-object form —
``{"traceEvents": [...]}`` with complete (``"ph": "X"``) duration events —
which loads directly into Perfetto or ``chrome://tracing``. Parent/child
structure is carried twice: implicitly by same-thread nesting (how the
viewers render stacks) and explicitly in each event's ``args``
(``trace_id``/``span_id``/``parent_id``), so the span tree survives
cross-thread hops that the viewers' per-track stacking cannot express.

:func:`validate_chrome_trace` is the schema gate the test suite and the
engine's ``export_trace`` run over every exported file: shape, required fields,
types, and non-negative timestamps.
"""

from __future__ import annotations

import json
from typing import Iterable

#: Chrome trace-event phases this exporter emits (complete, metadata).
_EMITTED_PHASES = ("X", "M")
#: Phases accepted by the validator (a superset: instant/counter events
#: may be merged in from other tools).
_VALID_PHASES = ("X", "M", "i", "I", "C", "B", "E")


def chrome_trace_events(spans: Iterable, t0: float = 0.0,
                        pid: int = 1) -> list[dict]:
    """Flatten finished spans into Chrome trace events.

    ``t0`` is the timestamp origin (the tracer's ``t0``): event ``ts`` are
    microseconds since it. One ``thread_name`` metadata event is emitted
    per distinct thread so the viewer labels tracks."""
    events: list[dict] = []
    threads: dict[int, str] = {}
    for s in spans:
        if s.t_end is None:
            continue
        threads.setdefault(s.tid, s.thread_name)
        args = {"trace_id": s.trace_id, "span_id": s.span_id,
                "parent_id": s.parent_id}
        args.update({k: _jsonable(v) for k, v in s.attrs.items()})
        events.append({
            "name": s.name,
            "cat": s.cat,
            "ph": "X",
            "ts": max(0.0, (s.t_start - t0) * 1e6),
            "dur": max(0.0, (s.t_end - s.t_start) * 1e6),
            "pid": pid,
            "tid": s.tid,
            "args": args,
        })
    for tid, name in threads.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    return events


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return repr(v)


def trace_document(tracer, extra: dict | None = None) -> dict:
    """The JSON-object-format trace document for one tracer."""
    doc = {
        "traceEvents": chrome_trace_events(tracer.spans(), t0=tracer.t0),
        "displayTimeUnit": "ms",
        "otherData": {"dropped_spans": tracer.dropped,
                      **(extra or {})},
    }
    return doc


def write_chrome_trace(path: str, tracer, extra: dict | None = None) -> dict:
    """Write the tracer's ring buffer as Chrome trace JSON; returns the
    document (already validated — an unloadable export is a bug here, not
    in the viewer)."""
    doc = trace_document(tracer, extra)
    validate_chrome_trace(doc)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc) -> int:
    """Validate a trace document against the Chrome trace-event schema
    (JSON-object form). Raises ``ValueError`` on the first violation;
    returns the number of events otherwise."""
    if isinstance(doc, list):            # JSON-array form is also legal
        events = doc
    elif isinstance(doc, dict):
        if "traceEvents" not in doc:
            raise ValueError("trace document missing 'traceEvents'")
        events = doc["traceEvents"]
    else:
        raise ValueError(f"trace document must be dict or list, "
                         f"got {type(doc).__name__}")
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"event {i} missing string 'name'")
        ph = ev.get("ph")
        if ph not in _VALID_PHASES:
            raise ValueError(f"event {i} has invalid phase {ph!r}")
        if not isinstance(ev.get("pid"), int):
            raise ValueError(f"event {i} missing int 'pid'")
        if not isinstance(ev.get("tid"), int):
            raise ValueError(f"event {i} missing int 'tid'")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"event {i} 'ts' must be a number >= 0")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i} 'dur' must be a number >= 0")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i} 'args' must be an object")
    # the whole document must survive a JSON round trip (numpy scalars or
    # other exotic values hiding in args fail here, not in the viewer)
    json.loads(json.dumps(doc if isinstance(doc, dict) else events))
    return len(events)


# ----------------------------------------------------------------------
# Metrics snapshot export
# ----------------------------------------------------------------------

def metrics_to_json(snapshot: dict, indent: int | None = None) -> str:
    """Serialize a :meth:`MetricsRegistry.snapshot` dict. Tuple keys in
    sources (the index registry's ``resident`` list holds ``(workload,
    k)`` tuples as *values*, fine; but e.g. ``epochs`` keys are strings)
    are not expected — a non-string key raises, keeping the export an
    honest round-trip rather than a lossy ``str()`` coercion."""
    return json.dumps(_jsonable_tree(snapshot), indent=indent,
                      allow_nan=False, sort_keys=True)


def metrics_from_json(text: str) -> dict:
    return json.loads(text)


def _jsonable_tree(v):
    if isinstance(v, dict):
        out = {}
        for k, val in v.items():
            if not isinstance(k, str):
                raise ValueError(f"metrics snapshot key {k!r} is not a "
                                 "string; exportable snapshots need "
                                 "string keys")
            out[k] = _jsonable_tree(val)
        return out
    if isinstance(v, (tuple, list)):
        return [_jsonable_tree(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, (int, float, str)):
        return v
    # numpy scalars and friends: collapse to their python value if they
    # quack like one, else repr
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return _jsonable_tree(item())
        except (TypeError, ValueError):
            pass
    return repr(v)
