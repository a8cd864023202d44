"""API-discipline passes of the port's analysis suite.

PyTorch port of ``repro.analysis.passes_api``: the same five rules, which
read no JAX construct.

* ``deprecated-shim`` — calls into the legacy positional surfaces
  (``index.query(u, ts, te)``, ``engine.submit(workload, k, u, ts, te)``,
  ``engine.submit_many(...)``): the ``TCCSQuery`` surface validates,
  canonicalizes and records provenance; the shims skip all three. The
  ``deprecated-calls`` config maps method name -> the *minimum positional
  arity* that identifies the legacy signature (so ``batcher.submit(req)``
  and ``executor.submit``-style two-arg calls stay clean).
* ``metrics-direct`` — writes to counter state (``._counters[...] = ...``)
  outside the owning class: every counter mutation must flow through
  ``MetricsRegistry.count`` so the unified snapshot, export and reset
  surfaces stay truthful.
* ``wallclock-in-traced`` — ``time.time()`` in modules on the
  ``wallclock-modules`` list (the serving + obs planes): span timing and
  latency math there use ``time.perf_counter()``.
* ``bare-assert`` — ``assert`` statements in library code: they vanish
  under ``python -O``, so invariants guarding data integrity must raise
  typed errors.
* ``per-k-key`` — code constructing the per-k ``(workload, k)``
  registry/store keys: a two-element tuple passed to a key-taking method,
  a positional k after the workload on ``get``-family / ``warmup`` /
  ``prefetch``, or a tuple membership test against a registry. The k axis
  lives *inside* the handle (``handle.supported_ks``). Receiver-restricted
  to registry / store / engine-looking names so result-cache keys
  (``(index_key, spec_key)`` tuples) stay clean.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .core import (AnalysisConfig, Finding, Module, dotted_name,
                   make_finding)

#: attribute names that are counter state on metrics-ish objects
_COUNTER_ATTRS = frozenset({"_counters", "_gauges"})

#: key-taking methods of the index plane (registry / disk tier / engine)
_PERK_KEY_METHODS = frozenset({"get", "get_nowait", "get_async", "load",
                               "put_handle", "current_epoch", "delete"})
#: methods where a *positional* second argument is the deprecated k
_PERK_POSITIONAL_METHODS = frozenset({"get", "get_nowait", "get_async",
                                      "warmup", "prefetch"})
#: receiver-name tails that look like the index plane; anything else
#: (caches keyed by (index_key, spec_key) tuples, dicts, ...) stays clean
_PERK_RECEIVER_TAILS = ("registry", "reg", "store", "engine", "eng")


def pass_api_discipline(module: Module,
                        config: AnalysisConfig) -> Iterable[Finding]:
    findings: list[Finding] = []
    wallclock = any(module.dotted == m or module.dotted.startswith(m + ".")
                    for m in config.wallclock_modules)
    # bench floor-asserts and test fixture helpers keep their asserts:
    # they never run under python -O in a context that matters
    assert_exempt = any(module.rel.startswith(p)
                        for p in config.assert_exempt)

    for node in ast.walk(module.tree):
        # -- deprecated-shim ---------------------------------------------
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            name = node.func.attr
            min_arity = config.deprecated_calls.get(name)
            if (min_arity is not None and len(node.args) >= min_arity
                    and not _first_arg_is_callable_ref(node)
                    and not _receiver_is_executor(node)):
                findings.append(make_finding(
                    module, "deprecated-shim", node,
                    f".{name}() with {len(node.args)} positional args "
                    "matches a legacy positional shim signature; migrate "
                    "to the TCCSQuery surface (answer/submit_spec)"))

        # -- per-k-key ---------------------------------------------------
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and _receiver_is_index_plane(node)):
            name = node.func.attr
            if (name in _PERK_KEY_METHODS and node.args
                    and isinstance(node.args[0], ast.Tuple)
                    and len(node.args[0].elts) == 2):
                findings.append(make_finding(
                    module, "per-k-key", node,
                    f".{name}() with a (workload, k) tuple key: the "
                    "registry/store key space is workload-only since the "
                    "k-stratified index plane — pass the workload name "
                    "and pick k per query (handle.supported_ks)"))
            elif (name in _PERK_POSITIONAL_METHODS
                  and len(node.args) >= 2
                  and _looks_like_k(node.args[1])):
                findings.append(make_finding(
                    module, "per-k-key", node,
                    f".{name}(workload, k) passes a per-k positional "
                    "key: one k-stratified build serves every k — drop "
                    "the k (it is deprecated and ignored)"))
        if (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.In, ast.NotIn))
                and isinstance(node.left, ast.Tuple)
                and len(node.left.elts) == 2
                and _name_is_index_plane(node.comparators[0])):
            findings.append(make_finding(
                module, "per-k-key", node,
                "(workload, k) membership test against a registry: "
                "residency is keyed by workload alone — test the name "
                "and check handle.supported_ks for the k"))

        # -- metrics-direct ----------------------------------------------
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                base = tgt
                if isinstance(base, ast.Subscript):
                    base = base.value
                if (isinstance(base, ast.Attribute)
                        and base.attr in _COUNTER_ATTRS
                        and not _is_self_write_in_owner(module, base)):
                    findings.append(make_finding(
                        module, "metrics-direct", node,
                        f"direct write to {base.attr!r} bypasses "
                        "MetricsRegistry.count/gauge; counters mutated "
                        "behind the registry's back disappear from "
                        "snapshots and reset()"))

        # -- wallclock-in-traced -----------------------------------------
        if (wallclock and isinstance(node, ast.Call)
                and dotted_name(node.func) == "time.time"):
            findings.append(make_finding(
                module, "wallclock-in-traced", node,
                "time.time() in a span-instrumented module; durations "
                "and deadlines here use time.perf_counter() — wall "
                "clock steps (NTP) corrupt latency math"))

        # -- bare-assert --------------------------------------------------
        if isinstance(node, ast.Assert) and not assert_exempt:
            findings.append(make_finding(
                module, "bare-assert", node,
                "assert in library code vanishes under python -O; "
                "raise a typed error for data-integrity invariants"))
    return findings


def _first_arg_is_callable_ref(call: ast.Call) -> bool:
    """``pool.submit(self._run_build, key, ...)`` is ThreadPoolExecutor's
    submit, not the engine shim: its first positional arg is a function
    reference (attribute chain or lambda), where the shim takes a workload
    string/name."""
    if not call.args:
        return False
    first = call.args[0]
    return isinstance(first, (ast.Attribute, ast.Lambda))


def _receiver_is_executor(call: ast.Call) -> bool:
    """``pool.submit(...)`` / ``self._build_pool.submit(...)``: receivers
    named like thread pools are concurrent.futures executors, never the
    engine shim."""
    recv = dotted_name(call.func.value) or ""  # type: ignore[union-attr]
    tail = recv.rsplit(".", 1)[-1].lower()
    return "pool" in tail or "executor" in tail


def _receiver_is_index_plane(call: ast.Call) -> bool:
    """``registry.get(...)`` / ``self._store.load(...)`` / ``eng.warmup``:
    the per-k-key rule only fires on receivers whose final name component
    looks like the index plane, so tuple keys of other key spaces (the
    result cache's ``(index_key, spec_key)``) stay clean."""
    recv = dotted_name(call.func.value) or ""  # type: ignore[union-attr]
    tail = recv.rsplit(".", 1)[-1].lower().lstrip("_")
    return any(tail == t or tail.endswith("_" + t) or tail.startswith(t)
               for t in _PERK_RECEIVER_TAILS)


def _name_is_index_plane(node: ast.AST) -> bool:
    recv = dotted_name(node) or ""
    tail = recv.rsplit(".", 1)[-1].lower().lstrip("_")
    return any(tail == t or tail.endswith("_" + t) or tail.startswith(t)
               for t in _PERK_RECEIVER_TAILS)


def _looks_like_k(node: ast.AST) -> bool:
    """An integer literal or a variable literally named ``k``/``k_``-ish
    in the second positional slot — the deprecated per-k argument. Other
    second positionals (timeouts as floats, option flags) stay clean."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and not isinstance(node.value,
                                                              bool)
    return isinstance(node, ast.Name) and (
        node.id == "k" or node.id.startswith("k_") or node.id.endswith("_k"))


def _is_self_write_in_owner(module: Module, attr: ast.Attribute) -> bool:
    """``self._counters[...]`` writes inside the class that owns the
    counter dict are the implementation, not a bypass."""
    return (isinstance(attr.value, ast.Name) and attr.value.id == "self")
