"""Lock-discipline passes of the port's analysis suite.

PyTorch port of ``repro.analysis.passes_locks``, checked against the
port's own hierarchy (:data:`repro_torch.obs.locks.LOCK_HIERARCHY`, equal
to the reference's). Two rules:

* ``lock-order`` — a ``with``-acquisition of a lock whose hierarchy rank is
  not strictly greater than every lock already held on the static hold
  stack, and calls (while holding a lock) to methods of receivers that are
  *known* to acquire a lock (the ``lock-receivers`` config map: e.g.
  ``_metrics`` methods take the ``metrics`` lock) whose rank does not
  increase.
* ``lock-blocking-call`` — a call matching the blocking-operation table
  (device synchronisation and device-to-host copies, ``Future.result``,
  cold index builds, sleeps, file I/O) made while any lock is held.
  Holding a serving-plane lock across a device round-trip or a disk write
  stalls every thread that needs the lock for the full device/disk
  latency.

Lock identity is read straight from the factory calls the subsystems use:
``self._lock = named_lock("registry")`` binds the attribute ``_lock`` (in
that class) to hierarchy level ``"registry"``. Plain ``threading.Lock()``
attributes are treated as level ``None`` — unrankable, so nesting them
under a named lock is itself a finding (``lock-order``: undeclared).

Static limits (the runtime witness of :mod:`repro_torch.obs.locks` covers
these): acquisitions through callbacks/listeners, locks passed across
objects, and ``acquire()`` / ``release()`` call pairs.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..obs.locks import LOCK_HIERARCHY

from .core import (AnalysisConfig, Finding, Module, dotted_name,
                   iter_symbols, make_finding)

_RANKS = {name: i for i, name in enumerate(LOCK_HIERARCHY)}

#: attribute-call suffixes that block: (attr name, human label)
_BLOCKING_ATTRS = {
    "block_until_ready": "device synchronization",
    "synchronize": "device synchronization",
    "item": "device->host scalar sync",
    "cpu": "device->host copy",
    "result": "Future.result (blocks on async work)",
    "sleep": "sleep",
    "fsync": "disk flush",
}

#: names whose *call* blocks regardless of receiver
_BLOCKING_NAMES = {
    "open": "file I/O",
}

#: dotted calls that block (module alias resolved textually)
_BLOCKING_DOTTED = {
    "torch.cuda.synchronize": "device synchronization",
    "time.sleep": "sleep",
    "os.fsync": "disk flush",
}

#: receiver-method calls that perform a cold index build (config may extend)
_BUILD_METHODS = {"_build_index", "build_index", "_run_build"}

_LOCK_FACTORIES = {"named_lock", "named_condition"}


def _self_attr(node: ast.AST) -> str | None:
    """``self.<attr>`` -> ``attr``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _collect_lock_attrs(module: Module) -> dict[str, str]:
    """Map ``self.<attr>`` lock attributes to hierarchy level names by
    finding ``self.<attr> = named_lock("<level>")`` assignments (and the
    condition variant) anywhere in the module."""
    out: dict[str, str] = {}
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Assign):
            continue
        call = node.value
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, (ast.Name, ast.Attribute))):
            continue
        fname = (call.func.id if isinstance(call.func, ast.Name)
                 else call.func.attr)
        if fname not in _LOCK_FACTORIES:
            continue
        if not (call.args and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            continue
        level = call.args[0].value
        for tgt in node.targets:
            attr = _self_attr(tgt)
            if attr is not None:
                out[attr] = level
    return out


def _with_lock_level(item: ast.withitem,
                     lock_attrs: dict[str, str]) -> str | None | bool:
    """Classify a ``with`` item: a level name if it acquires a known named
    lock, ``None`` if it acquires an *unnamed* ``self``-attribute that
    looks like a lock/condition, ``False`` if it is not a lock at all."""
    ctx = item.context_expr
    attr = _self_attr(ctx)
    if attr is None:
        return False
    if attr in lock_attrs:
        return lock_attrs[attr]
    if "lock" in attr.lower() or "cond" in attr.lower():
        return None
    return False


def _blocking_reason(call: ast.Call, config: AnalysisConfig) -> str | None:
    dotted = dotted_name(call.func)
    if dotted is not None and dotted in _BLOCKING_DOTTED:
        return _BLOCKING_DOTTED[dotted]
    if isinstance(call.func, ast.Name):
        return _BLOCKING_NAMES.get(call.func.id)
    if isinstance(call.func, ast.Attribute):
        name = call.func.attr
        if name in _BUILD_METHODS:
            return "cold index build"
        if name in _BLOCKING_ATTRS:
            # `.result(...)` / `.block_until_ready(...)` etc. —
            # receiver-agnostic: the point is that *something* waits
            # while the lock is held
            return _BLOCKING_ATTRS[name]
        if name == "join":
            # str.join is ubiquitous; only thread-shaped receivers count
            recv = dotted_name(call.func.value) or ""
            if "thread" in recv.lower() or "worker" in recv.lower():
                return "thread join"
    return None


def _receiver_lock_level(call: ast.Call,
                         config: AnalysisConfig) -> tuple[str, str] | None:
    """``self._metrics.count(...)`` -> ("metrics", "_metrics.count") if the
    ``lock-receivers`` config maps ``_metrics`` to a level."""
    if not isinstance(call.func, ast.Attribute):
        return None
    recv = _self_attr(call.func.value)
    if recv is None:
        return None
    level = config.lock_receivers.get(recv)
    if level is None:
        return None
    return level, f"{recv}.{call.func.attr}"


class _FunctionLockWalker(ast.NodeVisitor):
    """Walk one function body tracking the ``with``-lock hold stack.

    Nested function/lambda bodies are *not* analyzed under the outer hold
    stack: they run when called, not where defined (the runtime witness
    catches callbacks that do run under a lock).
    """

    def __init__(self, module: Module, config: AnalysisConfig,
                 lock_attrs: dict[str, str], symbol: str,
                 findings: list[Finding]):
        self.module = module
        self.config = config
        self.lock_attrs = lock_attrs
        self.symbol = symbol
        self.findings = findings
        self.stack: list[tuple[str | None, ast.withitem]] = []

    # -- nested defs are separate scopes ---------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    # -- with blocks -----------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        acquired = 0
        for item in node.items:
            level = _with_lock_level(item, self.lock_attrs)
            if level is False:
                # not a lock — but `with open(...)` under a held lock is
                # still a blocking call: walk the context expression
                self.visit(item.context_expr)
                continue
            self._check_acquire(level, item.context_expr)
            self.stack.append((level, item))
            acquired += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(acquired):
            self.stack.pop()

    def _check_acquire(self, level: str | None, node: ast.AST) -> None:
        if not self.stack:
            if level is not None and level not in _RANKS:
                self.findings.append(make_finding(
                    self.module, "lock-order", node,
                    f"lock level {level!r} is not in the declared "
                    f"hierarchy {list(LOCK_HIERARCHY)}",
                    symbol=self.symbol))
            return
        outer_level = self.stack[-1][0]
        if level is None:
            self.findings.append(make_finding(
                self.module, "lock-order", node,
                "acquired an unnamed lock while holding "
                f"{outer_level!r}; every lock nested under a hierarchy "
                "lock must itself be a named_lock/named_condition",
                symbol=self.symbol))
            return
        ri = _RANKS.get(level)
        ro = _RANKS.get(outer_level) if outer_level is not None else None
        if ri is None:
            self.findings.append(make_finding(
                self.module, "lock-order", node,
                f"lock level {level!r} is not in the declared hierarchy",
                symbol=self.symbol))
        elif ro is not None and ri <= ro:
            self.findings.append(make_finding(
                self.module, "lock-order", node,
                f"acquired {level!r} (rank {ri}) while holding "
                f"{outer_level!r} (rank {ro}); the declared hierarchy "
                "requires strictly increasing rank "
                f"({' < '.join(LOCK_HIERARCHY)})",
                symbol=self.symbol))

    # -- calls under a held lock -----------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        if self.stack:
            held = self.stack[-1][0]
            reason = _blocking_reason(node, self.config)
            if reason is not None:
                self.findings.append(make_finding(
                    self.module, "lock-blocking-call", node,
                    f"{reason} while holding lock "
                    f"{held if held is not None else '<unnamed>'!r}; "
                    "move the blocking work outside the critical section",
                    symbol=self.symbol))
            recv = _receiver_lock_level(node, self.config)
            if recv is not None:
                level, label = recv
                ri = _RANKS.get(level)
                ro = _RANKS.get(held) if held is not None else None
                if ri is not None and ro is not None and ri <= ro:
                    self.findings.append(make_finding(
                        self.module, "lock-order", node,
                        f"call {label}() acquires {level!r} (rank {ri}) "
                        f"while holding {held!r} (rank {ro}); the "
                        "declared hierarchy requires strictly increasing "
                        "rank", symbol=self.symbol))
        self.generic_visit(node)


def pass_lock_discipline(module: Module,
                         config: AnalysisConfig) -> Iterable[Finding]:
    """``lock-order`` + ``lock-blocking-call`` over one module."""
    lock_attrs = _collect_lock_attrs(module)
    findings: list[Finding] = []
    for symbol, node in iter_symbols(module.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        walker = _FunctionLockWalker(module, config, lock_attrs,
                                     symbol=symbol, findings=findings)
        for stmt in node.body:
            walker.visit(stmt)
    return findings
