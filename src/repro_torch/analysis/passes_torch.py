"""PyTorch-discipline passes of the port's analysis suite.

The counterpart of ``repro.analysis.passes_jax``. PyTorch runs eagerly:
there is no tracer whose abstract values a Python branch, a closure or an
assert could confuse, so the reference's jit rules (``jit-python-branch``,
``jit-mutable-closure``, ``jit-unhashable-static``, ``jit-assert``,
``jit-host-sync``) have nothing to check here. What carries over is the
hot path's transfer discipline, and two rules encode the port's own hard
constraint (a kernel that cannot run raises; nothing falls back):

* ``hot-path-transfer`` — a device-to-host read or a device
  synchronisation (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``.to("cpu")``, ``torch.cuda.synchronize()``) in a module on the
  configured hot-path list (executor/planner/batch_query): every one
  there is either a deliberate, measured sync point (suppress it inline
  with a reason) or a latency bug. The rule reads calls, not types: a
  ``.tolist()`` of a host array is flagged too, and suppressed so.
* ``silent-fallback`` — a ``try`` whose body builds a kernel library
  (``*_library()``, ``build*()``) or calls a ``*_launch`` symbol, with a
  handler that neither raises, re-raises nor hands the caught exception
  on (``fut.set_exception(exc)``), or that calls a plain version
  (``ref.*``): a failed build or launch must surface, not be answered by
  the plain PyTorch version.
* ``cpu-fallback`` — a branch on ``torch.cuda.is_available()`` that
  assigns, returns or passes a CPU device: an entry point runs on the
  card unless its caller asks for the CPU.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .core import (AnalysisConfig, Finding, Module, dotted_name,
                   make_finding)

_TRANSFER_ATTRS = {"item", "cpu", "tolist", "numpy"}
_SYNC_DOTTED = {"torch.cuda.synchronize"}


def _is_cpu_device(node: ast.AST) -> bool:
    """``"cpu"``, ``"cpu:0"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value == "cpu" or node.value.startswith("cpu:")
    if (isinstance(node, ast.Call)
            and dotted_name(node.func) in ("torch.device", "device")
            and node.args):
        return _is_cpu_device(node.args[0])
    return False


def _transfer_label(node: ast.Call) -> str | None:
    """What device-to-host read or sync ``node`` is, or None."""
    d = dotted_name(node.func)
    if d in _SYNC_DOTTED:
        return f"{d}()"
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    if attr in _TRANSFER_ATTRS:
        return f".{attr}()"
    if attr == "to" and (any(_is_cpu_device(a) for a in node.args)
                         or any(kw.arg == "device"
                                and _is_cpu_device(kw.value)
                                for kw in node.keywords)):
        return '.to("cpu")'
    return None


def _call_name(node: ast.Call) -> str:
    """The last component of a call's target: ``lib.x_launch`` ->
    ``x_launch``, ``_library()[0].y_launch`` -> ``y_launch``."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _builds_or_launches(node: ast.Call) -> bool:
    name = _call_name(node)
    return (name.endswith("_library") or name.endswith("_launch")
            or name.lstrip("_").startswith("build"))


def _walk_body(stmts: list[ast.stmt]) -> Iterable[ast.AST]:
    for stmt in stmts:
        yield from ast.walk(stmt)


def _forwards(handler: ast.ExceptHandler, subs: list[ast.AST]) -> bool:
    """The handler hands the caught exception itself on (``fut.set_
    exception(exc)``): the failure reaches whoever waits on it."""
    return handler.name is not None and any(
        isinstance(s, ast.Call) and any(
            isinstance(a, ast.Name) and a.id == handler.name
            for a in s.args)
        for s in subs)


def _check_try(module: Module, node: ast.Try,
               findings: list[Finding]) -> None:
    if not any(isinstance(sub, ast.Call) and _builds_or_launches(sub)
               for sub in _walk_body(node.body)):
        return
    for handler in node.handlers:
        subs = list(_walk_body(handler.body))
        plain = [s for s in subs if isinstance(s, ast.Call)
                 and (dotted_name(s.func) or "").startswith("ref.")]
        if plain:
            findings.append(make_finding(
                module, "silent-fallback", handler,
                f"handler answers a failed build or launch with the plain "
                f"version {dotted_name(plain[0].func)}(): a kernel that "
                "cannot run must raise, not fall back"))
        elif not any(isinstance(s, ast.Raise) for s in subs) \
                and not _forwards(handler, subs):
            findings.append(make_finding(
                module, "silent-fallback", handler,
                "handler swallows a failed build or launch: re-raise, "
                "raise a typed error naming the kernel, or hand the "
                "exception on"))


def _mentions_is_available(test: ast.AST) -> bool:
    return any(isinstance(sub, ast.Call)
               and (dotted_name(sub.func) or "").endswith(
                   "cuda.is_available")
               for sub in ast.walk(test))


def _cpu_device_uses(stmts_or_expr) -> Iterable[ast.AST]:
    """CPU devices assigned, returned or passed in a branch."""
    nodes = (stmts_or_expr if isinstance(stmts_or_expr, list)
             else [stmts_or_expr])
    for top in nodes:
        for sub in ast.walk(top):
            values: list[ast.AST] = []
            if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.Return)):
                if sub.value is not None:
                    values = [sub.value]
            elif (isinstance(sub, ast.Call)
                  and dotted_name(sub.func) not in ("torch.device",
                                                    "device")):
                values = list(sub.args) + [kw.value for kw in sub.keywords]
            elif isinstance(sub, ast.expr) and sub is top:
                values = [sub]
            for v in values:
                if _is_cpu_device(v):
                    yield v


def _check_cpu_fallback(module: Module, node: ast.AST,
                        findings: list[Finding]) -> None:
    if not _mentions_is_available(node.test):
        return
    for branch in (node.body, node.orelse):
        for use in _cpu_device_uses(branch):
            findings.append(make_finding(
                module, "cpu-fallback", use,
                "branch on torch.cuda.is_available() picks a CPU device: "
                "entry points run on the card unless the caller passes "
                "device='cpu', and raise without one"))


def pass_torch_discipline(module: Module,
                          config: AnalysisConfig) -> Iterable[Finding]:
    """``hot-path-transfer``, ``silent-fallback`` and ``cpu-fallback``
    over one module."""
    findings: list[Finding] = []
    hot = any(module.dotted == m or module.dotted.startswith(m + ".")
              for m in config.hot_path_modules)
    for node in ast.walk(module.tree):
        if hot and isinstance(node, ast.Call):
            label = _transfer_label(node)
            if label is not None:
                findings.append(make_finding(
                    module, "hot-path-transfer", node,
                    f"{label} in hot-path module {module.dotted}: every "
                    "device-to-host read or sync here is either a "
                    "deliberate measured sync point (suppress inline with "
                    "a reason) or a latency bug"))
        if isinstance(node, ast.Try):
            _check_try(module, node, findings)
        if isinstance(node, (ast.If, ast.IfExp)):
            _check_cpu_fallback(module, node, findings)
    return findings
