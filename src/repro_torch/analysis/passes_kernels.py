"""Kernel-contract passes of the port's analysis suite: the CUDA launch
sites and the device layout.

The counterpart of ``repro.analysis.passes_kernels``. The reference's
Pallas rules (grid divisibility, index-map closures, VMEM estimates) read
``pl.pallas_call`` sites, which the port does not have; in their place
two rules check the ``ctypes`` launch sites, where a wrong operand reads
out of bounds on the card. Two rules carry over, on the
:mod:`~repro_torch.analysis.shapeflow` interpreter:

* ``launch-contract`` — a function that calls a ``*_launch`` symbol of a
  loaded library must carry ``@kernel_contract``
  (:mod:`repro_torch.kernels.contracts`), so the armed witness sees every
  launch's operands and shared memory.
* ``launch-rc`` — the launch's return code must be bound to a name and
  tested in the same function, with a raise on nonzero: a bare call
  statement (or a code used any other way) drops a CUDA error.
* ``int32-narrowing`` — a cast to int32 (``.to(torch.int32)``, ``.int()``,
  ``dtype=torch.int32`` of a value constructor, ``np.int32(...)``,
  ``.astype(np.int32)``) whose operand carries a product of non-constant
  extents (``k_index * n + u``) or is int64-typed is a silent wrap at
  scale — unless it flows through a *checked caster* (a function that
  raises an ``*Overflow*`` error, like ``batch_query._i32``).
* ``layout-contract`` — every dict literal that builds the device layout
  (three or more keys of ``LAYOUT_CONTRACTS``: ``_host_layout`` and
  ``_host_layout_stratified``) must build exactly the declared arrays,
  each provably int32 (checked caster, int32 constructor, or an
  int32-typed name).
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..kernels.contracts import LAYOUT_CONTRACTS
from . import shapeflow as sf
from .core import (AnalysisConfig, Finding, Module, dotted_name,
                   make_finding)

_NARROW_FUNCS = frozenset({"np.int32", "numpy.int32"})
#: value constructors whose ``dtype=`` narrows their first argument
_VALUE_CTORS = frozenset({"np.asarray", "numpy.asarray", "np.array",
                          "numpy.array", "torch.tensor", "torch.as_tensor",
                          "torch.asarray", "torch.arange"})


# ---------------------------------------------------------------------------
# rules: launch-contract, launch-rc
# ---------------------------------------------------------------------------

def _is_launch(node: ast.AST) -> bool:
    """A call of a loaded library's ``*_launch`` symbol
    (``lib.x_launch(...)``, ``_library()[0].x_launch(...)``)."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr.endswith("_launch"))


def _has_contract(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        if (dotted_name(target) or "").rsplit(".", 1)[-1] \
                == "kernel_contract":
            return True
    return False


def _own_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Nodes of ``fn``'s body, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _rc_checked(fn: ast.AST, name: str) -> bool:
    """An ``if`` in ``fn`` whose test reads ``name`` and whose body
    raises."""
    for node in _own_nodes(fn):
        if not isinstance(node, ast.If):
            continue
        reads = any(isinstance(s, ast.Name) and s.id == name
                    for s in ast.walk(node.test))
        if reads and any(isinstance(s, ast.Raise)
                         for stmt in node.body for s in ast.walk(stmt)):
            return True
    return False


def _check_launches(module: Module, fn: ast.AST, symbol: str,
                    contracted: bool, findings: list[Finding]) -> None:
    launches = [n for n in _own_nodes(fn) if _is_launch(n)]
    if not launches:
        return
    if not contracted:
        findings.append(make_finding(
            module, "launch-contract", fn,
            f"{fn.name}() launches {launches[0].func.attr} without "
            "@kernel_contract: declare its operands and shared memory so "
            "the armed witness checks every launch", symbol=symbol))
    bound: dict[int, str] = {}
    for node in _own_nodes(fn):
        if (isinstance(node, ast.Assign) and _is_launch(node.value)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            bound[id(node.value)] = node.targets[0].id
    for call in launches:
        name = bound.get(id(call))
        if name is None:
            findings.append(make_finding(
                module, "launch-rc", call,
                f"the return code of {call.func.attr} is not bound: bind "
                "it (rc = ...) and raise when it is nonzero",
                symbol=symbol))
        elif not _rc_checked(fn, name):
            findings.append(make_finding(
                module, "launch-rc", call,
                f"{name}, the return code of {call.func.attr}, is never "
                f"tested with a raise: add `if {name}: raise ...`",
                symbol=symbol))


# ---------------------------------------------------------------------------
# rule: int32-narrowing
# ---------------------------------------------------------------------------

def _is_narrowing_cast(node: ast.Call) -> ast.AST | None:
    """The operand being narrowed to int32, or None."""
    d = dotted_name(node.func)
    if d in _NARROW_FUNCS and node.args:
        return node.args[0]
    if d in _VALUE_CTORS and node.args:
        dtype = None
        for arg in node.args[1:]:
            dtype = sf.dtype_name(arg) or dtype
        for kwarg in node.keywords:
            if kwarg.arg == "dtype":
                dtype = sf.dtype_name(kwarg.value)
        return node.args[0] if dtype == "int32" else None
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    if attr == "int" and not node.args:
        return node.func.value
    if attr in ("astype", "to") and (
            any(sf.dtype_name(a) == "int32" for a in node.args)
            or any(kw.arg == "dtype" and sf.dtype_name(kw.value) == "int32"
                   for kw in node.keywords)):
        return node.func.value
    return None


def _contains_narrowing(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.Call)
               and _is_narrowing_cast(sub) is not None
               for sub in ast.walk(node))


def _raises_overflow(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Raise) and node.exc is not None:
            exc = node.exc
            if isinstance(exc, ast.Call):
                exc = exc.func
            name = (dotted_name(exc) or "").rsplit(".", 1)[-1]
            if "Overflow" in name:
                return True
    return False


def _collect_casters(tree: ast.Module) -> dict[str, bool]:
    """Module-local narrowing casters: ``name -> guarded`` (guarded =
    the body raises an ``*Overflow*`` error before narrowing). Covers
    ``def _i32(...)``, ``i32 = lambda a: a.to(torch.int32)`` and aliases
    ``i32 = _i32``."""
    casters: dict[str, bool] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and _contains_narrowing(node):
            casters[node.name] = _raises_overflow(node)
    for _ in range(2):  # aliases may precede or follow the definition
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            tname = node.targets[0].id
            if isinstance(node.value, ast.Lambda) \
                    and _contains_narrowing(node.value):
                casters[tname] = _raises_overflow(node.value)
            elif (isinstance(node.value, ast.Name)
                  and node.value.id in casters):
                casters[tname] = casters[node.value.id]
    return casters


def _is_risky(env: sf.Env, operand: ast.AST) -> str | None:
    """Why a narrowed operand may overflow int32, or None if clean."""
    if sf.int_expr_has_product(operand):
        return ("carries a product of non-constant extents "
                "(the k_index*n + u / K*n+1 packed-offset shape)")
    if env.dtype_of(operand) == "int64":
        return "is int64-typed"
    return None


def _check_narrowing(module: Module, casters: dict[str, bool],
                     fn: ast.AST, env: sf.Env, symbol: str,
                     findings: list[Finding]) -> None:
    if _raises_overflow(fn):
        return  # the checked caster's own implementation
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        operand = _is_narrowing_cast(node)
        if operand is None and isinstance(node.func, ast.Name):
            caster = node.func.id
            if caster in casters and node.args:
                if casters[caster]:
                    continue  # guarded caster call — the fix pattern
                operand = node.args[0]
        if operand is None:
            continue
        why = _is_risky(env, operand)
        if why is not None:
            findings.append(make_finding(
                module, "int32-narrowing", node,
                f"int32 narrowing of an operand that {why}: silent "
                "wrap at scale — widen to int64, or route through a "
                "checked caster that raises a typed *Overflow* error",
                symbol=symbol))


# ---------------------------------------------------------------------------
# rule: layout-contract
# ---------------------------------------------------------------------------

def _value_int32_ok(env: sf.Env, node: ast.AST,
                    casters: dict[str, bool]) -> bool:
    if isinstance(node, ast.IfExp):
        return (_value_int32_ok(env, node.body, casters)
                and _value_int32_ok(env, node.orelse, casters))
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in casters):
        return casters[node.func.id]
    return env.dtype_of(node) == "int32"


def _check_layout_dicts(module: Module, fn: ast.AST, env: sf.Env,
                        casters: dict[str, bool], symbol: str,
                        findings: list[Finding]) -> None:
    table = LAYOUT_CONTRACTS
    for node in _own_nodes(fn):
        if not isinstance(node, ast.Dict):
            continue
        keys = [k.value for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)]
        if len([k for k in keys if k in table]) < 3:
            continue  # not a device-layout construction site
        for key_node, val in zip(node.keys, node.values):
            if not (isinstance(key_node, ast.Constant)
                    and isinstance(key_node.value, str)):
                continue
            key = key_node.value
            if key not in table:
                findings.append(make_finding(
                    module, "layout-contract", key_node,
                    f"layout array {key!r} is not declared in "
                    "kernels.contracts.LAYOUT_CONTRACTS — declare its "
                    "dtype+rank or rename it", symbol=symbol))
                continue
            if not _value_int32_ok(env, val, casters):
                findings.append(make_finding(
                    module, "layout-contract", val,
                    f"layout value for {key!r} is not provably "
                    f"{table[key][0]}: construct with an int32 dtype or "
                    "route through a checked caster", symbol=symbol))
        missing = sorted(set(table) - set(keys))
        if missing:
            findings.append(make_finding(
                module, "layout-contract", node,
                f"declared layout arrays absent from this construction "
                f"site: {', '.join(missing)} — every contract array "
                "must be built (padded if empty)", symbol=symbol))


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def _functions(tree: ast.Module):
    """``(qualified name, def, contracted)`` for every function, nested
    ones included; ``contracted`` when it or an enclosing def carries
    ``@kernel_contract``."""
    def walk(node, prefix, contracted):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{child.name}"
                c = contracted or _has_contract(child)
                yield name, child, c
                yield from walk(child, f"{name}.", c)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", contracted)
            else:
                yield from walk(child, prefix, contracted)
    yield from walk(tree, "", False)


def pass_kernel_contracts(module: Module,
                          config: AnalysisConfig) -> Iterable[Finding]:
    findings: list[Finding] = []
    consts = sf.module_int_consts(module.tree)
    casters = _collect_casters(module.tree)
    for symbol, fn, contracted in _functions(module.tree):
        _check_launches(module, fn, symbol, contracted, findings)
        env = sf.function_env(fn, consts)
        _check_narrowing(module, casters, fn, env, symbol, findings)
        _check_layout_dicts(module, fn, env, casters, symbol, findings)
    return findings
