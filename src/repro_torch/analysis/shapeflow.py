"""Shape-flow abstract interpretation for the port's kernel passes.

The part of ``repro.analysis.shapeflow`` that the two carried-over rules
(``int32-narrowing`` and ``layout-contract``) read, with its dtype
inference taught PyTorch: ``torch.int32``/``torch.long``, ``.int()``,
``.long()``, ``.to(dtype)``, ``dtype=`` of the tensor constructors. The
Pallas parts (grid divisibility, index-map closures, VMEM estimates) have
no counterpart on the card and are not ported.

* :class:`Lin` — an integer expression as a **linear combination of
  monomials** over opaque atoms. ``int(np.ceil(max(e, 1) / b)) * b``
  becomes ``{(ceil((max(e,1))/(b)), b): 1}``; ``npad = ceil(N/bn)*bn - N;
  Np = N + npad`` normalizes to ``{(ceil..., bn): 1}`` because the ``N``
  terms cancel.
* :class:`Env` — per-function bindings built by walking assignments in
  source order: symbolic integer values (:class:`Lin`), inferred array
  dtypes (``torch.zeros(n, dtype=torch.int32)`` -> int32,
  ``x.long()`` -> int64), and the raw value AST per name. Reassigned
  names get fresh atoms keyed by line — two reads after the same binding
  stay equal, reads across a rebinding do not.
* :func:`int_expr_has_product` — the ``k_index * n + u`` overflow shape.

The interpreter is *sound for proving, unsound for refuting*: anything it
cannot resolve is an opaque atom or an unknown dtype, and the passes
decide whether that is a finding.
"""

from __future__ import annotations

import ast
import dataclasses

from .core import dotted_name

#: dtype-name -> itemsize
DTYPE_BYTES = {
    "int8": 1, "uint8": 1, "bool": 1, "bool_": 1,
    "int16": 2, "uint16": 2, "float16": 2, "bfloat16": 2,
    "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8,
}

#: torch's short dtype aliases (``torch.long`` is ``torch.int64``)
TORCH_ALIASES = {"int": "int32", "long": "int64", "short": "int16",
                 "half": "float16", "float": "float32",
                 "double": "float64"}

#: tensor methods that cast to a fixed dtype: ``x.int()`` -> int32
_CAST_METHODS = {"int": "int32", "long": "int64", "short": "int16",
                 "bool": "bool", "half": "float16", "float": "float32",
                 "double": "float64", "bfloat16": "bfloat16"}


def dtype_name(node: ast.AST) -> str | None:
    """``torch.int32`` / ``torch.long`` / ``np.int32`` / ``"int32"`` ->
    canonical name."""
    if isinstance(node, ast.Attribute):
        if node.attr in DTYPE_BYTES:
            return node.attr
        if dotted_name(node.value) == "torch" and node.attr in TORCH_ALIASES:
            return TORCH_ALIASES[node.attr]
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in DTYPE_BYTES else None
    if isinstance(node, ast.Name) and node.id in DTYPE_BYTES:
        return node.id
    return None


# ---------------------------------------------------------------------------
# symbolic integers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Lin:
    """Linear combination of monomials: ``terms`` maps a sorted tuple of
    atom strings (the monomial; ``()`` is the constant term) to an int
    coefficient. Atoms are canonical source strings of opaque
    subexpressions (``ceil((N)/(bn))``, ``labels.shape[1]``, ...)."""

    terms: tuple[tuple[tuple[str, ...], int], ...]

    @classmethod
    def of(cls, mapping: dict[tuple[str, ...], int]) -> "Lin":
        items = tuple(sorted((m, c) for m, c in mapping.items() if c != 0))
        return cls(items)

    @classmethod
    def const(cls, c: int) -> "Lin":
        return cls.of({(): c})

    @classmethod
    def atom(cls, key: str) -> "Lin":
        return cls.of({(key,): 1})

    def mapping(self) -> dict[tuple[str, ...], int]:
        return dict(self.terms)

    def __add__(self, other: "Lin") -> "Lin":
        out = self.mapping()
        for m, c in other.terms:
            out[m] = out.get(m, 0) + c
        return Lin.of(out)

    def __sub__(self, other: "Lin") -> "Lin":
        out = self.mapping()
        for m, c in other.terms:
            out[m] = out.get(m, 0) - c
        return Lin.of(out)

    def __mul__(self, other: "Lin") -> "Lin":
        out: dict[tuple[str, ...], int] = {}
        for m1, c1 in self.terms:
            for m2, c2 in other.terms:
                m = tuple(sorted(m1 + m2))
                out[m] = out.get(m, 0) + c1 * c2
        return Lin.of(out)

    def as_const(self) -> int | None:
        if not self.terms:
            return 0
        if len(self.terms) == 1 and self.terms[0][0] == ():
            return self.terms[0][1]
        return None

    def key(self) -> str:
        """Canonical string (used when this value becomes an atom inside a
        bigger opaque expression, e.g. the body of a ceil)."""
        c = self.as_const()
        if c is not None:
            return str(c)
        parts = []
        for m, coef in self.terms:
            mono = "*".join(m) if m else "1"
            parts.append(f"{coef}*{mono}" if coef != 1 or not m else mono)
        return "+".join(parts)


def divides(num: Lin | None, den: Lin | None) -> bool:
    """True iff ``num`` is provably an integer multiple of ``den`` for
    every valuation of the atoms (``den`` a single monomial); unknown
    values never divide."""
    if num is None or den is None:
        return False
    dc = den.as_const()
    if dc is not None:
        if dc == 0:
            return False
        return all(c % dc == 0 for _, c in num.terms)
    if len(den.terms) != 1:
        return False
    dmono, dcoef = den.terms[0]
    for mono, coef in num.terms:
        remaining = list(mono)
        for a in dmono:
            if a not in remaining:
                return False
            remaining.remove(a)
        if coef % dcoef:
            return False
    return True


# ---------------------------------------------------------------------------
# the per-function environment
# ---------------------------------------------------------------------------

_CTORS = ("np.zeros", "np.ones", "np.empty", "np.full", "np.asarray",
          "np.array", "numpy.zeros", "numpy.ones", "numpy.empty",
          "numpy.full", "numpy.asarray", "numpy.array",
          "torch.zeros", "torch.ones", "torch.empty", "torch.full",
          "torch.arange", "torch.tensor", "torch.as_tensor",
          "torch.asarray", "torch.zeros_like", "torch.ones_like",
          "torch.empty_like", "torch.full_like")
_DTYPE_PRESERVING = ("np.pad", "np.ascontiguousarray", "np.concatenate",
                     "np.repeat", "np.where", "np.diff", "torch.cat",
                     "torch.where", "torch.nn.functional.pad")
_CUMSUMS = ("np.cumsum", "numpy.cumsum", "torch.cumsum")
_INT_DTYPES = frozenset({"bool", "int8", "int16", "int32", "int64",
                         "uint8", "uint16", "uint32", "uint64"})
#: methods that keep the receiver's dtype
_PRESERVING_METHODS = ("contiguous", "clone", "flatten", "reshape", "view",
                       "clamp", "clamp_", "t", "cuda", "cpu")


class Env:
    """Bindings built from one function's body (plus module constants):
    ``ints`` (name -> :class:`Lin`), ``dtypes`` (name -> dtype name for
    arrays and tensors) and ``value_ast`` (name -> last assigned value
    node)."""

    def __init__(self, module_consts: dict[str, int] | None = None):
        self.ints: dict[str, Lin] = {}
        self.dtypes: dict[str, str] = {}
        self.value_ast: dict[str, ast.AST] = {}
        if module_consts:
            for name, val in module_consts.items():
                self.ints[name] = Lin.const(val)

    # -- symbolic integer evaluation -------------------------------------
    def lin(self, node: ast.AST) -> Lin | None:
        """Abstract-evaluate an int expression; None for non-int shapes.
        Unknown subexpressions become atoms."""
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool) or not isinstance(node.value,
                                                              int):
                return None
            return Lin.const(node.value)
        if isinstance(node, ast.Name):
            if node.id in self.ints:
                return self.ints[node.id]
            return Lin.atom(node.id)
        if isinstance(node, ast.BinOp):
            left, right = self.lin(node.left), self.lin(node.right)
            if left is None or right is None:
                return Lin.atom(self._key(node))
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.FloorDiv):
                if divides(left, right):
                    return self._exact_quotient(left, right)
                return Lin.atom(f"({left.key()})//({right.key()})")
            return Lin.atom(self._key(node))
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d == "int" and len(node.args) == 1:
                return self.lin(node.args[0])
            if d in ("np.ceil", "numpy.ceil", "math.ceil") and node.args:
                arg = node.args[0]
                if (isinstance(arg, ast.BinOp)
                        and isinstance(arg.op, ast.Div)):
                    lk = self._key(arg.left)
                    rk = self._key(arg.right)
                    return Lin.atom(f"ceil(({lk})/({rk}))")
                return Lin.atom(f"ceil({self._key(arg)})")
            return Lin.atom(self._key(node))
        return Lin.atom(self._key(node))

    def _exact_quotient(self, num: Lin, den: Lin) -> Lin:
        dc = den.as_const()
        if dc is not None:
            return Lin.of({m: c // dc for m, c in num.terms})
        dmono, dcoef = den.terms[0]
        out: dict[tuple[str, ...], int] = {}
        for mono, coef in num.terms:
            remaining = list(mono)
            for a in dmono:
                remaining.remove(a)
            m = tuple(sorted(remaining))
            out[m] = out.get(m, 0) + coef // dcoef
        return Lin.of(out)

    def _key(self, node: ast.AST) -> str:
        """Canonical atom key: resolve names through current bindings so
        two reads of the same binding agree, then unparse."""
        if isinstance(node, ast.Name) and node.id in self.ints:
            return self.ints[node.id].key()
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div)):
            op = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*",
                  ast.Div: "/"}[type(node.op)]
            return f"({self._key(node.left)}){op}({self._key(node.right)})"
        return ast.unparse(node)

    # -- dtype inference --------------------------------------------------
    def dtype_of(self, node: ast.AST) -> str | None:
        """Best-effort dtype of an array or tensor expression; None when
        unknown."""
        if isinstance(node, ast.Name):
            return self.dtypes.get(node.id)
        if isinstance(node, ast.IfExp):
            a = self.dtype_of(node.body)
            b = self.dtype_of(node.orelse)
            return a if a == b else None
        if isinstance(node, ast.Subscript):
            return self.dtype_of(node.value)
        if not isinstance(node, ast.Call):
            return None
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _CAST_METHODS and not node.args:
                return _CAST_METHODS[attr]
            if attr in ("astype", "to"):
                # x.astype(np.int32), x.to(torch.int32), x.to(dev, dtype),
                # x.to(dtype=torch.long); x.to(dev) keeps the dtype
                for arg in node.args:
                    dn = dtype_name(arg)
                    if dn is not None:
                        return dn
                for kw in node.keywords:
                    if kw.arg == "dtype":
                        return dtype_name(kw.value)
                if attr == "to":
                    return self.dtype_of(node.func.value)
                return None
            if attr in _PRESERVING_METHODS:
                return self.dtype_of(node.func.value)
        d = dotted_name(node.func)
        if d in _CTORS:
            for kw in node.keywords:
                if kw.arg == "dtype":
                    return dtype_name(kw.value)
            # positional dtype: last arg of the numpy zeros/full forms
            for arg in node.args[1:]:
                dn = dtype_name(arg)
                if dn is not None:
                    return dn
            if d.endswith("_like") and node.args:
                return self.dtype_of(node.args[0])
            return None
        if d in _CUMSUMS and node.args:
            # integer sums accumulate in int64 (numpy and torch alike)
            for kw in node.keywords:
                if kw.arg == "dtype":
                    return dtype_name(kw.value)
            dt = self.dtype_of(node.args[0])
            return "int64" if dt in _INT_DTYPES else dt
        if d in _DTYPE_PRESERVING and node.args:
            first = node.args[0]
            if isinstance(first, (ast.List, ast.Tuple)) and first.elts:
                first = first.elts[0]
            return self.dtype_of(first)
        return None

    # -- construction -----------------------------------------------------
    def _bind(self, name: str, value: ast.AST, lineno: int) -> None:
        self.value_ast[name] = value
        lin = self.lin(value)
        self.ints[name] = (lin if lin is not None
                           else Lin.atom(f"{name}@{lineno}"))
        dt = self.dtype_of(value)
        if dt is not None:
            self.dtypes[name] = dt
        else:
            self.dtypes.pop(name, None)

    def bind_assign(self, stmt: ast.AST) -> None:
        targets: list[ast.AST] = []
        value: ast.AST | None = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            return
        line = getattr(stmt, "lineno", 0)
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                self._bind(tgt.id, value, line)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                if (isinstance(value, (ast.Tuple, ast.List))
                        and len(value.elts) == len(tgt.elts)):
                    # a, b = (x, y): element-wise, each side keeps its
                    # arithmetic meaning and its dtype
                    for el, val in zip(tgt.elts, value.elts):
                        if isinstance(el, ast.Name):
                            self._bind(el.id, val, line)
                    continue
                # B, N = labels.shape — each name gets a fresh atom
                for i, el in enumerate(tgt.elts):
                    if isinstance(el, ast.Name):
                        self.ints[el.id] = Lin.atom(f"{el.id}@{line}.{i}")
                        self.value_ast.pop(el.id, None)
                        self.dtypes.pop(el.id, None)


def module_int_consts(tree: ast.Module) -> dict[str, int]:
    """Module-level ``NAME = <int literal>`` constants."""
    out: dict[str, int] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt = stmt.targets[0]
            if (isinstance(tgt, ast.Name)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, int)
                    and not isinstance(stmt.value.value, bool)):
                out[tgt.id] = stmt.value.value
    return out


def function_env(fn: ast.FunctionDef,
                 module_consts: dict[str, int]) -> Env:
    """Environment after abstractly executing ``fn``'s assignments in
    source order (branch-local assignments included — last writer wins;
    every binding is a fresh atom unless provably arithmetic)."""
    env = Env(module_consts)
    args = fn.args
    pos = args.posonlyargs + args.args
    for param, default in zip(pos[len(pos) - len(args.defaults):],
                              args.defaults):
        lin = env.lin(default)
        if lin is not None and lin.as_const() is not None:
            env.ints[param.arg] = lin
    for param, default in zip(args.kwonlyargs, args.kw_defaults):
        if default is not None:
            lin = env.lin(default)
            if lin is not None and lin.as_const() is not None:
                env.ints[param.arg] = lin
    for stmt in ast.walk(fn):
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            env.bind_assign(stmt)
    return env


def int_expr_has_product(node: ast.AST) -> bool:
    """True when the expression contains a ``*`` of two non-constant
    operands — the ``k_index * n + u`` / ``K * n + 1`` overflow shape.
    Sequence repetition (``[u] * w``, ``(x,) * n``) is not arithmetic
    and never overflows an element."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mult):
            if isinstance(sub.left, (ast.List, ast.Tuple)) \
                    or isinstance(sub.right, (ast.List, ast.Tuple)):
                continue
            lc = isinstance(sub.left, ast.Constant)
            rc = isinstance(sub.right, ast.Constant)
            if not lc and not rc:
                return True
    return False
