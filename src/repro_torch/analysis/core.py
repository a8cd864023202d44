"""Framework core of the port's static-analysis suite.

PyTorch port of ``repro.analysis.core``, copied (stdlib only) so the port
stands alone. The moving parts:

* :class:`Finding` — one rule violation at one source location, carrying a
  stable :attr:`~Finding.fingerprint` so a baseline survives unrelated
  edits (the fingerprint hashes the rule, the file, the enclosing symbol
  and the *text* of the offending line — not its line number).
* :class:`Module` — a parsed source file: AST, raw lines, and the per-line
  suppression table built from ``# repro: ignore[rule]`` comments (same
  line or the line directly above both suppress).
* :class:`Baseline` — the committed ledger of accepted findings. ``--strict``
  fails on any finding whose fingerprint is not in it; re-generating with
  ``--write-baseline`` is an explicit, reviewed act.
* :class:`AnalysisConfig` — one source of truth shared by the CLI and the
  tests, loaded from the port's own TOML file
  (``src/repro_torch/analysis/analysis.toml``: pass selection, include
  roots, hot-path module list, baseline path).
* :func:`run_analysis` — parse every included file once, hand each
  :class:`Module` to every registered pass, drop suppressed findings,
  sort what remains.

A *pass* is any callable ``(module, config) -> Iterable[Finding]``
registered in ``repro_torch.analysis.PASSES``.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
import tomllib
from typing import Callable, Iterable, Iterator

#: ``# repro: ignore`` (all rules) or ``# repro: ignore[rule-a, rule-b]``.
SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*ignore(?:\[([A-Za-z0-9_,\- ]+)\])?")

#: the port's configuration, relative to the repo root
DEFAULT_CONFIG = "src/repro_torch/analysis/analysis.toml"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str          # e.g. "lock-order"
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    symbol: str        # enclosing "Class.method" / "function" / "<module>"
    message: str
    fingerprint: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.symbol}] {self.message}")


def _fingerprint(rule: str, path: str, symbol: str, line_text: str,
                 occurrence: int) -> str:
    """Stable identity for baselining: independent of line *numbers* so a
    baseline survives edits elsewhere in the file; ``occurrence``
    disambiguates textually identical violations of one rule in one
    symbol."""
    key = "|".join((rule, path, symbol, line_text.strip(), str(occurrence)))
    return hashlib.sha1(key.encode()).hexdigest()[:16]


class Module:
    """A parsed source file plus its suppression table."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line (1-based) -> None (suppress all) | frozenset of rule names
        self.suppressions: dict[int, frozenset[str] | None] = {}
        for i, text in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(text)
            if m is None:
                continue
            rules = m.group(1)
            if rules is None:
                self.suppressions[i] = None          # suppress every rule
            else:
                self.suppressions[i] = frozenset(
                    r.strip() for r in rules.split(",") if r.strip())

    @property
    def dotted(self) -> str:
        """``src/repro_torch/serving/engine.py`` ->
        ``repro_torch.serving.engine``."""
        rel = self.rel
        if rel.startswith("src/"):
            rel = rel[4:]
        return rel[:-3].replace("/", ".") if rel.endswith(".py") else rel

    def suppressed(self, line: int, rule: str) -> bool:
        """True if ``rule`` is suppressed at ``line`` — by a marker on the
        same line or on the line directly above."""
        for at in (line, line - 1):
            if at in self.suppressions:
                rules = self.suppressions[at]
                if rules is None or rule in rules:
                    return True
        return False


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` -> ``"a.b.c"`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_symbols(tree: ast.Module) -> Iterator[tuple[str, ast.AST]]:
    """Yield ``(qualified_name, node)`` for every function/method, plus
    ``("<module>", tree)`` first. Nested defs get ``outer.inner`` names."""
    yield "<module>", tree

    def walk(node: ast.AST, prefix: str) -> Iterator[tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{child.name}"
                yield name, child
                yield from walk(child, f"{name}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)

    yield from walk(tree, "")


def enclosing_symbol(module: Module, target: ast.AST) -> str:
    """Qualified name of the innermost function/class containing ``target``
    (by position), or ``<module>``."""
    best = "<module>"
    best_span = None
    t_line = getattr(target, "lineno", 0)
    for name, node in iter_symbols(module.tree):
        if node is module.tree:
            continue
        lo = node.lineno
        hi = getattr(node, "end_lineno", lo)
        if lo <= t_line <= hi:
            span = hi - lo
            if best_span is None or span <= best_span:
                best, best_span = name, span
    return best


def make_finding(module: Module, rule: str, node: ast.AST, message: str,
                 symbol: str | None = None) -> Finding:
    line = getattr(node, "lineno", 1)
    col = getattr(node, "col_offset", 0)
    sym = symbol if symbol is not None else enclosing_symbol(module, node)
    return Finding(rule=rule, path=module.rel, line=line, col=col,
                   symbol=sym, message=message)


class Baseline:
    """Committed ledger of accepted findings (JSON).

    Schema: ``{"findings": [{"fingerprint", "rule", "path", "symbol",
    "comment"}]}`` — ``comment`` is the human justification."""

    def __init__(self, entries: list[dict] | None = None):
        self.entries = entries or []
        self._by_fp = {e["fingerprint"]: e for e in self.entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([])
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("findings", []))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"findings": self.entries}, f, indent=2,
                      sort_keys=True)
            f.write("\n")

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._by_fp

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      comment: str = "") -> "Baseline":
        entries = [{"fingerprint": f.fingerprint, "rule": f.rule,
                    "path": f.path, "symbol": f.symbol,
                    "comment": comment} for f in findings]
        return cls(entries)


#: TOML key -> (field, converter); every other key of the file is an error
_KEYS = {
    "include": ("include", tuple),
    "exclude": ("exclude", tuple),
    "passes": ("passes", tuple),
    "baseline": ("baseline", str),
    "hot-path-modules": ("hot_path_modules", tuple),
    "wallclock-modules": ("wallclock_modules", tuple),
    "lock-receivers": ("lock_receivers", dict),
    "deprecated-calls": ("deprecated_calls",
                         lambda t: {k: int(v) for k, v in t.items()}),
    "assert-exempt": ("assert_exempt", tuple),
}


@dataclasses.dataclass
class AnalysisConfig:
    """The port's analysis settings — one source of truth for the CLI and
    the tests."""

    include: tuple[str, ...] = ("src/repro_torch",)
    exclude: tuple[str, ...] = ()
    passes: tuple[str, ...] = ()           # empty = all registered
    baseline: str = "src/repro_torch/analysis/baseline.json"
    #: dotted module prefixes where host<->device transfers are findings
    hot_path_modules: tuple[str, ...] = ()
    #: dotted module prefixes where ``time.time()`` is a finding (the
    #: tracer's perf_counter clock is the law there)
    wallclock_modules: tuple[str, ...] = ()
    #: receiver attribute name -> lock level it acquires when its locking
    #: methods are called (cross-object nesting the AST cannot infer)
    lock_receivers: dict = dataclasses.field(default_factory=dict)
    #: deprecated shim methods: name -> minimum positional-arg count that
    #: identifies the legacy signature at a call site
    deprecated_calls: dict = dataclasses.field(default_factory=dict)
    #: path prefixes where ``bare-assert`` does not fire (test fixture
    #: helpers — not shipped library code)
    assert_exempt: tuple[str, ...] = ()
    #: CLI ``--changed-only``: restrict analysis to these repo-relative
    #: paths. Never read from the file — strict runs always cover the tree.
    only_files: frozenset | None = None

    @classmethod
    def from_toml(cls, path: str) -> "AnalysisConfig":
        """Settings from a TOML file of top-level keys (``include``,
        ``hot-path-modules``, the ``[lock-receivers]`` table, ...); a
        missing file gives the defaults, an unknown key raises."""
        if not os.path.exists(path):
            return cls()
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        unknown = sorted(set(raw) - set(_KEYS))
        if unknown:
            raise ValueError(f"{path}: unknown keys {unknown}")
        return cls(**{_KEYS[k][0]: _KEYS[k][1](v) for k, v in raw.items()})


Pass = Callable[[Module, AnalysisConfig], Iterable[Finding]]


def collect_files(root: str, config: AnalysisConfig) -> list[str]:
    out: list[str] = []
    for inc in config.include:
        base = os.path.join(root, inc)
        if os.path.isfile(base):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__",)]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                if any(rel.startswith(ex) for ex in config.exclude):
                    continue
                if (config.only_files is not None
                        and rel not in config.only_files):
                    continue
                out.append(full)
    return sorted(set(out))


def run_analysis(root: str, config: AnalysisConfig,
                 passes: dict[str, Pass]) -> list[Finding]:
    """Parse every included file once, run every selected pass, drop
    suppressed findings, fingerprint and sort the survivors."""
    selected = {name: fn for name, fn in passes.items()
                if not config.passes or name in config.passes}
    findings: list[Finding] = []
    for path in collect_files(root, config):
        rel = os.path.relpath(path, root)
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            module = Module(path, rel, source)
        except SyntaxError as e:
            findings.append(Finding(
                rule="syntax-error", path=rel.replace(os.sep, "/"),
                line=e.lineno or 1, col=e.offset or 0,
                symbol="<module>", message=str(e.msg)))
            continue
        for fn in selected.values():
            for f in fn(module, config):
                if not module.suppressed(f.line, f.rule):
                    findings.append(f)

    # fingerprints: occurrence counter over (rule, path, symbol, stripped
    # line text) so identical violations stay distinct but stable
    by_file: dict[str, list[str]] = {}
    counts: dict[tuple, int] = {}
    out: list[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        if f.path not in by_file:
            full = os.path.join(root, f.path)
            try:
                with open(full, encoding="utf-8") as fh:
                    by_file[f.path] = fh.read().splitlines()
            except OSError:
                by_file[f.path] = []
        lines = by_file[f.path]
        text = lines[f.line - 1] if 1 <= f.line <= len(lines) else ""
        key = (f.rule, f.path, f.symbol, text.strip())
        n = counts.get(key, 0)
        counts[key] = n + 1
        out.append(dataclasses.replace(
            f, fingerprint=_fingerprint(f.rule, f.path, f.symbol, text, n)))
    return out
