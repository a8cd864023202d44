"""Tests of the port's static-analysis suite (``repro_torch.analysis``).

Fixture files under ``tests/fixtures/analysis_torch/`` are *parsed*, never
imported: each seeded violation pins its rule and each clean twin pins zero
findings. The port's ``locks`` and ``api`` passes are also run on the
reference's own fixtures (``tests/fixtures/analysis/``) beside the
reference's passes, with the same settings: the findings must agree field
for field.
"""

from __future__ import annotations

import ast
import collections
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro_torch.analysis import (PASSES, AnalysisConfig, Baseline,
                                  run_analysis)
from repro_torch.analysis import shapeflow as sf
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.core import DEFAULT_CONFIG, Module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = "tests/fixtures/analysis_torch"
FIXTURE_PKG = "tests.fixtures.analysis_torch"


def repo_config() -> AnalysisConfig:
    """The port's settings for this repo."""
    return AnalysisConfig.from_toml(os.path.join(REPO, DEFAULT_CONFIG))


def analyze(rel_file: str, passes=None, **overrides) -> list:
    """Run the passes (all, or the named subset) over one fixture file
    with the port's settings, include overridden to just that file."""
    config = repo_config()
    config.include = (f"{FIXTURES}/{rel_file}",)
    config.exclude = ()
    if passes is not None:
        config.passes = tuple(passes)
    for k, v in overrides.items():
        setattr(config, k, v)
    return run_analysis(REPO, config, PASSES)


def by_rule(findings) -> dict:
    return dict(collections.Counter(f.rule for f in findings))


# ---------------------------------------------------------------------------
# each rule: a violations file and a clean twin
# ---------------------------------------------------------------------------

#: fixture pair -> (passes, settings, the violations file's findings by rule)
EXPECTED = {
    "lock": (("locks",), {},
             {"lock-order": 4, "lock-blocking-call": 5}),
    "api": (("api",), {"wallclock_modules": (FIXTURE_PKG,),
                       "assert_exempt": ()},
            {"deprecated-shim": 3, "metrics-direct": 2,
             "wallclock-in-traced": 1, "bare-assert": 1, "per-k-key": 5}),
    "torch": (("torch",), {"hot_path_modules": (FIXTURE_PKG,)},
              {"hot-path-transfer": 7, "silent-fallback": 3,
               "cpu-fallback": 4}),
    "kernel": (("kernels",), {},
               {"launch-contract": 1, "launch-rc": 3, "int32-narrowing": 4,
                "layout-contract": 4}),
}


@pytest.mark.parametrize("family", sorted(EXPECTED))
def test_seeded_violations_all_detected(family):
    passes, settings, want = EXPECTED[family]
    assert by_rule(analyze(f"{family}_violations.py", passes,
                           **settings)) == want


@pytest.mark.parametrize("family", sorted(EXPECTED))
def test_clean_twin_has_zero_findings(family):
    """Every pass, under the family's settings, finds nothing in the clean
    twin."""
    _, settings, _ = EXPECTED[family]
    assert analyze(f"{family}_clean.py", **settings) == []


def test_every_rule_has_a_fixture():
    rules = {r for _, _, want in EXPECTED.values() for r in want}
    assert rules == {
        "lock-order", "lock-blocking-call", "deprecated-shim", "per-k-key",
        "metrics-direct", "wallclock-in-traced", "bare-assert",
        "hot-path-transfer", "silent-fallback", "cpu-fallback",
        "launch-contract", "launch-rc", "int32-narrowing", "layout-contract"}


def test_lock_findings_carry_location_and_symbol():
    fs = analyze("lock_violations.py", ("locks",))
    f = next(f for f in fs if f.rule == "lock-blocking-call"
             and "device synchronization" in f.message)
    assert f.path == f"{FIXTURES}/lock_violations.py"
    assert f.symbol == "BadBlocking.syncs_under_lock"
    assert f.line > 0 and f.fingerprint
    inv = [f for f in fs if f.rule == "lock-order" and "cache" in f.message
           and "metrics" in f.message]
    assert inv and "strictly increasing" in inv[0].message


def test_hot_path_transfer_fires_only_on_listed_modules():
    hot = analyze("torch_violations.py", ("torch",),
                  hot_path_modules=(FIXTURE_PKG,))
    cold = analyze("torch_violations.py", ("torch",))
    assert by_rule(hot)["hot-path-transfer"] == 7
    assert "hot-path-transfer" not in by_rule(cold)


def test_wallclock_rule_scoped_to_module_list():
    assert "wallclock-in-traced" not in by_rule(
        analyze("api_violations.py", ("api",)))


def test_fallback_messages_name_the_plain_version():
    fs = analyze("torch_violations.py", ("torch",))
    plain = [f for f in fs if f.rule == "silent-fallback"
             and "ref.label_prop_round" in f.message]
    assert len(plain) == 1 and plain[0].symbol == "falls_back_to_plain"


# ---------------------------------------------------------------------------
# the port's passes on the reference's fixtures
# ---------------------------------------------------------------------------

def _reference_config(rel: str, **overrides):
    from repro.analysis import AnalysisConfig as RefConfig
    config = RefConfig.from_pyproject(REPO)
    config.include = (rel,)
    config.exclude = ()
    for k, v in overrides.items():
        setattr(config, k, v)
    return config


def _same_settings(ref_config) -> AnalysisConfig:
    """The port's config holding the reference config's settings."""
    return AnalysisConfig(
        include=ref_config.include, exclude=ref_config.exclude,
        passes=ref_config.passes,
        hot_path_modules=ref_config.hot_path_modules,
        wallclock_modules=ref_config.wallclock_modules,
        lock_receivers=dict(ref_config.lock_receivers),
        deprecated_calls=dict(ref_config.deprecated_calls),
        assert_exempt=ref_config.assert_exempt)


def _fields(findings):
    return [(f.rule, f.path, f.line, f.col, f.symbol, f.fingerprint)
            for f in findings]


@pytest.mark.parametrize("name", ["lock_violations.py", "lock_clean.py",
                                  "api_violations.py", "api_clean.py"])
@pytest.mark.parametrize("scoped", [False, True],
                         ids=["repo-settings", "fixture-scoped"])
def test_port_matches_reference_on_reference_fixtures(name, scoped):
    """Locks and api, the two families carried over unchanged: equal
    ``(rule, path, line, col, symbol, fingerprint)`` lists. ``scoped``
    puts the fixture package on the wall-clock list and lifts the assert
    exemption, so every api rule fires."""
    from repro.analysis import PASSES as REF_PASSES
    from repro.analysis import run_analysis as ref_run
    over = ({"wallclock_modules": ("tests.fixtures.analysis",),
             "assert_exempt": ()} if scoped else {})
    ref_config = _reference_config(f"tests/fixtures/analysis/{name}",
                                   passes=("locks", "api"), **over)
    want = ref_run(REPO, ref_config, REF_PASSES)
    got = run_analysis(REPO, _same_settings(ref_config), PASSES)
    assert _fields(got) == _fields(want)
    if "violations" in name:
        assert got


def test_lock_hierarchy_equals_the_reference():
    from repro.obs.locks import LOCK_HIERARCHY as REF
    from repro_torch.obs.locks import LOCK_HIERARCHY
    assert LOCK_HIERARCHY == REF


# ---------------------------------------------------------------------------
# the repo tree: the launch sites, the layout builders, the strict gate
# ---------------------------------------------------------------------------

def _tree(*paths, passes=None) -> list:
    config = repo_config()
    config.include = paths
    if passes is not None:
        config.passes = passes
    return run_analysis(REPO, config, PASSES)


def test_kernel_modules_launch_under_contracts():
    fs = _tree("src/repro_torch/kernels", passes=("kernels",))
    assert not [f for f in fs if f.rule.startswith("launch-")]


def test_batch_query_layout_routed_through_checked_caster():
    fs = _tree("src/repro_torch/core/batch_query.py", passes=("kernels",))
    assert by_rule(fs) == {}


@pytest.mark.parametrize("wrapper", ["label_prop_round", "matmul",
                                     "stratum_sweep"])
def test_dropping_a_contract_is_a_finding(tmp_path, wrapper):
    """A copy of a kernel module with one wrapper's ``@kernel_contract``
    taken off raises ``launch-contract`` on that wrapper alone."""
    module = {"label_prop_round": "label_prop", "matmul": "segment_matmul",
              "stratum_sweep": "segmented_select"}[wrapper]
    src = open(os.path.join(REPO, "src/repro_torch/kernels",
                            f"{module}.py")).read()
    tree = ast.parse(src)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == wrapper)
    dec = fn.decorator_list[0]
    lines = src.splitlines(keepends=True)
    del lines[dec.lineno - 1:dec.end_lineno]     # "@" starts its line
    (tmp_path / "mod.py").write_text("".join(lines))
    config = AnalysisConfig(include=("mod.py",), passes=("kernels",))
    fs = run_analysis(str(tmp_path), config, PASSES)
    assert [(f.rule, f.symbol) for f in fs] == [("launch-contract",
                                                 wrapper)]


def test_layout_contract_sees_a_missing_array(tmp_path):
    """Dropping ``ver_k`` from a copy of ``_host_layout`` is a finding."""
    src = open(os.path.join(REPO, "src/repro_torch/core/batch_query.py")
               ).read()
    cut = src.replace('"ver_k": (np.full(store.num_versions, index.k, '
                      'np.int32)\n                  if has_vers else pad0),',
                      "")
    assert cut != src
    (tmp_path / "bq.py").write_text(cut)
    fs = run_analysis(str(tmp_path), AnalysisConfig(
        include=("bq.py",), passes=("kernels",)), PASSES)
    assert [(f.rule, f.symbol) for f in fs] == [("layout-contract",
                                                 "_host_layout")]
    assert "ver_k" in fs[0].message


def test_user_edges_narrow_through_a_checked_caster():
    """The narrowing the strict run found in ``TemporalGraph``: an id or a
    timestamp past int32 raises instead of wrapping; in range the graph is
    the reference's."""
    from repro.core.temporal_graph import TemporalGraph as RefGraph
    from repro_torch.core.temporal_graph import TemporalGraph
    edges = [(0, 1, 5), (1, 2, 3), (2, 0, 2**31 - 1)]
    g, want = TemporalGraph.from_edges(3, edges), RefGraph.from_edges(3,
                                                                      edges)
    for f in ("src", "dst", "t"):
        assert getattr(g, f).dtype == getattr(want, f).dtype
        assert (getattr(g, f) == getattr(want, f)).all()
    with pytest.raises(OverflowError, match="timestamps"):
        TemporalGraph.from_edges(3, [(0, 1, 2**31)])
    with pytest.raises(OverflowError, match="timestamps"):
        g.extend([(0, 1, 2**32)])


def test_strict_on_repo_tree_is_clean():
    """The gate: no finding on the port's tree, and the baseline is
    empty."""
    config = repo_config()
    assert Baseline.load(os.path.join(REPO, config.baseline)).entries == []
    assert main(["--root", REPO, "--strict"]) == 0


def test_config_file_points_at_the_port():
    config = repo_config()
    assert config.include == ("src/repro_torch", FIXTURES)
    assert config.hot_path_modules == (
        "repro_torch.serving.executor", "repro_torch.serving.planner",
        "repro_torch.core.batch_query")
    assert config.wallclock_modules == ("repro_torch.serving",
                                        "repro_torch.obs")
    assert set(config.passes) == set(PASSES) == {"locks", "api", "torch",
                                                 "kernels"}
    from repro.analysis import AnalysisConfig as RefConfig
    ref = RefConfig.from_pyproject(REPO)
    assert config.lock_receivers == ref.lock_receivers
    assert config.deprecated_calls == ref.deprecated_calls


def test_reference_include_does_not_reach_the_port():
    from repro.analysis.core import AnalysisConfig as RefConfig
    from repro.analysis.core import collect_files
    files = collect_files(REPO, RefConfig.from_pyproject(REPO))
    assert files and not [f for f in files if "repro_torch" in f
                          or "analysis_torch" in f]


# ---------------------------------------------------------------------------
# suppressions, baseline, fingerprints
# ---------------------------------------------------------------------------

def test_inline_suppression_drops_the_finding(tmp_path):
    src = ("def f(x):\n"
           "    assert x > 0  # repro: ignore[bare-assert]\n"
           "    return x\n")
    mod = Module(str(tmp_path / "m.py"), "m.py", src)
    assert mod.suppressed(2, "bare-assert")
    assert not mod.suppressed(2, "lock-order")


def test_line_above_and_bare_suppressions(tmp_path):
    src = ("def f(x):\n"
           "    # repro: ignore[bare-assert] — a reason\n"
           "    assert x > 0\n"
           "y = 1  # repro: ignore\n")
    mod = Module(str(tmp_path / "m.py"), "m.py", src)
    assert mod.suppressed(3, "bare-assert")
    assert mod.suppressed(4, "anything")
    assert not mod.suppressed(1, "bare-assert")


def test_suppression_respected_end_to_end():
    fs = analyze("torch_clean.py", hot_path_modules=(FIXTURE_PKG,))
    assert fs == []      # its one .item() is suppressed inline


def test_baseline_round_trip(tmp_path):
    fs = analyze("kernel_violations.py")
    assert fs
    path = str(tmp_path / "baseline.json")
    Baseline.from_findings(fs, comment="fixture").save(path)
    loaded = Baseline.load(path)
    assert all(f.fingerprint in loaded for f in fs)
    assert "0" * 16 not in loaded
    assert Baseline.load(str(tmp_path / "nope.json")).entries == []


def test_fingerprints_survive_line_shifts(tmp_path):
    """Fingerprints hash the line's text, not its number: lines added
    above move every finding and keep every fingerprint."""
    src = open(os.path.join(REPO, FIXTURES, "kernel_violations.py")).read()
    (tmp_path / "k.py").write_text(src)
    config = AnalysisConfig(include=("k.py",), passes=("kernels",))
    before = run_analysis(str(tmp_path), config, PASSES)
    head, _, rest = src.partition("\nimport numpy")
    (tmp_path / "k.py").write_text(head + "\n\n\n# moved\n\nimport numpy"
                                   + rest)
    after = run_analysis(str(tmp_path), config, PASSES)
    assert [f.line + 4 for f in before] == [f.line for f in after]
    assert [f.fingerprint for f in before] == [f.fingerprint for f in after]
    assert len({f.fingerprint for f in after}) == len(after)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_json_artifact_shape(tmp_path):
    out = str(tmp_path / "findings.json")
    assert main(["--root", REPO, "--json", out]) == 0
    with open(out) as f:
        payload = json.load(f)
    assert set(payload) >= {"findings", "baselined", "fresh", "passes"}
    assert payload["fresh"] == 0 and payload["findings"] == []
    assert payload["passes"] == sorted(PASSES)


def test_cli_usage_errors():
    assert main(["--root", REPO, "--passes", "jax"]) == 2   # not ported
    assert main(["--root", REPO, "--config", "/nonexistent.toml"]) == 2
    assert main(["--root", REPO, "--changed-only", "--base-ref",
                 "no-such-ref-anywhere"]) == 2


def test_cli_pass_subset_runs(capsys):
    assert main(["--root", REPO, "--passes", "torch,kernels"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_cli_bad_config_key_is_usage_error(tmp_path):
    (tmp_path / "a.toml").write_text('inclde = ["x"]\n')
    assert main(["--root", str(tmp_path), "--config",
                 str(tmp_path / "a.toml")]) == 2


def test_cli_write_baseline_then_strict_passes(tmp_path):
    """Seeded violations + --write-baseline -> strict exits 0; the same
    findings without the baseline fail strict."""
    root = tmp_path
    (root / "cfg.toml").write_text('include = ["bad.py"]\n'
                                   'baseline = "b.json"\n')
    (root / "bad.py").write_text(
        "import torch\n\n\ndef f(lib, x):\n"
        "    lib.x_launch(x)\n"
        "    return torch.device('cpu') if not torch.cuda.is_available() "
        "else x\n")
    cfg = ["--root", str(root), "--config", str(root / "cfg.toml")]
    assert main(cfg + ["--strict"]) == 1
    assert main(cfg + ["--write-baseline"]) == 0
    assert main(cfg + ["--strict"]) == 0
    data = json.loads((root / "b.json").read_text())
    assert {e["rule"] for e in data["findings"]} == {
        "launch-contract", "launch-rc", "cpu-fallback"}


def test_cli_changed_only(tmp_path):
    """``--changed-only`` reads ``git diff``: a fresh violation in a
    changed file is found, an untouched tree has nothing to analyze."""
    if shutil.which("git") is None:
        pytest.skip("no git")
    root = tmp_path
    (root / "cfg.toml").write_text('include = ["."]\n')
    (root / "m.py").write_text("def f(x):\n    return x\n")
    env = {**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}
    for cmd in (["init", "-q"], ["add", "-A"], ["commit", "-qm", "base"]):
        subprocess.run(["git", *cmd], cwd=root, check=True, env=env)
    cfg = ["--root", str(root), "--config", str(root / "cfg.toml"),
           "--strict", "--changed-only"]
    assert main(cfg) == 0
    (root / "m.py").write_text("def f(x):\n    assert x\n    return x\n")
    assert main(cfg) == 1


def test_module_entry_point_strict_exit_code():
    """``python -m repro_torch.analysis --strict`` in a fresh interpreter:
    exit 0 on the repo tree."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s), 0 not baselined" in proc.stdout


def test_default_config_path():
    assert os.path.exists(os.path.join(REPO, DEFAULT_CONFIG))


# ---------------------------------------------------------------------------
# shape flow
# ---------------------------------------------------------------------------

def _env(src: str) -> sf.Env:
    tree = ast.parse(src)
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef))
    return sf.function_env(fn, sf.module_int_consts(tree))


def _expr(text: str) -> ast.AST:
    return ast.parse(text, mode="eval").body


@pytest.mark.parametrize("line,want", [
    ("x = torch.zeros(n, dtype=torch.int32)", "int32"),
    ("x = torch.arange(n, dtype=torch.long)", "int64"),
    ("x = y.int()", "int32"),
    ("x = y.long()", "int64"),
    ("x = y.to(torch.int64)", "int64"),
    ("x = y.to(dev, torch.int32)", "int32"),
    ("x = y.to(dtype=torch.int32)", "int32"),
    ("x = np.cumsum(c.astype(np.int64))", "int64"),
    ("x = torch.cumsum(y.int(), 0)", "int64"),
    ("x = torch.cat([y.int(), z])", "int32"),
    ("x = y.long()[ok]", "int64"),
    ("x = y.long().to(dev)", "int64"),
    ("x = y.to(dev)", None),
    ("x = y.float()", "float32"),
])
def test_dtype_flow_knows_torch(line, want):
    env = _env(f"def f(y, z, c, n, dev, ok):\n    {line}\n")
    assert env.dtype_of(_expr("x")) == want


def test_padding_idiom_proves_divisibility():
    env = _env("def f(w, block=256):\n"
               "    e = w.shape[0]\n"
               "    ep = int(np.ceil(max(e, 1) / block)) * block\n")
    assert sf.divides(env.lin(_expr("ep")), env.lin(_expr("block")))
    assert not sf.divides(env.lin(_expr("e")), env.lin(_expr("block")))


def test_products_and_repetition():
    assert sf.int_expr_has_product(_expr("k_index * n + u"))
    assert not sf.int_expr_has_product(_expr("[u] * w"))
    assert not sf.int_expr_has_product(_expr("4 * n + 1"))
