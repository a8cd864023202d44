"""CLI for the port's static-analysis suite:
``python -m repro_torch.analysis``.

The reference's flags (``--strict``, ``--json``, ``--baseline``,
``--write-baseline``, ``--passes``, ``--changed-only``, ``--base-ref``),
with ``--config PATH`` in place of the ``pyproject.toml`` lookup (default:
``src/repro_torch/analysis/analysis.toml`` under ``--root``).

Exit codes: 0 = clean (or every finding baselined), 1 = non-baselined
findings in ``--strict`` mode, 2 = usage error. Default (non-strict) runs
always exit 0 — they are for humans iterating; the gate runs ``--strict``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import PASSES
from .core import DEFAULT_CONFIG, AnalysisConfig, Baseline, run_analysis


def changed_files(root: str, base_ref: str) -> frozenset[str]:
    """Repo-relative paths changed vs ``base_ref`` (committed, staged and
    worktree changes alike). Raises ``CalledProcessError`` outside a git
    checkout or on an unknown ref — the caller maps that to exit 2."""
    out = subprocess.run(
        ["git", "diff", "--name-only", base_ref],
        cwd=root, capture_output=True, text=True, check=True).stdout
    return frozenset(line.strip() for line in out.splitlines()
                     if line.strip())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's concurrency/PyTorch/API/kernel static "
                    "analysis")
    p.add_argument("--root", default=".",
                   help="repo root the include paths are relative to "
                        "(default: cwd)")
    p.add_argument("--config", metavar="PATH",
                   help=f"settings file (default: <root>/{DEFAULT_CONFIG})")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on any finding not in the baseline")
    p.add_argument("--json", dest="json_out", metavar="PATH",
                   help="write findings JSON (CI artifact); '-' = stdout")
    p.add_argument("--baseline", metavar="PATH",
                   help="override the baseline path of the settings")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept current findings into the baseline file")
    p.add_argument("--passes", metavar="NAMES",
                   help="comma-separated pass subset "
                        f"(available: {', '.join(sorted(PASSES))})")
    p.add_argument("--changed-only", action="store_true",
                   help="analyze only files changed vs --base-ref "
                        "(fast pre-push loop; strict runs stay "
                        "full-tree)")
    p.add_argument("--base-ref", default="HEAD", metavar="REF",
                   help="git ref --changed-only diffs against "
                        "(default: HEAD)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    root = os.path.abspath(args.root)
    config_path = (args.config if args.config
                   else os.path.join(root, DEFAULT_CONFIG))
    if args.config and not os.path.exists(config_path):
        print(f"--config: no such file {config_path!r}", file=sys.stderr)
        return 2
    try:
        config = AnalysisConfig.from_toml(config_path)
    except (ValueError, OSError) as e:
        print(f"--config: {e}", file=sys.stderr)
        return 2
    if args.passes:
        names = tuple(n.strip() for n in args.passes.split(",") if n.strip())
        unknown = [n for n in names if n not in PASSES]
        if unknown:
            print(f"unknown passes: {', '.join(unknown)} "
                  f"(available: {', '.join(sorted(PASSES))})",
                  file=sys.stderr)
            return 2
        config.passes = names
    if args.changed_only:
        try:
            config.only_files = changed_files(root, args.base_ref)
        except (subprocess.CalledProcessError, OSError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            print(f"--changed-only: git diff vs {args.base_ref!r} failed: "
                  f"{detail.strip()}", file=sys.stderr)
            return 2

    findings = run_analysis(root, config, PASSES)

    baseline_path = os.path.join(
        root, args.baseline if args.baseline else config.baseline)
    baseline = Baseline.load(baseline_path)
    fresh = [f for f in findings if f.fingerprint not in baseline]

    if args.write_baseline:
        Baseline.from_findings(
            findings,
            comment="accepted at baseline write; justify or fix").save(
                baseline_path)
        print(f"baseline: wrote {len(findings)} finding(s) to "
              f"{baseline_path}")

    payload = {
        "findings": [f.to_dict() for f in findings],
        "baselined": sum(1 for f in findings
                         if f.fingerprint in baseline),
        "fresh": len(fresh),
        "passes": sorted(config.passes or PASSES),
    }
    if args.json_out == "-":
        json.dump(payload, sys.stdout, indent=2)
        print()
    elif args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")

    for f in findings:
        marker = "" if f.fingerprint not in baseline else " (baselined)"
        print(f.format() + marker)
    print(f"{len(findings)} finding(s), {len(fresh)} not baselined")

    if args.strict and fresh:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
