"""Render the dry run's tables from its JSON records: the port's
``repro.launch.report``.

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_torch

:func:`dryrun_table`, :func:`roofline_table` and :func:`pick_hillclimb`
render a record as the reference's do, string for string; a quantity a
record holds as ``None`` (not computed) prints as ``-``. The port's
records are traced on the card's ``1x1`` mesh and carry, under
``production``, the per-device argument bytes on the production meshes
(:func:`production_table`).
"""

from __future__ import annotations

import json
import os
import sys


def load(dirpath: str):
    recs = []
    for fn in sorted(os.listdir(dirpath)):
        if fn.endswith(".json"):
            with open(os.path.join(dirpath, fn)) as f:
                recs.append(json.load(f))
    return recs


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/1e9:.2f}GB" if b >= 1e9 else f"{b/1e6:.1f}MB"


def _e(x, spec: str = ".2e") -> str:
    return "-" if x is None else format(x, spec)


def dryrun_table(recs):
    lines = [
        "| arch | shape | mesh | compile s | flops/dev | bytes/dev | coll B/dev (ops) | arg B/dev | temp B/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        mem = r.get("memory", {})
        counts = r["collectives"].get("counts", {})
        cshort = "+".join(f"{k.split('-')[-1][:4]}:{v}" for k, v in sorted(counts.items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh'].split(':')[0]} "
            f"| {r['compile_s']} | {_e(r['flops_per_device'])} "
            f"| {_e(r['bytes_per_device'])} | {_e(r['collectives']['total'])} ({cshort}) "
            f"| {fmt_bytes(mem.get('argument_size_in_bytes'))} "
            f"| {fmt_bytes(mem.get('temp_size_in_bytes'))} |")
    return "\n".join(lines)


def roofline_table(recs, mesh_filter="16x16"):
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | model TFLOPs | HLO TFLOPs | useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if not r["mesh"].startswith(mesh_filter):
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4f} "
            f"| {rf['memory_s']:.4f} | {rf['collective_s']:.4f} "
            f"| {rf['dominant'].replace('_s','')} "
            f"| {rf['model_flops']/1e12:.1f} | {rf['hlo_flops_global']/1e12:.1f} "
            f"| {rf['useful_flop_ratio']:.2f} | {rf['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def production_table(recs):
    """Per-device argument bytes of every cell on each production mesh."""
    meshes = sorted({m for r in recs for m in r.get("production", {})})
    lines = ["| arch | shape | " + " | ".join(
                 f"arg B/dev {m.split(':')[0]}" for m in meshes) + " |",
             "|---|---|" + "---|" * len(meshes)]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        prod = r.get("production", {})
        lines.append(f"| {r['arch']} | {r['shape']} | " + " | ".join(
            fmt_bytes(prod.get(m, {}).get("argument_size_in_bytes"))
            for m in meshes) + " |")
    return "\n".join(lines)


def pick_hillclimb(recs, mesh_filter="16x16"):
    """worst roofline fraction / most collective-bound, among the records
    of ``mesh_filter``."""
    singles = [r for r in recs if r["mesh"].startswith(mesh_filter)]
    worst = min(singles, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(singles, key=lambda r: (r["roofline"]["collective_s"]
                                       / max(r["roofline"]["step_time_lb_s"], 1e-12)))
    return worst, coll


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "results/dryrun_torch"
    recs = load(d)
    print(f"### Dry-run ({len(recs)} cells)\n")
    print(dryrun_table(recs))
    for m in sorted({r["mesh"].split(":")[0] for r in recs}):
        print(f"\n### Roofline ({m})\n")
        print(roofline_table(recs, m))
    if any(r.get("production") for r in recs):
        print("\n### Argument bytes per device on the production meshes\n")
        print(production_table(recs))
    card = "16x16" if any(r["mesh"].startswith("16x16") for r in recs) \
        else "1x1"
    worst, coll = pick_hillclimb(recs, card)
    print(f"\nworst roofline fraction: {worst['arch']} x {worst['shape']} "
          f"({worst['roofline']['roofline_fraction']:.3f})")
    print(f"most collective-bound:   {coll['arch']} x {coll['shape']} "
          f"({coll['roofline']['collective_s']:.3f}s of "
          f"{coll['roofline']['step_time_lb_s']:.3f}s)")


if __name__ == "__main__":
    main()
