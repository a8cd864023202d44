#!/usr/bin/env python3
"""B4 (``segment_matmul.segment_sum``) on the card at the main paths' shapes:

    python3 bench_segment_sum.py [--src DIR] [--only NAME ...] [--iters N]

Shapes and ids: meshgraphnet's aggregation at ogb_products / 16 (7,732,736
rows of 128 into 153,064 nodes by the power-law graph's ``dst``, as
chip_smoke.py's ``mgn_graph`` builds it) and at full_graph_sm; GraphSAGE's
three sums at minibatch_lg (337,920 rows into 169,984 nodes, d = 602, 128
and 1; ids grouped by destination in runs of 10-15 over 36% of the rows,
the rest padding rows on node 0, as a sampled batch lays them out); NequIP's
and MACE's messages at molecule (16,384 rows of 32 to 1,152 into 3,840
atoms, 1,024 padding rows on atom 0). The rows hold small integers (as
f32, 0 on padding rows), which sum exactly in any order, so each result
must equal its plain version (``ref.segment_sum``) bit for bit (a hub of
N(0, 1) rows sums within f32's rounding of a few hundred in any order,
more than chip_smoke.py's 1e-4); each is timed beside ``index_add_``: device time with the host ahead, back to back
and host time per call (``chip_smoke.call_times``), the bound
(``segment_sum_bound_ms``) and its share. Where the tree has B4's plan
(``segment_plan``), the plan is built once and timed apart, the kernel
takes it, and two calls must agree bit for bit. ``--src`` imports
``repro_torch`` from another checkout's ``src`` (an unpacked parent
commit), so that two versions compare on one card in one call. Prints one
line per shape and, last, the card and a JSON list of records. Needs an
NVIDIA card; exits non-zero without one or on a disagreement.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def mgn_dst(n: int, e: int, seed: int) -> np.ndarray:
    """``dst`` of chip_smoke.mgn_graph(cfg, n, e, seed): the first e pairs
    of a power-law graph, both directions, padded to 512 rows on node 0."""
    from repro_torch.data import graph_sampler as gs
    a, b = gs.random_powerlaw_graph(n, -(-2 * e // n) + 1, seed=seed)
    a, b = a[:e], b[:e]
    dst = np.zeros(-(-2 * e // 512) * 512, np.int32)
    dst[:2 * e] = np.concatenate([b, a])
    return dst


def sampled_dst(E: int, S: int, rng) -> tuple[np.ndarray, int]:
    """A padded GraphSAGE batch's ``dst``: runs of 10-15 over 36% of the
    rows, node 0 for the rest; returns the ids and the real rows."""
    runs = rng.integers(10, 16, E // 12)
    real = np.repeat(rng.integers(0, S, len(runs)), runs)[:int(E * 0.36)]
    ids = np.zeros(E, np.int32)
    ids[:len(real)] = real
    return ids, len(real)


def molecule_dst(E: int, S: int, rng) -> tuple[np.ndarray, int]:
    ids = np.zeros(E, np.int32)
    ids[:E - 1024] = rng.integers(0, S, E - 1024)
    return ids, E - 1024


def shapes(rng) -> list:
    """(name, E, d, S, ids, real rows)."""
    out = []
    n, e = 2_449_029 // 16, 61_859_140 // 16
    dst = mgn_dst(n, e, 30)
    out.append(("mgn ogb_products / 16", dst.shape[0], 128, n, dst, 2 * e))
    dst = mgn_dst(2_708, 10_556, 29)
    out.append(("mgn full_graph_sm", dst.shape[0], 128, 2_708, dst, 21_112))
    ids, real = sampled_dst(337_920, 169_984, rng)
    for d in (602, 128, 1):
        out.append((f"sage d={d}", 337_920, d, 169_984, ids, real))
    ids, real = molecule_dst(16_384, 3_840, rng)
    for C, arch in ((32, "nequip"), (128, "mace")):
        for w, what in ((C, "a_s"), (3 * C, "a_v"), (9 * C, "a_t")):
            out.append((f"{arch} {what} d={w}", 16_384, w, 3_840, ids, real))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--only", nargs="*", default=[],
                    help="shapes whose name holds one of these words")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_segment_sum: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import call_times
    sys.path.insert(0, args.src)
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm

    sm.build_segment_sum()
    has_plan = hasattr(sm, "segment_plan")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    records = []
    for name, E, d, S, ids_np, real in shapes(rng):
        if args.only and not any(w in name for w in args.only):
            continue
        ids = torch.as_tensor(ids_np, device=dev)
        vals = torch.randint(-4, 5, (E, d), generator=gen, device=dev,
                             dtype=torch.float32)
        vals[real:] = 0.0                           # masked padding rows
        plan = sm.segment_plan(ids, S) if has_plan else ids
        got, want = sm.segment_sum(vals, plan, S), ref.segment_sum(vals, ids,
                                                                  S)
        again = sm.segment_sum(vals, plan, S)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"B4 {name} disagrees with its plain version "
                                 f"(max abs err {err})")
        same = torch.equal(got, again)
        if has_plan and not same:
            raise AssertionError(f"B4 {name}: two calls differ in their bits")
        del got, want, again
        ms, kern = call_times(lambda: sm.segment_sum(vals, plan, S),
                              args.iters)
        lib_ms, lib = call_times(lambda: torch.zeros(
            (S, d), device=dev).index_add_(0, ids, vals), args.iters)
        plan_ms, plan_clause = (call_times(lambda: sm.segment_plan(ids, S),
                                           args.iters)
                                if has_plan else (None, "none"))
        bound = sm.segment_sum_bound_ms(E, d, S)
        records.append(dict(name=name, E=E, d=d, S=S, ms=ms,
                            library_ms=lib_ms, plan_ms=plan_ms,
                            bound_ms=bound, max_abs_err=err,
                            bit_equal=same))
        print(f"B4 {name} ({E} x {d} into {S}): max abs err {err:.3e}; two "
              f"calls {'bit-equal' if same else 'differ'}; kernel {kern}; "
              f"bound {bound:.6f} ms = {bound / ms:.3f} of the kernel; "
              f"index_add_ {lib}; plan {plan_clause}", flush=True)
        del vals, ids, plan
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"src": args.src, "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
