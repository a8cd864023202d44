#!/usr/bin/env python3
"""The k-core peel fixpoint (``kcore_peel.kcore_fixpoint``) on the card, on
chip_smoke.py's [peel] operands:

    python3 bench_peel.py [--only NAME ...]

For each graph (CollegeMsg's scale: 17,474 distinct pairs, k = 2..39; SNAP
sx-superuser's: 461,605 pairs, k = 2..122; both generated from a seed) and
each path, the fixpoint kernel (``kernel``) and the loop it replaced, B3a
then B3b and one flag read per round (``loop``, chip_smoke.old_fixpoint),
every fixpoint is held against the plain version (``ref.kcore_fixpoint``)
on the card, masks equal, then timed with chip_smoke.py's helpers: the
wall of all fixpoints after a warm call, the device time of each by CUDA
events with the card asleep first (the kernel's host stays ahead; the
loop's reads the flag every round, so its device time is its wall), the
timed run's masks held to the first run's, and the host time per call.
Prints one line per (graph, path) and, last, the card and a JSON list of
records. Needs an NVIDIA card; exits non-zero without one or on a
disagreement.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=[],
                    help="graphs whose name holds one of these words")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_peel: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import kcore
    from repro_torch.core.temporal_graph import gen_temporal_graph
    from repro_torch.kernels import kcore_peel as kp
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    records = []
    for name, spec in (("CollegeMsg", cs.COLLEGEMSG),
                       ("sx-superuser", cs.SX_SUPERUSER)):
        if args.only and not any(w in name for w in args.only):
            continue
        g = gen_temporal_graph(**spec)
        us, ud, _ = cs.distinct_pairs(g, dev)
        m, n = int(us.shape[0]), g.n
        ks = list(range(2, kcore.k_max(g) + 2))
        paths = {"kernel": functools.partial(kp.kcore_fixpoint, us, ud, n),
                 "loop": lambda k: cs.old_fixpoint(us, ud, n, k)[0]}
        for path, fix in paths.items():
            got = [fix(k) for k in ks]
            for k, a in zip(ks, got):
                cs.check_equal(f"{name} {k}-core ({path})", a,
                               ref.kcore_fixpoint(us, ud, n, k))
            _, t_wall = cs.wall(lambda: [fix(k) for k in ks])
            dev_ms, ahead, timed = cs.device_times(
                [functools.partial(fix, k) for k in ks], 2 * t_wall * 1e3)
            for k, a, b in zip(ks, timed, got):
                cs.check_equal(f"{name} {k}-core of the timed run ({path})",
                               a, b)
            host = cs.host_ms(lambda: fix(ks[len(ks) // 2]))
            rec = {"graph": name, "path": path, "pairs": m, "n": n,
                   "fixpoints": len(ks), "device_ms": sum(dev_ms),
                   "device_ms_per_fixpoint": sum(dev_ms) / len(ks),
                   "host_ahead": ahead, "host_ms_per_call": host,
                   "wall_ms": t_wall * 1e3}
            records.append(rec)
            print(f"[bench_peel] {name} ({m} pairs, n={n}), {path}: "
                  f"{len(ks)} fixpoints equal to the plain version; device "
                  f"{rec['device_ms']:.6f} ms ("
                  f"{rec['device_ms_per_fixpoint'] * 1e3:.3f} us per "
                  f"fixpoint, {'host ahead' if ahead else 'back to back'}), "
                  f"host {host * 1e3:.3f} us per call, wall "
                  f"{rec['wall_ms']:.6f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
