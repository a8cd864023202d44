#!/usr/bin/env python3
"""The port's sum over ranks in rank order against NCCL's all-reduce, on
the card:

    python3 bench_mesh_sum.py [--iters N]

Four rank processes (one a card, NCCL over a file store; rank 0 prints)
build the ``(data, model)`` meshes (2, 2) and (1, 4). On each mesh's
``model`` axis, f32 tensors of the LM's row-parallel partial sums (glm4's
prefill of 2 x 4,096 tokens and dbrx's of 4,096, (rows, d_model); their
decode steps of 16 and 4 rows) and of 1, 4 and 16 MiB (either side of
``sharding.GATHER_SUM_BYTES``) are summed by ``runtime.sharding.
all_reduce`` (the route it picks), by each of its two routes (every
rank's tensor gathered and added here; chunks exchanged, added and
gathered back) and by ``torch.distributed.all_reduce`` (NCCL's own
order), each timed over ``--iters`` back-to-back calls with CUDA events
after a warm-up; the three routes of the rank-order sum must agree bit
for bit, and the largest |difference| from NCCL's is printed beside the
times. Then NCCL's offset dependence: a (32, 6144) tensor summed whole
and as its eight (4, 6144) row blocks, the elements whose bits part
counted for NCCL and for the rank-order sum. Prints one line per
case, the card, and last a JSON list of records. Needs four NVIDIA
cards; exits non-zero without them or on a disagreement of the routes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent
WORLD = 4
#: (name, rows, d_model) of the row-parallel partial sums
CASES = [("glm4 prefill 2 x 4096", 8192, 4096),
         ("dbrx prefill 1 x 4096", 4096, 6144),
         ("glm4 decode batch 16", 16, 4096),
         ("dbrx decode batch 4", 4, 6144),
         ("1 MiB", 64, 4096), ("4 MiB", 256, 4096), ("16 MiB", 1024, 4096)]


def ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rank_main(args) -> int:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import sharding as shd

    store = dist.FileStore(args.store, WORLD)
    say = print if args.rank == 0 else (lambda *a, **k: None)
    dev = torch.device("cuda", args.rank)
    records = []
    meshes = {}
    for shape in ((2, 2), (1, 4)):
        meshes[shape] = make_mesh(shape, ("data", "model"), device="cuda",
                                  store=store, rank=args.rank)
    for shape, mesh in meshes.items():
        group = mesh.get_group("model")
        n = shd.axis_sizes(mesh)["model"]
        for name, rows, d in CASES:
            gen = torch.Generator(device=dev).manual_seed(args.rank)
            x = torch.randn(rows, d, generator=gen, device=dev)

            def nccl():
                out = x.clone()
                dist.all_reduce(out, group=group)
                return out

            def ordered():
                return shd.all_reduce(x, mesh, "model")

            def gathered():
                with mock.patch.object(shd, "GATHER_SUM_BYTES", 1 << 62):
                    return shd.all_reduce(x, mesh, "model")

            def exchanged():
                return shd._exchange_sum(x.reshape(-1), n, group).view(x.shape)
            got = ordered()
            for route, fn in (("gather", gathered), ("exchange", exchanged)):
                if not torch.equal(fn(), got):
                    raise AssertionError(f"{name} on {shape}: the {route} "
                                         f"route parts from all_reduce")
            diff = float((nccl() - got).abs().max())
            t = {k: ms(fn, args.iters) for k, fn in (
                ("nccl", nccl), ("ordered", ordered), ("gather", gathered),
                ("exchange", exchanged))}
            nbytes = rows * d * 4
            picked = "gather" if n == 2 or nbytes < shd.GATHER_SUM_BYTES \
                else "exchange"
            rec = dict(mesh=list(shape), case=name, rows=rows, d=d,
                       route=picked, nccl_ms=t["nccl"],
                       rank_order_ms=t["ordered"], gather_ms=t["gather"],
                       exchange_ms=t["exchange"], max_diff=diff)
            records.append(rec)
            say(f"[sum] {name} ({rows} x {d} f32, {nbytes / 2**20:.2f} MiB) "
                f"over 'model' of {shape}: NCCL all-reduce {t['nccl']:.4f} "
                f"ms, the sum in rank order {t['ordered']:.4f} ms "
                f"({t['ordered'] / t['nccl']:.2f}x; {picked} route), gather "
                f"{t['gather']:.4f} ms, exchange {t['exchange']:.4f} ms; "
                f"largest |difference| from NCCL's {diff:.3e}")
        gen = torch.Generator(device=dev).manual_seed(args.rank)
        x = torch.randn(32, 6144, generator=gen, device=dev)
        def nccl_sum(t):
            out = t.clone()
            dist.all_reduce(out, group=group)
            return out
        parted = {}
        for what, total in (("NCCL", nccl_sum), ("rank order", lambda t:
                                                 shd.all_reduce(t, mesh,
                                                                "model"))):
            whole = total(x)
            blocks = torch.cat([total(x[i:i + 4].contiguous())
                                for i in range(0, 32, 4)])
            parted[what] = int((whole != blocks).sum())
        records.append(dict(mesh=list(shape), case="offset", parted=parted))
        say(f"[sum] {shape}: a (32, 6144) f32 sum against its eight (4, "
            f"6144) row blocks summed alone, elements whose bits part: "
            + ", ".join(f"{k} {v:,}" for k, v in parted.items())
            + f" of {32 * 6144:,}")
        if parted["rank order"]:
            raise AssertionError(f"the rank-order sum depends on the offset "
                                 f"on {shape}")
    if args.rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print(smi[0] if smi else "nvidia-smi: no output")
        print(json.dumps(records))
    dist.destroy_process_group()
    return 0


def run_ranks(script: str, args: list, env: dict | None = None,
              limit: float = 600.0) -> int:
    """``script`` (a path) with ``args`` in WORLD rank processes, each
    given ``--store`` (a file store in a temporary directory) and
    ``--rank r``; 0 once every rank exits 0, 1 as soon as one fails or
    ``limit`` seconds pass, every rank killed on the way out."""
    tmp = tempfile.mkdtemp(prefix="mesh_")
    argv = [sys.executable, script, *args, "--store",
            os.path.join(tmp, "store")]
    procs = [subprocess.Popen(argv + ["--rank", str(r)], env=env)
             for r in range(WORLD)]
    t0 = time.perf_counter()
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                print(f"[{Path(script).stem}] ranks passed in "
                      f"{time.perf_counter() - t0:.1f}s")
                return 0
            if any(c not in (None, 0) for c in codes) or \
                    time.perf_counter() - t0 > limit:
                print(f"{Path(script).name}: ranks {codes}", file=sys.stderr)
                return 1
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"bench_mesh_sum: needs {WORLD} CUDA cards", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.rank >= 0:
        return rank_main(args)
    return run_ranks(__file__, ["--iters", str(args.iters)])


if __name__ == "__main__":
    sys.exit(main())
