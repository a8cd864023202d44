#!/usr/bin/env python3
"""meshgraphnet at full width and depth served edge-parallel on four cards,
one forward under torch.profiler at each cut of ogb_products:

    python3 bench_mesh_gnn.py

Four rank processes (one a card, NCCL over a file store; rank 0 prints)
on the ``(data, model)`` mesh (2, 2), the allocator with expandable
segments as ``chip_smoke.py --multi`` sets it. For each cut of CUTS, in
order: ogb_products with its nodes and edges divided by the cut, drawn
as ``chip_smoke.mgn_graph`` draws it, the model drawn from a seed and
placed replicated, and one ``configs.make_serve_step(mesh=)`` forward
under torch.profiler: wall, device busy, idle share, the shares of B4,
B5 and NCCL, the top kernels and host operations, B4/B5 launches, and
the caching allocator's counts over the forward (``torch.cuda.
memory_stats``: cudaMalloc and cudaFree calls, retries after a failed
allocation, peak allocated and reserved GiB). Prints one line per cut,
the card, and last a JSON list of records. Needs four NVIDIA cards; exits
non-zero without them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WORLD = 4
ARCH = "meshgraphnet"
#: the cuts of ogb_products served, in order: the one chip_smoke.py
#: serves, then the one whose forward the allocator slowed
CUTS = (4, 2)
#: the allocator's counters read over the forward
COUNTERS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
            "num_sync_all_streams", "num_ooms")


def rank_main(args) -> int:
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import sharding as shd

    store = dist.FileStore(args.store, WORLD)
    say = print if args.rank == 0 else (lambda *a, **k: None)
    dev = torch.device("cuda", args.rank)
    torch.cuda.set_device(dev)
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda", store=store,
                     rank=args.rank)
    spec = configs.get(ARCH)
    cfg = configs.cell_model_cfg(spec, "ogb_products")
    ogb = spec.shapes["ogb_products"]
    records = []
    for cut in CUTS:
        n, e = ogb["n"] // cut, ogb["e"] // cut
        batch = cs.mgn_graph(cfg, n, e, cs.MESH_GNN_SEED, dev)
        serve = configs.make_serve_step(spec, "ogb_products", cfg, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(cs.MESH_GNN_SEED)
        placed = configs.init_params(spec, cfg, gen, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_stats(dev)
        cs.reset_b4_b5()
        shd.reset_collectives()
        shares: dict = {}
        prof = cs.profiled(lambda: (serve(placed, batch),
                                    torch.cuda.synchronize()),
                           {"B4": cs.is_b4, "B5": cs.is_b5,
                            "NCCL": lambda k: "nccl" in k.lower()}, shares)
        after = torch.cuda.memory_stats(dev)
        launches = cs.gnn_b4_b5(f"{ARCH} ogb_products / {cut}")
        counts = shd.collective_counts()
        alloc = {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}
        peak = {k: after[f"{k}_bytes.all.peak"] / 2**30
                for k in ("allocated", "reserved")}
        E = batch["src"].shape[0]
        rec = dict(cut=cut, nodes=n, edges=E, edges_a_rank=E // WORLD,
                   shares=shares, allocator=alloc, peak_gib=peak)
        records.append(rec)
        say(f"[mesh-gnn] {ARCH} served at ogb_products / {cut} ({n:,} "
            f"nodes, {E:,} directed edges, {E // WORLD:,} a rank) on (2, 2), "
            f"one forward under torch.profiler, rank 0: {prof}; launches "
            f"{cs.launch_clause(launches)}; collectives "
            f"{cs.mesh_counts_line(counts)}; allocator over the forward: "
            + ", ".join(f"{k} {v:,}" for k, v in alloc.items())
            + f", peak allocated {peak['allocated']:.2f} GiB, reserved "
            f"{peak['reserved']:.2f} GiB")
        del batch, placed, serve
        torch.cuda.empty_cache()
    if args.rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print(smi[0] if smi else "nvidia-smi: no output")
        print(json.dumps(records))
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"bench_mesh_gnn: needs {WORLD} CUDA cards", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.rank >= 0:
        return rank_main(args)
    from repro_torch.kernels import segment_matmul
    for build in (segment_matmul.build, segment_matmul.build_segment_sum):
        build()
    from bench_mesh_sum import run_ranks
    env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
           **os.environ}
    return run_ranks(__file__, [], env, limit=900.0)


if __name__ == "__main__":
    sys.exit(main())
