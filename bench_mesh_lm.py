#!/usr/bin/env python3
"""glm4-9b at full width and depth under the ``(data, model)`` mesh on four
cards, through the entry points, with the sum over ranks in rank order
(``runtime.sharding.all_reduce`` as shipped) and with NCCL's own
all-reduce in its place, alternating, wall per call:

    python3 bench_mesh_lm.py

Four rank processes (one a card, NCCL over a file store; rank 0 prints),
the weights drawn from a seed on the card as ``chip_smoke.py --multi``
draws them, the allocator with expandable segments as it sets them:
``configs.make_train_step(mesh=)`` on (2, 2), a global batch of 2 x
4,096 tokens (remat, AdamW f32 moments); then
``configs.make_serve_step(mesh=)`` on (1, 4): a prefill of 1 x 4,096
tokens and decode steps at batch 16 at the end of a 32,768-slot cache of
N(0, 1) keys and values. Each of the three is timed four times in the
order NCCL, rank order, rank order, NCCL (``sharding._sum_in_rank_order``
replaced by ``torch.distributed.all_reduce`` for the NCCL turns: the
sum as the port had it before the sum in rank order): one warm-up call
and STEPS timed calls a turn (prefill 3, decode STEPS + 3),
medians of the synchronized wall; then one decode step of each sum under
torch.profiler. Prints one line per measurement with the collectives a
call (rank 0), the card, and last a JSON record. Needs four NVIDIA
cards; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WORLD = 4
ARCH = "glm4-9b"
SEED = 47
SEQ = 4096
DECODE_BATCH = 16
#: timed calls a turn after its warm-up (the decode's: STEPS + 3)
STEPS = 2


def median_wall(fn, n: int) -> tuple[float, object]:
    """One warm-up call of ``fn``, then the median synchronized wall of
    ``n`` calls and the last call's result."""
    out = fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


#: the order of the turns of each measurement
TURNS = ("nccl", "rank order", "rank order", "nccl")


def rank_main(args) -> int:
    from unittest import mock

    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd

    store = dist.FileStore(args.store, WORLD)
    say = print if args.rank == 0 else (lambda *a, **k: None)
    dev = torch.device("cuda", args.rank)
    torch.cuda.set_device(dev)
    spec = configs.get(ARCH)
    full = spec.model_cfg
    rec = {}

    def nccl_sum(x, mesh, axis):
        out = x.clone()
        dist.all_reduce(out, group=shd._group(mesh, axis))
        return out

    def sums(turn: str):
        """The context of a turn: NCCL's all-reduce in place of the sum
        in rank order, or the sum as shipped."""
        return (mock.patch.object(shd, "_sum_in_rank_order", nccl_sum)
                if turn == "nccl" else contextlib.nullcontext())

    def turns(name: str, fn, n: int) -> dict:
        """``fn`` timed in each turn of :data:`TURNS` (``median_wall``);
        the medians by sum, in turn order, and the last call's counts."""
        got = {"nccl": [], "rank order": []}
        counts = None
        for turn in TURNS:
            with sums(turn):
                t, counts = median_wall(fn, n)
            got[turn].append(t)
        rec[name] = got
        return counts

    def clause(name: str, scale: float, unit: str) -> str:
        return "; ".join(f"{k} " + ", ".join(f"{t * scale:.4f}" for t in v)
                         + f" {unit}" for k, v in rec[name].items())

    # -- train steps on (2, 2) ---------------------------------------------
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda", store=store,
                     rank=args.rank)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = configs.init_params(spec, full, gen, device=dev, mesh=mesh)
    state = adamw.init_state(dict(model.named_parameters()))
    step = configs.make_train_step(
        spec, full, adamw.AdamWConfig(total_steps=40, warmup_steps=2),
        mesh=mesh)
    batch = cs.mesh_tokens(full.vocab, 2, SEQ, SEED + 1, dev)
    losses = []

    def train():
        nonlocal state
        shd.reset_collectives()
        _, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        return shd.collective_counts()
    counts = turns("step_s", train, STEPS)
    rec["losses"] = losses
    say(f"[mesh-lm] {ARCH} {full.n_layer} layers on (2, 2), 2 x {SEQ} "
        f"global batch, remat, AdamW: step (median of {STEPS} after "
        f"one warm-up, turns {', '.join(TURNS)}) {clause('step_s', 1, 's')}; "
        f"losses finite {all(map(math.isfinite, losses))}; collectives a "
        f"step (rank 0): {cs.mesh_counts_line(counts)}")
    del model, state, step
    torch.cuda.empty_cache()

    # -- serving on (1, 4) -------------------------------------------------
    mesh = make_mesh((1, 4), ("data", "model"), device="cuda", store=store,
                     rank=args.rank)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    placed = configs.init_params(spec, full, gen, device=dev, mesh=mesh)
    toks = cs.mesh_tokens(full.vocab, 1, SEQ, SEED + 9, dev)["tokens"]
    pre = configs.make_serve_step(spec, "prefill_32k", full, mesh=mesh)

    def prefill():
        shd.reset_collectives()
        pre(placed, {"tokens": toks})
        return shd.collective_counts()
    counts = turns("prefill_s", prefill, 3)
    say(f"[mesh-lm] {ARCH} on (1, 4), prefill 1 x {SEQ} (median of 3 "
        f"after one warm-up): {clause('prefill_s', 1, 's')}; collectives "
        f"(rank 0): {cs.mesh_counts_line(counts)}")
    slots = spec.shapes["decode_32k"]["seq"]
    cache = tfm.init_cache(full, DECODE_BATCH, slots, device=dev)
    for t in cache.values():
        t.normal_(generator=gen)
    dec = configs.make_serve_step(spec, "decode_32k", full, mesh=mesh)
    n_dec = STEPS + 3
    # every turn's warm-up and timed steps, then the two profiled ones
    at = slots - len(TURNS) * (n_dec + 1) - 3
    tok = torch.randint(0, full.vocab, (DECODE_BATCH, 1), generator=gen,
                        device=dev)
    pos = [at]

    def decode():
        shd.reset_collectives()
        dec(placed, {"tokens": tok, "cache": cache, "cache_len": pos[0]})
        pos[0] += 1
        return shd.collective_counts()
    counts = turns("decode_s", decode, n_dec)
    profs = {}
    for turn in ("nccl", "rank order"):
        with sums(turn):
            profs[turn] = cs.profiled(
                lambda: (decode(), torch.cuda.synchronize()),
                {"B5": cs.is_b5, "B6": cs.is_b6,
                 "NCCL": lambda k: "nccl" in k.lower()})
    say(f"[mesh-lm] {ARCH} on (1, 4), decode batch {DECODE_BATCH} at slot "
        f"{at}..{pos[0] - 1} of {slots} (median of {n_dec} after one "
        f"warm-up): {clause('decode_s', 1e3, 'ms')}; collectives a step "
        f"(rank 0): {cs.mesh_counts_line(counts)}")
    for turn, prof in profs.items():
        say(f"[mesh-lm] one decode step under torch.profiler with the sum "
            f"{'in rank order' if turn != 'nccl' else 'by NCCL'}, rank 0: "
            f"{prof}")
    if args.rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print(smi[0] if smi else "nvidia-smi: no output")
        print(json.dumps(rec))
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--store", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"bench_mesh_lm: needs {WORLD} CUDA cards", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.rank >= 0:
        return rank_main(args)
    from repro_torch.kernels import flash_attention, segment_matmul
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda build: build(), (
            segment_matmul.build, flash_attention.build,
            flash_attention.build_bwd)))
    from bench_mesh_sum import run_ranks
    # the allocator as chip_smoke.py --multi sets it for its rank processes
    env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
           **os.environ, "PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED",
                                                          "0")}
    return run_ranks(__file__, [], env)


if __name__ == "__main__":
    sys.exit(main())
