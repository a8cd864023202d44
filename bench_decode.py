#!/usr/bin/env python3
"""LM decode on one card through the serving entry point, host time and
wall per step:

    python3 bench_decode.py [--src DIR] [--arch glm4-9b] [--layers N]
                            [--batch 16] [--slots 32768] [--steps 24]

glm4-9b at full width (``--layers`` cuts its depth; default all 40), its
weights drawn from ``--seed``, a KV cache of ``--slots`` slots filled with
N(0, 1) from the seed, ``configs.make_serve_step(spec, "decode_32k")``
called at the last ``--steps`` slots of the cache after two warm-up steps.
Per step: the host time of the call (its return, the device left to
catch up), the wall back to back (one synchronize at the end) and the
wall with a synchronize after each step (medians), and a hash of the
first timed step's logits, so that two versions compare bit for bit.
``--src`` imports ``repro_torch`` from another checkout's ``src`` (an
unpacked parent commit), so that two versions compare on one card in one
call. Prints one line, the card, and last a JSON record. Needs an NVIDIA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--layers", type=int, default=0,
                    help="layers kept (0: the model's own)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--slots", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_decode: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    spec = configs.get(args.arch)
    cfg = spec.model_cfg
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layer=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = configs.init_params(spec, cfg, gen, device=dev)
    cache = tfm.init_cache(cfg, args.batch, args.slots, device=dev)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    toks = torch.randint(0, cfg.vocab, (args.batch, 1), generator=gen,
                         device=dev)
    step = configs.make_serve_step(spec, "decode_32k", cfg)
    at = args.slots - args.steps - 2

    def call(i):
        return step(model, {"tokens": toks, "cache": cache,
                            "cache_len": at + i})

    for i in range(2):
        call(i)
    torch.cuda.synchronize()
    host, synced = [], []
    t_all = time.perf_counter()
    for i in range(2, args.steps + 2):
        t0 = time.perf_counter()
        logits, _ = call(i)
        host.append(time.perf_counter() - t0)
        if i == 2:
            first = logits.clone()
    torch.cuda.synchronize()
    back = (time.perf_counter() - t_all) / args.steps
    for i in range(2, args.steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(i)
        torch.cuda.synchronize()
        synced.append(time.perf_counter() - t0)
    digest = hashlib.sha256(first.cpu().numpy().tobytes()).hexdigest()[:16]
    rec = {"arch": args.arch, "layers": cfg.n_layer, "batch": args.batch,
           "slots": args.slots, "steps": args.steps, "src": args.src,
           "host_ms": statistics.median(host) * 1e3,
           "back_to_back_ms": back * 1e3,
           "synced_ms": statistics.median(synced) * 1e3,
           "logits_sha256": digest}
    print(f"{args.arch} {cfg.n_layer} layers, decode batch {args.batch} at "
          f"slots {at + 2}..{at + args.steps + 1} of {args.slots} "
          f"(make_serve_step, {args.src}): host {rec['host_ms']:.3f} ms per "
          f"step (median), wall {rec['back_to_back_ms']:.3f} ms back to "
          f"back, {rec['synced_ms']:.3f} ms synchronized (median); first "
          f"timed step's logits sha256 {digest}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
