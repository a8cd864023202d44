#!/usr/bin/env python3
"""LM prefill and train step on one card through the entry points, wall
per call:

    python3 bench_lm_step.py [--src DIR] [--arch qwen2-moe-a2.7b]
                             [--layers N] [--train-layers 4] [--seq 4096]
                             [--iters 5]

The model at full width, its weights drawn from ``--seed``:
``configs.make_serve_step(spec, "prefill_32k")`` on one sequence of
``--seq`` tokens at ``--layers`` layers (default all), then
``configs.make_train_step`` on a batch of one such sequence (its labels
the next tokens) at ``--train-layers`` layers (remat, AdamW), each after
one warm-up call. Per call: the host time (its return, the device left to catch up) and
the wall with a synchronize after it (medians), and a hash of the
prefill's logits and of the parameters after the last step, so that two
versions compare bit for bit. ``--src`` imports ``repro_torch`` from
another checkout's ``src`` (an unpacked parent commit), so that two
versions compare on one card in one call. Prints one line, the card,
and last a JSON record. Needs an NVIDIA card; exits non-zero without
one.
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


def timed(fn, iters: int) -> tuple[float, float, object]:
    """Medians of ``fn()``'s host time and synchronized wall over
    ``iters`` calls after one warm-up, and the last call's result."""
    out = fn()
    host, synced = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        synced.append(time.perf_counter() - t0)
    return statistics.median(host), statistics.median(synced), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--layers", type=int, default=0,
                    help="layers of the prefill (0: the model's own)")
    ap.add_argument("--train-layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_lm_step: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch import configs
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    spec = configs.get(args.arch)
    cfg = spec.model_cfg
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layer=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = configs.init_params(spec, cfg, gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (1, args.seq), generator=gen,
                         device=dev)
    prefill = configs.make_serve_step(spec, "prefill_32k", cfg)
    pre_host, pre_wall, logits = timed(
        lambda: prefill(model, {"tokens": toks}), args.iters)
    pre_hash = hashlib.sha256(
        logits.float().cpu().numpy().tobytes()).hexdigest()[:16]
    del model, logits
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(spec.model_cfg, n_layer=args.train_layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tmodel = configs.init_params(spec, tcfg, gen, device=dev)
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    step = configs.make_train_step(spec, tcfg, opt_cfg)
    text = torch.randint(0, cfg.vocab, (1, args.seq + 1), generator=gen,
                         device=dev)
    batch = {"tokens": text[:, :-1], "labels": text[:, 1:]}
    state = adamw.init_state(dict(tmodel.named_parameters()))
    tr_host, tr_wall, (_, state, metrics) = timed(
        lambda: step(tmodel, state, batch), args.iters)
    digest = hashlib.sha256()
    for _, p in sorted(tmodel.named_parameters()):
        digest.update(p.detach().float().cpu().numpy().tobytes())
    rec = {"arch": args.arch, "layers": cfg.n_layer,
           "train_layers": tcfg.n_layer, "seq": args.seq,
           "iters": args.iters, "src": args.src,
           "prefill_host_s": pre_host, "prefill_s": pre_wall,
           "train_host_s": tr_host, "train_s": tr_wall,
           "loss": float(metrics["loss"]),
           "prefill_logits_sha256": pre_hash,
           "params_sha256": digest.hexdigest()[:16]}
    print(f"{args.arch} ({args.src}): prefill 1 x {args.seq} at "
          f"{cfg.n_layer} layers {pre_wall:.4f}s synchronized, host "
          f"{pre_host:.4f}s (medians of {args.iters}); train step at "
          f"{tcfg.n_layer} layers {tr_wall:.4f}s synchronized, host "
          f"{tr_host:.4f}s, last loss {rec['loss']:.6f}; logits sha256 "
          f"{pre_hash}, parameters after {args.iters + 1} steps sha256 "
          f"{rec['params_sha256']}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
