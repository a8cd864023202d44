#!/usr/bin/env python3
"""B5 (``segment_matmul.matmul``) on the card at the main paths' shapes:

    python3 bench_matmul.py [--src DIR] [--only NAME ...] [--iters N]

For each shape of the glm4-9b prefill (1 x 4,096 tokens) and decode (16
tokens), of the graphsage-reddit minibatch_lg forward (169,984 rows,
f32), and of the f32 products whose output has fewer tiles than the card
has SMs (the weight gradients ``a^T @ dc`` of graphsage-reddit,
meshgraphnet and MIND, qwen2-moe's router; the f32 route splits K for
them), the kernel is held against its plain version (``ref.matmul``;
1e-4 relative + 1e-6 * K, as in chip_smoke.py) and timed beside
``torch.matmul`` on the same inputs (f32 with TF32 off): device time with
the host ahead, time back to back and host time per call
(``chip_smoke.call_times``), and the bound (``bound_ms``). ``--src``
imports ``repro_torch`` from another checkout's ``src`` (an unpacked
parent commit), so that two versions compare on one card in one call.
Prints one line per shape and, last, the card and a JSON list of records.
Needs an NVIDIA card; exits non-zero without one or on a disagreement.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

#: (name, M, K, N, dtype): glm4-9b (d_model 4,096, kv width 256, d_ff
#: 13,696, vocab 151,552) and graphsage-reddit (602 -> 128 -> 128, 41);
#: then f32 products of few output tiles: graphsage-reddit's weight
#: gradients over minibatch_lg's 169,984 rows, meshgraphnet's edge MLP's
#: first weight gradient (384 x 128) over full_graph_sm's 21,504 and
#: ogb_products / 16's 7,732,736 edges, qwen2-moe's router (2,048 -> 60) at
#: a 4,096-token prefill and a 4-token decode, and MIND's S gradient over
#: 65,536 x 50 history rows
SHAPES = [
    ("prefill wq", 4096, 4096, 4096, torch.bfloat16),
    ("prefill wk", 4096, 4096, 256, torch.bfloat16),
    ("prefill ffn.wi", 4096, 4096, 13696, torch.bfloat16),
    ("prefill ffn.wo", 4096, 13696, 4096, torch.bfloat16),
    ("prefill head", 4096, 4096, 151552, torch.bfloat16),
    ("decode wq", 16, 4096, 4096, torch.bfloat16),
    ("decode wk", 16, 4096, 256, torch.bfloat16),
    ("decode ffn.wi", 16, 4096, 13696, torch.bfloat16),
    ("decode ffn.wo", 16, 13696, 4096, torch.bfloat16),
    ("decode head", 16, 4096, 151552, torch.bfloat16),
    ("gnn layer-1", 169984, 602, 128, torch.float32),
    ("gnn layer-2", 169984, 128, 128, torch.float32),
    ("gnn head", 169984, 128, 41, torch.float32),
    ("gnn dW layer-1", 602, 169984, 128, torch.float32),
    ("gnn dW layer-2", 128, 169984, 128, torch.float32),
    ("gnn dW head", 128, 169984, 41, torch.float32),
    ("mgn dW edge full_graph_sm", 384, 21504, 128, torch.float32),
    ("mgn dW edge ogb/16", 384, 7732736, 128, torch.float32),
    ("moe router prefill", 4096, 2048, 60, torch.float32),
    ("moe router decode", 4, 2048, 60, torch.float32),
    ("mind dS", 64, 3276800, 64, torch.float32),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--only", nargs="*", default=[],
                    help="shapes whose name holds one of these words")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=0,
                    help="calls per timing (default 5 for the largest "
                    "products, 20 for the rest)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_matmul: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import B5_ATOL_PER_K, B5_RTOL, call_times
    sys.path.insert(0, args.src)
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    sm.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    records = []
    for name, M, K, N, dt in SHAPES:
        if args.only and not any(w in name for w in args.only):
            continue
        a = torch.randn(M, K, generator=gen, device=dev).to(dt)
        b = (torch.randn(K, N, generator=gen, device=dev) / K ** 0.5).to(dt)
        got, want = sm.matmul(a, b), ref.matmul(a, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bool(((got - want).abs() <= B5_RTOL * want.abs()
                     + B5_ATOL_PER_K * K).all()):
            raise AssertionError(f"B5 {name} disagrees with its plain version "
                                 f"(max abs err {err})")
        del got, want
        iters = args.iters or (5 if M * N * K > 1e11 else 20)
        ms, kern = call_times(lambda: sm.matmul(a, b), iters)
        lib_ms, lib = call_times(lambda: torch.matmul(a, b), iters)
        bound = sm.bound_ms(M, N, K, dt)
        try:
            plan = sm.plan(M, N, K, dt)
        except TypeError:      # a tree from before the routes: bf16 only
            plan = sm.plan(M, N, K) if dt == torch.bfloat16 else "f32"
        records.append(dict(name=name, M=M, K=K, N=N, plan=str(plan), ms=ms,
                            library_ms=lib_ms, bound_ms=bound, max_abs_err=err))
        print(f"{name} ({M} x {K}) @ ({K} x {N}) {str(dt)[6:]}: {plan}; max "
              f"abs err {err:.3e}; kernel {kern}; torch.matmul {lib}; bound "
              f"{bound:.6f} ms = {bound / ms:.3f} of the kernel; "
              f"{ms / lib_ms:.3f}x torch.matmul; "
              f"{2.0 * M * N * K / ms / 1e9:.1f} TFLOP/s", flush=True)
        del a, b
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"src": args.src, "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
