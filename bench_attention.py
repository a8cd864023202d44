#!/usr/bin/env python3
"""B6 (``flash_attention.flash_attention``) on the card at the LM's shapes:

    python3 bench_attention.py [--src DIR] [--only NAME ...] [--iters N]

For each case (glm4-9b's causal prefill at 4,096 and a ragged 4,000
positions, its decode over a 32,768-slot cache at batch 16, codeqwen1.5-7b's
prefill and decode, and f16 twins) the kernel is held against its plain
version (``ref.flash_attention``, within ``error_bound`` as in
chip_smoke.py) and timed beside ``scaled_dot_product_attention``
(``enable_gqa``) on the same inputs: device time with the host ahead, time
back to back and host time per call (``chip_smoke.call_times``), and the
bound (``bound_ms``). ``--src`` imports ``repro_torch`` from another
checkout's ``src`` (an unpacked parent commit), so that two versions
compare on one card in one call; a case that version does not take is
reported as such. Prints one line per case and, last, the card and a JSON
list of records. Needs an NVIDIA card; exits non-zero without one or on a
disagreement.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

#: (name, B, S, T, H, Hkv, t_real, causal, dtype): glm4-9b (32 query heads
#: over 2 kv heads of 128) and codeqwen1.5-7b (32 over 32)
CASES = [
    ("glm4 prefill S = T = 4096", 1, 4096, 4096, 32, 2, 4096, True,
     torch.bfloat16),
    ("glm4 prefill S = T = 4000", 1, 4000, 4000, 32, 2, 4000, True,
     torch.bfloat16),
    ("glm4 prefill f16", 1, 4096, 4096, 32, 2, 4096, True, torch.float16),
    ("codeqwen prefill S = T = 4096", 1, 4096, 4096, 32, 32, 4096, True,
     torch.bfloat16),
    ("glm4 decode t_real = 32768", 16, 1, 32768, 32, 2, 32768, False,
     torch.bfloat16),
    ("glm4 decode t_real = 1000", 16, 1, 32768, 32, 2, 1000, False,
     torch.bfloat16),
    ("codeqwen decode t_real = 32768", 16, 1, 32768, 32, 32, 32768, False,
     torch.bfloat16),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--only", nargs="*", default=[],
                    help="cases whose name holds one of these words")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20,
                    help="calls per timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_attention: no CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from chip_smoke import call_times
    sys.path.insert(0, args.src)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    fa.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    records = []
    for name, B, S, T, H, Hkv, t_real, causal, dt in CASES:
        if args.only and not any(w in name for w in args.only):
            continue
        dh = 128
        q = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(B, T, Hkv, dh, generator=gen, device=dev).to(dt)
                for _ in range(2))
        try:
            got = fa.flash_attention(q, k, v, causal=causal, t_real=t_real)
        except (TypeError, ValueError) as e:
            print(f"{name}: not taken by this version ({e})", flush=True)
            continue
        want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        tol = fa.error_bound(want)
        err = float(diff.max())
        worst = float((diff / tol.clamp_min(1e-30)).max())
        if not bool((diff <= tol).all()):
            raise AssertionError(f"B6 {name} disagrees with its plain version "
                                 f"(max abs err {err}, {worst} of the bound)")
        del got, want, diff, tol
        ms, kern = call_times(lambda: fa.flash_attention(
            q, k, v, causal=causal, t_real=t_real), args.iters)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x[:, :t_real].transpose(1, 2).contiguous() for x in (k, v))
        lib_ms, lib = call_times(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), args.iters)
        del qt, kt, vt
        bound = fa.bound_ms(B, S, H, Hkv, t_real, causal, dh)
        try:
            plan = fa.plan(B, S, H, Hkv, t_real, causal, dh, dt)
        except TypeError:      # a tree from before the routes: bf16 only
            plan = fa.plan(B, S, H, Hkv, t_real, causal)
        flops = 4.0 * dh * B * H * fa.attended_pairs(S, t_real, causal)
        records.append(dict(name=name, plan=str(plan), ms=ms,
                            library_ms=lib_ms, bound_ms=bound,
                            max_abs_err=err))
        print(f"{name}: q ({B}, {S}, {H}, {dh}) over k, v ({B}, {T}, {Hkv}, "
              f"{dh}), t_real {t_real}, causal {causal}, {str(dt)[6:]}; "
              f"{plan}; max abs err {err:.3e} ({worst:.3f} of the bound); "
              f"kernel {kern}; scaled_dot_product_attention {lib}; bound "
              f"{bound:.6f} ms = {bound / ms:.3f} of the kernel; "
              f"{ms / lib_ms:.3f}x SDPA; {flops / ms / 1e9:.1f} TFLOP/s",
              flush=True)
        del q, k, v
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"src": args.src, "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
