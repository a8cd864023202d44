#!/usr/bin/env python3
"""B6 (``flash_attention.flash_attention``) and its backward on the card at
the LM's shapes:

    python3 bench_attention.py [--src DIR] [--only NAME ...] [--iters N]

For each forward case (glm4-9b's causal prefill at 4,096 and a ragged 4,000
positions, its decode over a 32,768-slot cache at batch 16, codeqwen1.5-7b's
prefill and decode, dbrx-132b's prefill at G = 6, and f16 twins) the
kernel is held against its plain version (``ref.flash_attention``, within
``error_bound`` as in chip_smoke.py) and timed beside ``scaled_dot_product_attention``
(``enable_gqa``) on the same inputs: device time with the host ahead, time
back to back and host time per call (``chip_smoke.call_times``), and the
bound (``bound_ms``); where the version keeps lse (``return_lse``), the
output with lse requested must equal the one without, bit for bit. Each
backward case (glm4's causal 4,096 and 4,000 in bf16, 4,096 in f16, and
codeqwen's 4,096) runs ``flash_attention_bwd`` as the train step does,
with the forward's lse where the version keeps one, against the plain
backward (within ``bwd_error_bound``), timed beside SDPA's backward, the
five-product bound and the seven-product floor (``bwd_bound_ms``).
``--src`` imports ``repro_torch`` from another checkout's ``src`` (an
unpacked parent commit), so that two versions compare on one card in one
call; a case that version does not take is reported as such. Prints one
line per case and, last, the card and a JSON list of records. Needs an
NVIDIA card; exits non-zero without one or on a disagreement.
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
#: over 2 kv heads of 128), codeqwen1.5-7b (32 over 32) and dbrx-132b (48
#: over 8, G = 6: the mma route)
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
    ("dbrx prefill S = T = 4096", 1, 4096, 4096, 48, 8, 4096, True,
     torch.bfloat16),
]
#: (name, B, S, H, Hkv, dtype): causal backward cases at S = T
BWD_CASES = [
    ("glm4 backward S = T = 4096", 1, 4096, 32, 2, torch.bfloat16),
    ("glm4 backward S = T = 4000", 1, 4000, 32, 2, torch.bfloat16),
    ("glm4 backward f16", 1, 4096, 32, 2, torch.float16),
    ("codeqwen backward S = T = 4096", 1, 4096, 32, 32, torch.bfloat16),
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
    fa.build_bwd()
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
        same = "no lse in this version"
        if "return_lse" in fa.flash_attention.__code__.co_varnames:
            o2, _ = fa.flash_attention(q, k, v, causal=causal, t_real=t_real,
                                       return_lse=True)
            if not torch.equal(got, o2):
                raise AssertionError(f"B6 {name}: o differs with lse")
            same = "o bit-equal with lse requested"
            del o2
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
              f"{same}; "
              f"kernel {kern}; scaled_dot_product_attention {lib}; bound "
              f"{bound:.6f} ms = {bound / ms:.3f} of the kernel; "
              f"{ms / lib_ms:.3f}x SDPA; {flops / ms / 1e9:.1f} TFLOP/s",
              flush=True)
        del q, k, v
    for name, B, S, H, Hkv, dt in BWD_CASES:
        if args.only and not any(w in name for w in args.only):
            continue
        records.append(backward_case(fa, ref, call_times, gen, dev, name, B,
                                     S, H, Hkv, dt, args.iters))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"src": args.src, "records": records}))
    return 0


def backward_case(fa, ref, call_times, gen, dev, name, B, S, H, Hkv, dt,
                  iters) -> dict:
    """One causal backward case: the kernel (given the forward's lse where
    this version keeps one) against the plain backward, timed beside SDPA's
    backward, the bound and the floor; returns its record."""
    import torch.nn.functional as F

    dh = 128
    q = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dt)
    k, v = (torch.randn(B, S, Hkv, dh, generator=gen, device=dev).to(dt)
            for _ in range(2))
    do = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dt)
    keeps = "return_lse" in fa.flash_attention.__code__.co_varnames
    if keeps:
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        kw = dict(lse=lse)
    else:
        o, kw = fa.flash_attention(q, k, v, causal=True), {}
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=True, **kw)
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=True)
    scales = ref.flash_attention_bwd_scales(q, k, v, o, do, causal=True)
    torch.cuda.synchronize()
    worst, err = 0.0, 0.0
    for n, a, w in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - w.float()).abs()
        bound = fa.bwd_error_bound(w, *scales[n])
        if not bool((diff <= bound).all()):
            raise AssertionError(f"B6 backward {name}: {n} disagrees with "
                                 f"the plain version")
        worst = max(worst, float((diff / bound).max()))
        err = max(err, float(diff.max()))
    del got, want, scales
    ms, kern = call_times(lambda: fa.flash_attention_bwd(
        q, k, v, o, do, causal=True, **kw), iters)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms, lib = call_times(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters)
    del out, qt, kt, vt, dot
    bound = fa.bwd_bound_ms(B, S, H, Hkv, S, S, True, dh)
    try:
        floor = fa.bwd_bound_ms(B, S, H, Hkv, S, S, True, dh, products=7)
    except TypeError:      # a tree without the floor: the same arithmetic
        floor = 7 / 5 * bound
    try:
        plan = fa.bwd_plan(B, S, H, Hkv, S, True, dh, dt)
    except TypeError:      # a tree whose plan takes the width and dtype
        plan = fa.bwd_plan(dh, dt)
    print(f"{name}: q ({B}, {S}, {H}, {dh}) over k, v ({B}, {S}, {Hkv}, "
          f"{dh}), causal, {str(dt)[6:]}; {plan}; "
          f"{'given the forward lse' if keeps else 'lse recomputed'}; max "
          f"abs err {err:.3e} ({worst:.3f} of bwd_error_bound); kernel "
          f"{kern}; SDPA backward {lib}; {ms / lib_ms:.3f}x SDPA; bound "
          f"{bound:.6f} ms (five products) = {bound / ms:.3f} of the kernel; "
          f"floor {floor:.6f} ms (seven products) = {floor / ms:.3f}",
          flush=True)
    return dict(name=name, plan=str(plan), ms=ms, library_ms=lib_ms,
                bound_ms=bound, floor_ms=floor, max_abs_err=err)


if __name__ == "__main__":
    sys.exit(main())
