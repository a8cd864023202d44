#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card (H100), nvcc and a C compiler; builds every
kernel of the main path from the sources in this checkout. Phases, one
result line each; any failure raises and exits non-zero:

  gpu      card name and power limit (nvidia-smi)
  build    B1 (label propagation) with nvcc for sm_90a, the host forest
           engine with cc, both started together
  index    a CollegeMsg-scale temporal graph (SNAP CollegeMsg: 1,899 users,
           59,835 messages, 193 days), generated from a seed, and its
           k-stratified PECB index built on the host
  kernel   B1 against its plain PyTorch version at (256, N) on the card:
           bit-identical int32 output; kernel, plain and bound times (the
           bound counts link bytes for the active pairs only)
  upload   the index to the card
  serve    the main path through launch.serve: mixed-k vertex queries at
           bucket 256, one edges-mode batch at bucket 16, one 64-window
           sweep, each checked against the port's Algorithm 1; B1's launch
           count over this phase must be > 0
  plain    one served batch with B1 as the loop body against the same
           batch with the plain round on the card: identical labels and
           masks; the batch's time by stage; the share of active (query,
           node) pairs; B1 and its plain version timed on that batch's
           first-round operands (the kernel record)
  profile  the same batch served once more under torch.profiler: device
           busy time, idle share, B1's share, the top kernels

Then a line of kernel records (JSON), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: SNAP CollegeMsg's published scale (users, messages, days)
COLLEGEMSG = dict(n=1899, m=59835, t_max=193, seed=7)
BUCKET = 256


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


def wall(fn):
    """(result, seconds) of ``fn`` with the card synchronised after it."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1

    from repro_torch.core import batch_query as bq
    from repro_torch.core import ecb_native
    from repro_torch.core.pecb_index import build_stratified_index
    from repro_torch.core.temporal_graph import gen_temporal_graph
    from repro_torch.kernels import label_prop, ref
    from repro_torch.launch import serve
    from repro_torch.serving import executor

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- gpu ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"[gpu] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)}")

    # -- build: every native library at once ------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        b1 = pool.submit(label_prop.build)
        host = pool.submit(ecb_native.available)
        so = b1.result()
        native = host.result()
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"[build] B1 {so.name} + host forest engine "
          f"({'native C' if native else 'Python: no C compiler'}) in "
          f"{time.perf_counter() - t0:.2f}s; ptxas: {' | '.join(ptxas)}")

    # -- index: CollegeMsg-scale graph, stratified index on the host ------
    t0 = time.perf_counter()
    g = gen_temporal_graph(**COLLEGEMSG)
    sx = build_stratified_index(g)
    t_build = time.perf_counter() - t0
    meta, arrays = bq._host_layout(sx)
    layout_mb = sum(a.nbytes for a in arrays.values()) / 1e6
    N = sx.num_nodes
    print(f"[index] n={g.n} m={g.m} t_max={g.t_max} |K|={len(sx.ks)} "
          f"(k={sx.ks[0]}..{sx.ks[-1]}) N={N} entries={sx.ent_ts.shape[0]} "
          f"vertex_entries={sx.vent_ts.shape[0]} "
          f"versions={meta['num_versions']} index_MB={layout_mb:.1f} "
          f"host_build_s={t_build:.2f}")

    # -- kernel: B1 vs its plain version at (256, N) ------------------------
    rng = np.random.default_rng(11)
    shape = (BUCKET, N)
    labels = torch.as_tensor(rng.integers(0, N + 1, shape, dtype=np.int32),
                             device=dev)
    links = [torch.as_tensor(rng.integers(-1, N, shape, dtype=np.int32),
                             device=dev) for _ in range(3)]
    active = torch.as_tensor(rng.random(shape) < 0.7, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    got = label_prop.label_prop_round(labels, *links, active, changed=flag)
    want = ref.label_prop_round(labels, *links, active)
    torch.cuda.synchronize()
    max_err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want) or got.dtype != torch.int32:
        raise AssertionError(f"B1 disagrees with its plain version "
                             f"(max abs err {max_err})")
    if bool(flag.item()) != bool((want != labels).any()):
        raise AssertionError("B1 change flag disagrees with the outputs")
    rand_ms = cuda_ms(lambda: label_prop.label_prop_round(
        labels, *links, active, changed=flag))
    rand_plain_ms = cuda_ms(lambda: ref.label_prop_round(labels, *links,
                                                         active),
                            iters=5, warmup=1)
    n_active = int(active.sum())
    rand_bound = label_prop.bound_ms(*shape, n_active)
    print(f"[kernel] B1 label_prop_round at (B, N)={shape}, random links, "
          f"active share {n_active / active.numel():.4f}: bit-identical to "
          f"the plain version (max abs err {max_err}, tolerance 0: integer "
          f"output must match exactly); kernel {rand_ms:.4f} ms, plain "
          f"{rand_plain_ms:.4f} ms, bound {rand_bound:.4f} ms (bytes: "
          f"9*B*N + 12*active at 3.35 TB/s)")
    del labels, links, active, got, want

    # -- upload ------------------------------------------------------------
    dix, t_up = wall(lambda: bq.device_index(meta, arrays, dev))
    print(f"[upload] {dix.nbytes() / 1e6:.1f} MB to {dix.device} in "
          f"{t_up:.3f}s")

    # -- serve: the main path, counted ---------------------------------------
    torch.cuda.reset_peak_memory_stats()
    label_prop.label_prop_round.launches = 0
    t0 = time.perf_counter()
    vert = serve.serve_graph(g, index=sx, dix=dix, n_queries=4 * BUCKET,
                             batch=BUCKET, mode="vertices", verify=64,
                             seed=0)
    edges = serve.serve_graph(g, index=sx, dix=dix, n_queries=16, batch=16,
                              mode="edges", verify=16, seed=1)
    k_sweep = sx.ks[len(sx.ks) // 4]
    windows = [(d, min(d + 40, g.t_max)) for d in range(1, 65)]
    sweep = serve.serve_sweep(sx, dix, 0, k_sweep, windows)
    if sweep["largest"] == 0:
        raise AssertionError("the sweep answered only empty components")
    launches = label_prop.label_prop_round.launches
    t_serve = time.perf_counter() - t0
    if launches <= 0:
        raise AssertionError("the main path launched B1 no time")
    if sum(vert["rounds"]) + sum(edges["rounds"]) + sum(sweep["rounds"]) \
            != launches:
        raise AssertionError("B1 launches do not match the rounds run")
    print(f"[serve] main path: {vert['checked']} + {edges['checked']} + "
          f"{len(windows)} answers checked, 0 mismatches; B1 launches "
          f"{launches}; vertex mode {vert['qps']:.1f} q/s "
          f"({vert['qps_steady']:.1f} after the first batch), rounds "
          f"{vert['rounds']}; edges batch {edges['batch_s'][0]:.3f}s; "
          f"phase {t_serve:.2f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- plain: the same batch with the plain round on the card --------------
    qs = [r.query for r in vert["results"][:BUCKET]]
    slots, ts, te = executor.pad_queries(
        bq.mixed_slots(sx, [(q.u, q.k) for q in qs]),
        [q.ts for q in qs], [q.te for q in qs], BUCKET)
    qs_t, ts_t, te_t = (torch.as_tensor(a, device=dev)
                        for a in (slots, ts, te))
    (e0_ok, e0c), t_entry = wall(lambda: bq._entry_nodes(
        dix, dix.vrow_ptr[qs_t], dix.vrow_ptr[qs_t + 1], ts_t, te_t))
    ops, t_links = wall(lambda: bq._resolve_links(dix, ts_t, te_t))
    (lab_k, rounds_k), t_prop = wall(lambda: bq._propagate(*ops))
    mask_k, t_members = wall(lambda: bq._members(dix, lab_k, ops[3], e0_ok,
                                                e0c))
    _, t_down = wall(lambda: mask_k.cpu().numpy())

    def plain_round(labels, l, r, p, act, *, changed):
        out = ref.label_prop_round(labels, l, r, p, act)
        if bool((out != labels).any()):
            changed.fill_(1)
        return out

    with mock.patch.object(bq, "label_prop_round", plain_round):
        (lab_p, rounds_p), t_prop_plain = wall(lambda: bq._propagate(*ops))
        mask_p = bq.batch_query(dix, qs_t, ts_t, te_t)
    if not (torch.equal(lab_k, lab_p) and rounds_k == rounds_p
            and torch.equal(mask_k, mask_p)):
        raise AssertionError("batch_query with B1 disagrees with the plain "
                             "round on the card")
    # B1 timed on the main path's own operands: the batch's first round
    active = ops[3]
    n_active = int(active.sum())
    bound = label_prop.bound_ms(BUCKET, N, n_active)
    lab0 = torch.where(active, torch.arange(N, dtype=torch.int32,
                                            device=dev)[None, :], N)
    got = label_prop.label_prop_round(lab0, *ops, changed=flag)
    want = ref.label_prop_round(lab0, *ops)
    torch.cuda.synchronize()
    max_err = max(max_err, int((got.long() - want.long()).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError("B1 disagrees with its plain version on the "
                             "main path's operands")
    ms = cuda_ms(lambda: label_prop.label_prop_round(lab0, *ops,
                                                     changed=flag))
    plain_ms = cuda_ms(lambda: ref.label_prop_round(lab0, *ops),
                       iters=5, warmup=1)
    print(f"[plain] batch of {BUCKET}: labels and masks identical with B1 "
          f"and with the plain round ({rounds_k} rounds each); stage "
          f"seconds: entry {t_entry:.4f}, links+active {t_links:.4f}, "
          f"propagation {t_prop:.4f} (plain round {t_prop_plain:.4f}), "
          f"members {t_members:.4f}, download {t_down:.4f}")
    print(f"[plain] B1 on the batch's first-round operands (active share "
          f"{n_active / active.numel():.4f}, the same in every round): "
          f"bit-identical to the plain version; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms (9*B*N + 12*active "
          f"bytes) = {bound / ms:.3f} of bound; "
          f"{label_prop.bound_ms(BUCKET, N, active.numel()) / ms:.3f} of "
          f"the all-active 21*B*N bound; {t_prop / rounds_k * 1e3:.4f} ms "
          f"per round in the loop (kernel + flag read)")

    # -- profile: one served batch under torch.profiler ---------------------
    executor.run(dix, slots, ts, te, BUCKET)            # warm
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_batch = wall(lambda: executor.run(dix, slots, ts, te, BUCKET))
    # device-side rows only: a CPU op's row repeats its kernels' time
    kern = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kern)
    b1_us = sum(t for key, t, _ in kern if "label_prop_round" in key)
    top = sorted(kern, key=lambda r: -r[1])[:5]
    busy = (f"device busy {busy_us / 1e6:.4f}s (idle share "
            f"{1 - busy_us / 1e6 / t_batch:.3f}), B1 {b1_us / 1e6:.4f}s"
            if busy_us else "device busy not measured (no device events)")
    print(f"[profile] one batch of {BUCKET}: wall {t_batch:.4f}s, {busy}; "
          f"top kernels: " + "; ".join(f"{k[:48]} {t / 1e3:.2f}ms x{c}"
                                       for k, t, c in top))

    record = {"name": "label_prop_round", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/label_prop.cu",
              "replaces": "src/repro/kernels/label_prop.py:70",
              "launches": launches, "max_abs_err": max_err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
              "library_ms": None}
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
