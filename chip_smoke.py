#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card (H100), nvcc and a C compiler; builds every
kernel of the main path from the sources in this checkout. Phases, one
result line each; any failure raises and exits non-zero:

  gpu      card name and power limit (nvidia-smi)
  build    B1 (label propagation), B2 (segmented count), the stratum
           sweep (B2 redesigned), B3 (k-core peel round), the peel
           fixpoint (B3 redesigned), B4 (segment sum and its gradient
           gather), B5 (GEMM), B6 (flash attention) and B6's backward with
           nvcc for sm_90a, the host
           forest engine with cc, all started together; each kernel's
           registers, shared memory and spills
  construct  a CollegeMsg-scale temporal graph (SNAP CollegeMsg: 1,899
           users, 59,835 messages, 193 days), generated from a seed; its 37
           core-time strata swept on the card (the device engine: one
           stratum_sweep launch per t_uv block, ceil(t_max / 256) = 1, on
           the route its size picks, and no B2 launch) and on the host
           (the fused numpy sweep): every stratum array-equal; both times,
           the probes and climbs; the build's split (pair CSR, _tuv_rows,
           upload, the kernel by CUDA events, download, host compression
           and stratification), the kernel's byte bound and serial chain
           (the longest stratum's probes); the whole build under
           torch.profiler (idle share); the kernel against its plain
           version on the card, stratum k0 alone (the old path's cost) and
           every stratum: rows, carry and counts equal; the k range
           (default_ks) peeled on the card, one kcore_fixpoint launch per
           k_max probe
  index    the k-stratified PECB index: forests built on the host from the
           card-built strata, so everything served below comes from them;
           its k_max_graph peeled on the card
  kernel   B1 against its plain PyTorch version at (256, N) on the card:
           bit-identical int32 output; kernel, plain and bound times (the
           bound counts link bytes for the active pairs only). B2 on the
           sweep's first operands (ts = 1, k = 2, c = 0), on the CSR with
           random thresholds and on random unsorted ids with -1 pads; B3a
           and B3b on the graph's 59,835 edges with random alive and on the
           peel's own first-round operands: all bit-identical to their plain
           versions; kernel, plain and library times per call (CUDA events:
           the device time with the host ahead, behind a device sleep, the
           time back to back and the host time) and the bound
  peel     the main path of B3, redesigned: ``ops.kcore_fixpoint`` on the
           card, one launch of the fixpoint kernel per k (every round on
           the card, no host read between rounds), counted: over the
           CollegeMsg graph's 17,474 distinct pairs for every k of the
           index and k_max + 1 (38 fixpoints), then over an
           sx-superuser-scale graph (SNAP sx-superuser: 194,085 users,
           1,443,339 interactions; generated from a seed): 461,605
           distinct pairs, k = 2..k_max + 1 (121 fixpoints). For each: one
           launch per fixpoint and no B3a/B3b launch; every mask
           bit-equal to the plain version on the card and every round
           count equal, in the counted run and in the timed one; each k at
           CollegeMsg scale and k in {2, k_max/4, k_max/2, k_max,
           k_max + 1} at sx-superuser scale equal to the host's distinct
           k-core; the wall of all fixpoints, each one's device time by
           CUDA events, the serial chain (the longest fixpoint's rounds)
           and the byte bound; the old path (B3a + B3b and a flag read
           per round) timed on the same operands
  baselines  the paper's comparison (Figures 4-6) at CollegeMsg scale:
           k_max on the card (kcore.k_max, one kcore_fixpoint launch per
           probe of its doubling and bisection) equal to numpy's; at 0.5,
           0.7 and 0.9 of it (bench_vary_k's shares; 0.7 is bench_paper's
           default k) edge_core_times on the card, equal to the host
           engine's, and PECB, CT-MSF and EF built from it: bytes, build
           seconds, EF's chain forests, distinct cores and enumerated core
           edges, every count equal to the reference package's; at the
           default k Borůvka's MSF as torch ops on the card at every start
           time, equal to Kruskal and to EF's stored forest (rounds, ms
           per start time); 1,000 random_queries at each k through PECB,
           CT-MSF and EF on the host (us per query) and the PECB's device
           batch on B1 in buckets of 256 (q/s), all four equal; 64 of them
           against tccs_oracle and tccs_oracle_edges on the card (one
           fixpoint launch per window) and EF's and CT-MSF's four answer
           modes; the phase's seconds, peak memory and launches
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
  epoch    the epoch planes at CollegeMsg scale through the entry points:
           epoch 0 = g.split_at(189) (bench_streaming.py's frac 0.98)
           built cold on the card, then the days 190..193 as four suffix
           epochs (extend, extend_stratified_core_times on the device
           engine, one stratum_sweep launch each, extend_stratified_index,
           refresh_device), each followed by one batch of 256 mixed-k
           vertex queries through batch_query_full_mixed on B1 (every
           fourth window ends on the newest day; 32 held to Algorithm 1,
           0 mismatches); the day-193 index equal to the cold build of the
           whole graph in every field and its mirror array for array; then
           one trim, expire_before(96) (bench_retention.py's frac 0.5),
           through the shrinks and refresh_device, equal to a cold card
           build of the trimmed graph, freeing device memory, and one more
           batch. Per epoch the edges, |K| and seconds per stage (the
           sweep with its kernel by CUDA events, the download, recompress
           + stratify, the forest extend or shrink, the refresh with its
           reused/suffix/full counts and bytes) beside the cold build's;
           the last daily epoch once more on the host engine (capped at
           30 s); the phase's launches, seconds and peak device memory
  engine   the port's serving engine (ServingEngine on the card) at
           CollegeMsg scale, bench_engine.py's settings (max_batch 256,
           flush 2 ms, no cache): the registry's cold build of epoch 0 =
           g.split_at(189) through warmup; 2,048 mixed-k specs open loop
           from 4 caller threads and at offered loads of 250 and 1,000
           q/s (q/s, e2e p50/p95/p99, batches and padded slots); 32
           straggler submissions of 3 on the host route, held to one device
           batch too; the stream twice through a 4,096-entry cache; a
           64-window sweep equal to serve.serve_sweep's; 16 EDGES/SUBGRAPH
           specs at max_batch 16 (peak device memory); the days 190..193
           ingested one at a time while a caller thread keeps serving (each
           refresh's time, p99 before and during the refreshes, answers
           from the old epoch before each swap), the day-193 handle equal
           to the cold build of g in every field; retain(96), the trimmed
           handle equal to a cold card build; the Chrome trace exported and
           loaded. 256 sampled answers of each stream held to Algorithm 1;
           B1 launches equal to the rounds the engines ran, stratum_sweep
           launches to the builds and extends; each line carries the
           card's name and power limit
  store    the disk tier at CollegeMsg scale: an engine with store_dir
           (max_batch 256, flush 2 ms, no cache) builds epoch 0 =
           g.split_at(189) cold on the card and writes it through (a full
           commit), ingests the days 190..193 (one stratum_sweep launch
           and one commit each, mode and bytes printed), retain(96),
           closes; a second engine on the same directory adopts the graph
           and promotes the stored index with no build (source disk, one
           promotion, no stratum_sweep launch; the split: open_latest with
           crc verification, from_parts, upload, beside the cold build's
           seconds), equal to a cold card build of the trimmed graph in
           every field and mirror array; 256 mixed-k random_queries(seed=9)
           through B1 with route disk, all equal to Algorithm 1; 16 EDGES
           and SUBGRAPH specs at max_batch 16; one more day ingested onto
           the promoted handle as a delta commit, equal to a cold card
           build of the grown graph; one byte of the newest segment
           flipped (the previous epoch recovered and promoted, equal to
           its cold build); every manifest deleted (warmup falls back to a
           cold build, source build); the serving CLI twice on one store
           directory (the second run, --expect-warm, promoted, 0
           mismatches); graphsage-reddit's 192,384 parameters checkpointed
           from the card (save, save_async + wait) and restored onto cuda:0
           bit-equal; the bytes on disk, commits by mode, loads,
           store_load_failures and store_commit_failures (both 0), B1
           launches equal to the engines' rounds, stratum_sweep launches
           to the builds and ingests, seconds and peak device memory
  lm       first B6's single-tile check of its wgmma route (S = Q K^T from
           TMA-loaded tiles, then P V with P in bf16 registers, against the
           plain version); then glm4-9b at full width and depth
           (9,399,951,360 parameters, bf16, drawn on the card from a seed):
           prefill of 1 x 4,096 tokens through make_serve_step(spec,
           "prefill_32k") and 8 greedy decode steps of batch 16 at the end
           of a 32,768-slot cache through make_serve_step(spec,
           "decode_32k"), each counted (B5 and B6 launch counts must be >
           0; every prefill B5 launch on the wgmma route and every B6 one
           on the wgmma route, every decode B5 launch on the skinny route
           and every B6 one on the split route); the prefill's logits
           against the same forward with the plain versions on the card; a
           16-token decode against the prefill's logits at each position;
           B5 and B6 against their plain versions at the path's shapes
           (B6 also at a ragged 4,000 positions, causal S != T, dh 64 and
           16, f16 and f32, each case with its route), timed beside their
           bounds and library yardsticks; one prefill and one decode step
           under torch.profiler (device busy, idle share, B5's and B6's
           shares); tokens/s and the model-FLOP share of 989 TFLOP/s
  lm-smoke glm4-smoke and codeqwen-smoke (2 layers, dh 16) on the card in
           bf16 and f32, and the bf16 models over an f32 KV cache: prefill
           and decode through make_serve_step, counted (B6 on the mma route
           at bf16 prefill, split at bf16 decode, f32 for f32 q), logits
           against the same steps with the plain versions and decode
           against prefill
  gnn      graphsage-reddit at full width (602 -> 128 -> 128, 41 classes,
           192,384 f32 parameters drawn on the card from a seed) serving
           8 minibatches of 1,024 seed vertices, fanout (15, 10), from a
           pool at Reddit's published scale (232,965 nodes, 114.5M directed
           edges, 602 features; generated from a seed), each padded to
           minibatch_lg's 169,984 nodes and 337,920 edges and sent through
           make_serve_step(spec, "minibatch_lg"), counted (B4 and B5 launch
           counts must be > 0, every B5 launch on the f32 route); each
           batch's logits against the same forward
           with the plain versions on the card; B4 against its plain version
           on the first batch's operands (d = 602, 128, 1) and on random
           unsorted ids with -1 and >= S entries, B5's f32 path at the
           layers' shapes, each timed beside its bound and library
           yardstick (index_add_, torch.matmul); sampling, copy and forward
           times per batch, seeds/s; one forward under torch.profiler
  train    the training path: glm4-9b at full width cut in depth (n_layer
           40 -> 8, batch 256 -> 1, one sequence of train_4k's 4,096
           tokens from launch.train's TokenStream batches at the full
           vocab, remat) through configs.make_train_step for 4 AdamW steps,
           the first counted (B5 28L + 3 launches on the wgmma route, 14L + 2
           of them gradient products; B6 2L forward on wgmma, L backward on
           wgmma from the lse the forward kept); losses finite, the first
           near ln(vocab); step seconds, tokens/s, the model-FLOP share, the
           host data time, AdamW's seconds, peak memory, one step under
           torch.profiler, the step and B6 backward's share of busy beside
           the mma backward's; B6's backward at the path's shape given the
           forward's lse against the plain backward (dq, dk, dv within
           bwd_error_bound, lse, bitwise reproducible, bit-equal with
           lse=None), timed beside its bound, floor and SDPA's, and B5's
           gradient products against their plain versions, each timed beside
           its bound and library call; a 1-layer full-width model's loss and
           every gradient against the plain versions; graphsage-reddit at
           minibatch_lg's full dims through make_batch_fn and
           make_train_step (B4 5, its gather 1, B5 13 per step), loss and
           gradients against the plain versions, steps/s, seeds/s and the
           sampler's host time, B4's gather bit-equal to its plain version
           and timed; the training CLI with --inject-failure on the card for
           both, the replayed losses equal to an uninterrupted run's (bit for
           bit for glm4; within rtol 1e-5 for GraphSAGE, whose B4 sums
           reorder under float atomics)

The card builds, ingests and trims of epoch, engine and store peel their
k ranges on the card too; a ``[kcore]`` line sums kcore_fixpoint's
launches. Then a line of kernel records (JSON), the nvidia-smi line, and
last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
#: the glm4 train step and B6's backward's share of its busy time when the
#: backward ran on the mma route (H100 80GB HBM3 at 700 W; PERF.md section
#: 6), printed beside this run's
MMA_BWD_STEP_S, MMA_BWD_SHARE = 0.4521, 0.059
#: SNAP sx-superuser's published scale (users, temporal interactions;
#: snap.stanford.edu/data/sx-superuser.html), days cut to 2,000: the
#: [peel] phase's second graph (461,605 distinct pairs, k_max 121)
SX_SUPERUSER = dict(n=194085, m=1443339, t_max=2000, seed=7)
#: ks of the sx-superuser peel checked against the host's k-core (each
#: ~0.14 s there), as shares of k_max; k_max + 1 is checked too
SX_HOST_KS = (0.0, 0.25, 0.5, 1.0)
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


def queued_ms(fn, host: float, iters: int = 20) -> float | None:
    """Device time of one call of ``fn`` in ms, host time excluded: the
    card first sleeps long enough for the host to enqueue ``iters`` calls
    (``host`` ms each, measured by :func:`host_ms`) between two CUDA
    events, so the device runs them back to back. None when the host fell
    behind the sleep all the same (the start event had completed by the
    time the last call was enqueued)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * iters * host + 1.0) * 2e6))  # ~2 GHz cycles
    start.record()
    for _ in range(iters):
        fn()
    ahead = not start.query()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if ahead else None


def host_ms(fn, iters: int = 20) -> float:
    """Host time of one call of ``fn`` in ms: ``iters`` calls enqueued back
    to back without a synchronisation (few enough that the launch queue
    does not fill), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return t * 1e3


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| of two integer or boolean tensors (0 when the
    tensors are empty)."""
    if not got.numel():
        return 0
    return int((got.long() - want.long()).abs().max())


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Raise unless ``got`` equals ``want`` exactly (dtype, shape, values);
    returns the max abs error (0)."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"(max abs err {max_abs_err(got, want)})")
    return max_abs_err(got, want)


def device_rows(prof):
    """(name, device us, count) of every CUDA kernel row of a profile:
    device rows only, since a CPU op's row repeats its kernels' time."""
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def top_rows(rows, n=5) -> str:
    return "; ".join(f"{k[:48]} {t / 1e3:.2f}ms x{c}"
                     for k, t, c in sorted(rows, key=lambda r: -r[1])[:n])


#: the [lm] phase's model, served at full width and depth, and the seed of
#: its weights, tokens and stand-in cache
LM_ARCH = "glm4-9b"
LM_SEED = 13
#: prefill 1 x LM_SEQ tokens (prefill_32k's batch and length cut by the
#: plain comparison's memory); decode LM_DECODE_BATCH sequences (decode_32k's
#: 128 cut by the cache's memory) over decode_32k's 32,768 slots, LM_STEPS
#: timed steps; decode against prefill over an LM_PREFIX-token prefix
LM_SEQ = 4096
LM_DECODE_BATCH = 16
LM_STEPS = 8
LM_PREFIX = 16
#: whole-model checks in bf16 (kernels against the plain versions, decode
#: against prefill): the largest |difference| of the two evaluations'
#: logits within this share of the largest |logit|. The two differ only in
#: summation order and in where bf16 rounds (B6 rounds P to bf16 before PV,
#: the plain version does not), and 40 layers of bf16 roundings (2^-8 each)
#: decorrelate; tests/test_torch_transformer.py holds a narrow 40-layer
#: bf16 model's decode against its prefill at this bound on the CPU.
LM_LOGIT_TOL = 5e-2
#: B6 against its plain version: elementwise within
#: flash_attention.error_bound (2e-2 of |plain| for the bf16 roundings of
#: the output, plus 1e-2 of the largest |plain| in the element's row for the
#: kernel's bf16 P). Each case prints the outputs' typical size beside it,
#: and shows that the bound rejects the plain version with the last key
#: tile left out.
#: B5 against its plain version, elementwise on f32 outputs: the same exact
#: products summed in f32 in another order, an error that grows with K
B5_RTOL = 1e-4
B5_ATOL_PER_K = 1e-6


def call_times(fn, iters: int = 20) -> tuple[float, str]:
    """(ms, clause) of one call of ``fn``: ``ms`` its device time with the
    host ahead (:func:`queued_ms`), or its time back to back where the
    host fell behind; the clause gives both and the host time."""
    ms = cuda_ms(fn, iters=iters, warmup=2)
    host = host_ms(fn, iters=iters)
    dev = queued_ms(fn, host, iters=iters)
    what = ("not measured with the host ahead (it fell behind)"
            if dev is None else f"{dev:.6f} ms on the device with the host "
            "ahead")
    return (dev or ms, f"{what}, {ms:.6f} ms per call back to back, "
            f"{host:.6f} ms of host time")


def show(times: dict) -> str:
    """One clause per function timed by :func:`call_times`."""
    return "; ".join(f"{name} {clause}" for name, (_, clause) in
                     times.items())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def top1(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of rows whose arg-max over the last axis agree."""
    return float((got.argmax(-1) == want.argmax(-1)).float().mean())


def is_b5(key: str) -> bool:
    return any(name in key for name in ("gemm_tma<", "gemm_bf16_masked(",
                                        "gemm_f32<", "splitk_reduce("))


def b5_routes(sm, want: dict, what: str) -> str:
    """Raise unless B5's launches by route (``sm.matmul.routes``) are
    ``want`` on every route; returns them as a clause."""
    got = {r: n for r, n in sm.matmul.routes.items() if n}
    if got != want:
        raise AssertionError(f"{what} launched B5 by route {got}, not {want}")
    return ", ".join(f"{n} on the {r} route" for r, n in got.items())


def ptxas_kernels(log: str) -> list[str]:
    """One 'kernel: registers, shared memory, spills' entry per kernel of a
    ``-Xptxas -v`` log."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, spills = ln.split("'")[1], ""
        elif "spill stores" in ln and name:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spills}")
            name = None
    return out


def is_b6(key: str) -> bool:
    return any(name in key for name in ("flash_wgmma<", "flash_mma<",
                                        "flash_combine<", "flash_simt<"))


def b6_routes(fa, want: dict, what: str) -> str:
    """Raise unless B6's launches by route (``fa.flash_attention.routes``)
    are ``want`` on every route; returns them as a clause."""
    got = {r: n for r, n in fa.flash_attention.routes.items() if n}
    if got != want:
        raise AssertionError(f"{what} launched B6 by route {got}, not {want}")
    return ", ".join(f"{n} on the {r} route" for r, n in got.items())


def is_b4(key: str) -> bool:
    return "segment_sum_kernel(" in key


def profiled(fn, kernels: dict, shares: dict | None = None) -> str:
    """``fn`` once under torch.profiler: wall, device busy, idle share, the
    share in the busy time of each kernel of ``kernels`` (name -> a test of
    a device row's name) with the launches the profiler recorded for it
    (it can drop records), the top device rows and the top host operations
    by their own time. ``shares``, where given, receives each kernel's
    share of busy by name."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t = wall(fn)
    rows = device_rows(prof)
    busy = sum(us for _, us, _ in rows) / 1e6
    if not busy:
        return f"wall {t:.4f}s, device busy not measured (no device events)"
    parts = []
    for name, test in kernels.items():
        secs = sum(us for k, us, _ in rows if test(k)) / 1e6
        n = sum(c for k, _, c in rows if test(k))
        if shares is not None:
            shares[name] = secs / busy
        parts.append(f"{name} {secs:.4f}s ({secs / busy:.3f} of busy, "
                     f"{n} launches recorded)")
    host = [(e.key, e.self_cpu_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    return (f"wall {t:.4f}s, device busy {busy:.4f}s (idle share "
            f"{1 - busy / t:.3f}), " + ", ".join(parts) + "; top kernels: "
            + top_rows(rows) + "; top host operations (self time, profiler "
            "on): " + top_rows(host))


def lm_phase(dev) -> list[dict]:
    """[lm]: the LM serving path on the card at full width and depth.

    The model (:data:`LM_ARCH`) is drawn on the card from :data:`LM_SEED`.
    Prefill runs ``1 x LM_SEQ`` tokens through ``make_serve_step(spec,
    "prefill_32k")``, decode ``LM_DECODE_BATCH`` sequences over
    decode_32k's cache through ``make_serve_step(spec, "decode_32k")``,
    each once with the launch counts set to 0 just before and read just
    after. Checks: the prefill's logits against the same forward with the
    plain versions on the card; an ``LM_PREFIX``-token decode against the
    prefill's logits at each position; B5 and B6 against their plain
    versions at the path's shapes. Returns the kernel records of B5 and
    B6."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import transformer as tfm

    b6_probe(dev)
    spec = configs.get(LM_ARCH)
    cfg = spec.model_cfg
    L = cfg.n_layer
    seq, batch, steps, prefix = LM_SEQ, LM_DECODE_BATCH, LM_STEPS, LM_PREFIX
    pre_dims = dict(spec.shapes["prefill_32k"], batch=1, seq=seq)
    slots = spec.shapes["decode_32k"]["seq"]
    dec_dims = dict(spec.shapes["decode_32k"], batch=batch, seq=slots)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    torch.cuda.reset_peak_memory_stats()

    model, t_init = wall(lambda: tfm.init_params(cfg, gen, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count}")
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    print(f"[lm] {LM_ARCH} at full width and depth ({L} layers, d_model "
          f"{cfg.d_model}, {cfg.n_head} query heads over {cfg.n_kv} kv heads "
          f"of {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, QKV bias "
          f"{cfg.qkv_bias}): {n_params:,} parameters, {gb:.2f} GB in "
          f"{cfg.dtype}, drawn on the card from seed {LM_SEED} in "
          f"{t_init:.2f}s")

    # -- prefill: the main path, counted ----------------------------------
    prefill = configs.make_serve_step(spec, "prefill_32k")
    toks = torch.randint(0, cfg.vocab, (1, seq), generator=gen, device=dev)
    sm.reset_counts()
    fa.reset_counts()
    logits, t_first = wall(lambda: prefill(model, {"tokens": toks}))
    b5_pre, b6_pre = sm.matmul.launches, fa.flash_attention.launches
    if (b5_pre, b6_pre) != (7 * L + 1, L):
        raise AssertionError(f"prefill launched B5 {b5_pre} and B6 {b6_pre} "
                             f"times, not {7 * L + 1} and {L}")
    routes_pre = b5_routes(sm, {"wgmma": 7 * L + 1}, "prefill")
    b6_routes_pre = b6_routes(fa, {"wgmma": L}, "prefill")
    if logits.shape != (1, seq, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite (1, S, vocab)")
    _, t_pre = wall(lambda: prefill(model, {"tokens": toks}))
    with mock.patch.object(kernel_ops, "matmul", ref.matmul), \
            mock.patch.object(kernel_ops, "flash_attention",
                              ref.flash_attention):
        plain, t_plain = wall(lambda: prefill(model, {"tokens": toks}))
    err_pre, agree_pre = rel_err(logits, plain), top1(logits, plain)
    del plain
    if not err_pre <= LM_LOGIT_TOL:
        raise AssertionError(f"prefill with the kernels differs from the "
                             f"plain versions by {err_pre} of max|logit|")
    flops_pre = configs.model_flops(spec, "prefill_32k", dims=pre_dims)
    print(f"[lm] prefill 1 x {seq} tokens through make_serve_step(spec, "
          f"'prefill_32k'): {t_pre:.4f}s = {seq / t_pre:.1f} tokens/s (first "
          f"call {t_first:.4f}s); model FLOPs {flops_pre:.4e} = "
          f"{flops_pre / t_pre / 989e12:.4f} of 989 TFLOP/s; launches B5 "
          f"{b5_pre} ({routes_pre}), B6 {b6_pre} ({b6_routes_pre}). Logits "
          f"against the same "
          f"forward with the plain versions on the card ({t_plain:.4f}s): "
          f"largest |diff| {err_pre:.4e} of max|logit| (tolerance "
          f"{LM_LOGIT_TOL}), top-1 agreement {agree_pre:.4f}")
    print(f"[lm] prefill under torch.profiler: "
          + profiled(lambda: prefill(model, {"tokens": toks}),
                     {"B5": is_b5, "B6": is_b6}))

    # -- kernels against their plain versions at the prefill's shapes ------
    p0 = model.layers[0]
    pos = torch.arange(seq, dtype=torch.int32, device=dev)[None, :]
    with torch.inference_mode():
        h = tfm.rms_norm(model.embed[toks], p0.ln1)
        q, k, v = tfm.qkv(p0, cfg, h, pos)
        act = tfm.silu(tfm.linear(h, p0.ffn.wg)) * tfm.linear(h, p0.ffn.wi)
        h = h[0]
    b5_cases = {"prefill wq": (h, p0.wq), "prefill wk": (h, p0.wk),
                "prefill ffn.wi": (h, p0.ffn.wi),
                "prefill ffn.wo": (act[0], p0.ffn.wo),
                "prefill head": (h, model.head)}
    ragged = min(4000, seq)
    b6_cases = {"prefill causal S = T": (q, k, v, True, seq),
                f"prefill causal ragged S = T = {ragged}": tuple(
                    x[:, :ragged].contiguous() for x in (q, k, v)) + (
                    True, ragged),
                f"prefill causal S = {seq} over T = {3 * seq // 4}": (
                    q, k[:, :3 * seq // 4].contiguous(),
                    v[:, :3 * seq // 4].contiguous(), True, 3 * seq // 4),
                "prefill causal f16": (q.half(), k.half(), v.half(), True,
                                       seq)}
    b6_cases.update(b6_small_cases(dev, gen))
    results = kernel_checks(b5_cases, b6_cases)
    del h, q, k, v, act, logits, b6_cases

    # -- decode ------------------------------------------------------------
    decode = configs.make_serve_step(spec, "decode_32k")
    cache = tfm.init_cache(cfg, batch, slots, device=dev)
    cache["k"].normal_(generator=gen)          # a stand-in cache from the seed
    cache["v"].normal_(generator=gen)
    cache_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    pre_toks = torch.randint(0, cfg.vocab, (batch, prefix), generator=gen,
                             device=dev)
    want = prefill(model, {"tokens": pre_toks})
    errs, agrees = [], []
    for i in range(prefix):
        step, cache = decode(model, {"tokens": pre_toks[:, i:i + 1],
                                     "cache": cache, "cache_len": i})
        errs.append(rel_err(step, want[:, i]))
        agrees.append(top1(step, want[:, i]))
    del want, step
    if not max(errs) <= LM_LOGIT_TOL:
        raise AssertionError(f"decode differs from prefill by {max(errs)} "
                             f"of max|logit|")
    print(f"[lm] decode against prefill: {batch} sequences of {prefix} "
          f"tokens decoded one by one into the {slots}-slot cache (the "
          f"other {slots - prefix} slots hold random values, masked), each "
          f"step's logits against a {batch} x {prefix} prefill's at that "
          f"position: largest |diff| {max(errs):.4e} of max|logit| "
          f"(tolerance {LM_LOGIT_TOL}; per step "
          f"{' '.join(f'{e:.2e}' for e in errs)}), top-1 agreement "
          f"{sum(agrees) / len(agrees):.4f}")

    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev)
    sm.reset_counts()
    fa.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        out, cache = decode(model, {"tokens": tok, "cache": cache,
                                    "cache_len": slots - steps + i})
        tok = out.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / steps
    b5_dec, b6_dec = sm.matmul.launches, fa.flash_attention.launches
    if (b5_dec, b6_dec) != (steps * (7 * L + 1), steps * L):
        raise AssertionError(f"decode launched B5 {b5_dec} and B6 {b6_dec} "
                             f"times")
    routes_dec = b5_routes(sm, {"skinny": steps * (7 * L + 1)}, "decode")
    b6_routes_dec = b6_routes(fa, {"split": steps * L}, "decode")
    if out.shape != (batch, cfg.vocab) or not bool(torch.isfinite(out).all()):
        raise AssertionError("decode logits are not finite (B, vocab)")
    flops_dec = configs.model_flops(spec, "decode_32k", dims=dec_dims)
    print(f"[lm] decode {batch} x 1 tokens over the {slots}-slot cache "
          f"({cache_gb:.2f} GB) through make_serve_step(spec, 'decode_32k'), "
          f"{steps} greedy steps at cache_len {slots - steps}..{slots - 1}: "
          f"{t_dec * 1e3:.3f} ms per step = {batch / t_dec:.1f} tokens/s; "
          f"model FLOPs {flops_dec:.4e} per step = "
          f"{flops_dec / t_dec / 989e12:.4f} of 989 TFLOP/s; launches B5 "
          f"{b5_dec} ({routes_dec}), B6 {b6_dec} ({b6_routes_dec}); peak "
          f"device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[lm] one decode step under torch.profiler: " + profiled(
        lambda: decode(model, {"tokens": tok, "cache": cache,
                               "cache_len": slots - 1}),
        {"B5": is_b5, "B6": is_b6}))

    # -- kernels against their plain versions at the decode's shapes -------
    pos = torch.full((batch, 1), slots - 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        h = tfm.rms_norm(model.embed[tok], p0.ln1)
        q, _, _ = tfm.qkv(p0, cfg, h, pos)
        act = tfm.silu(tfm.linear(h, p0.ffn.wg)) * tfm.linear(h, p0.ffn.wi)
        h, act = h[:, 0], act[:, 0]
    ck, cv = cache["k"][0], cache["v"][0]
    short = min(1000, slots)
    results.update(kernel_checks(
        {"decode wq": (h, p0.wq), "decode ffn.wi": (h, p0.ffn.wi),
         "decode ffn.wo": (act, p0.ffn.wo), "decode head": (h, model.head)},
        {f"decode t_real = {slots}": (q, ck, cv, False, slots),
         f"decode t_real = {short}": (q, ck, cv, False, short)}))

    csrc = "src/repro_torch/kernels/csrc/"
    b5, b6 = results["prefill ffn.wi"], results["prefill causal S = T"]
    b5_err = max(r["max_abs_err"] for r in results.values() if r["b5"])
    b6_err = max(r["max_abs_err"] for r in results.values() if not r["b5"])
    return [
        {"name": "matmul", "route": "cuda", "source": csrc + "matmul.cu",
         "replaces": "src/repro/kernels/segment_matmul.py:52",
         "launches": b5_pre + b5_dec, "max_abs_err": b5_err, "ms": b5["ms"],
         "plain_ms": b5["plain_ms"], "bound_ms": b5["bound_ms"],
         "bound_by": b5["bound_by"], "library_ms": b5["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:96",
         "launches": b6_pre + b6_dec, "max_abs_err": b6_err, "ms": b6["ms"],
         "plain_ms": b6["plain_ms"], "bound_ms": b6["bound_ms"],
         "bound_by": b6["bound_by"], "library_ms": b6["library_ms"]}]


def kernel_checks(b5_cases: dict, b6_cases: dict, tag: str = "lm") -> dict:
    """B5 ``(a, b)`` and B6 ``(q, k, v, causal, t_real)`` cases, each held
    against its plain version on the same inputs and timed beside its
    bound: the kernel's and the library call's times (:func:`call_times`)
    and the plain version's time back to back; one ``[tag]`` line per
    case. Returns each case's numbers (``ms`` and ``library_ms`` as
    :func:`call_times` gives them)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm

    out = {}
    for name, (a, b) in b5_cases.items():
        (M, K), N = a.shape, b.shape[1]
        got, want = sm.matmul(a, b), ref.matmul(a, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bool(((got - want).abs() <= B5_RTOL * want.abs()
                     + B5_ATOL_PER_K * K).all()):
            raise AssertionError(f"B5 {name} disagrees with its plain version "
                                 f"(max abs err {err})")
        del got, want
        heavy = M * N * K > 1e11
        t, kern = call_times(lambda: sm.matmul(a, b), 5 if heavy else 20)
        lib_ms, lib = call_times(lambda: torch.matmul(a, b),
                                 5 if heavy else 20)
        plain_ms = cuda_ms(lambda: ref.matmul(a, b), iters=2, warmup=1)
        bf16 = a.dtype == torch.bfloat16
        bound = sm.bound_ms(M, N, K, a.dtype)
        peak = sm.BF16_FLOP_PER_S if bf16 else sm.F32_FLOP_PER_S
        by = ("operations" if 2.0 * M * N * K / peak * 1e3 >= bound
              else "bytes")
        out[name] = dict(b5=True, max_abs_err=err, ms=t, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by)
        print(f"[{tag}] B5 {name} ({M} x {K}) @ ({K} x {N}), "
              f"{'bf16' if bf16 else 'f32'} -> f32, "
              f"{sm.plan(M, N, K, a.dtype)}: max abs err "
              f"{err:.3e} against the plain version (tolerance {B5_RTOL} "
              f"relative + {B5_ATOL_PER_K * K:.2e}); kernel {kern}; plain "
              f"{plain_ms:.4f} ms back to back; library torch.matmul "
              f"({'bf16 out' if bf16 else 'f32, TF32 off'}) {lib}; bound "
              f"{bound:.4f} ms ({by}) = {bound / t:.3f} of the kernel's "
              f"time; {2.0 * M * N * K / t / 1e9:.1f} TFLOP/s")
    for name, (q, k, v, causal, t_real) in b6_cases.items():
        B, S, H, dh = q.shape
        Hkv = k.shape[2]
        kdt = torch.float32 if q.dtype == torch.float64 else q.dtype
        p = fa.plan(B, S, H, Hkv, t_real, causal, fa.kernel_width(dh), kdt)
        route = p.route
        before = fa.flash_attention.routes[route]
        got = fa.flash_attention(q, k, v, causal=causal, t_real=t_real)
        want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
        torch.cuda.synchronize()
        if fa.flash_attention.routes[route] != before + 1:
            raise AssertionError(f"B6 {name} did not launch on the {route} "
                                 "route")
        tol = fa.error_bound(want)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        worst = float((diff / tol.clamp_min(1e-30)).max())
        if not bool((diff <= tol).all()):
            raise AssertionError(f"B6 {name} disagrees with its plain version "
                                 f"(max abs err {err}, {worst} of the bound)")
        typical = float(want.float().abs().mean())
        largest = float(want.float().abs().max())
        # the bound's reach: the plain version without its last keys
        cut_keys = fa.CHECK_CUT_KEYS
        cut = ref.flash_attention(q, k, v, causal=causal,
                                  t_real=t_real - cut_keys)
        caught = float(((cut.float() - want.float()).abs() > tol)
                       .float().mean())
        if not caught > 0:
            raise AssertionError(f"B6 {name}: the bound does not see the "
                                 f"last {cut_keys} keys left out")
        del got, want, diff, tol, cut
        t, kern = call_times(lambda: fa.flash_attention(
            q, k, v, causal=causal, t_real=t_real))
        plain_ms = cuda_ms(lambda: ref.flash_attention(
            q, k, v, causal=causal, t_real=t_real), iters=2, warmup=1)
        qt = q.transpose(1, 2).contiguous()          # (B, heads, len, dh)
        kt, vt = (x[:, :t_real].transpose(1, 2).contiguous() for x in (k, v))
        lib_ms, lib = call_times(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        del qt, kt, vt
        item = q.element_size()
        bound = fa.bound_ms(B, S, H, Hkv, t_real, causal, dh, item)
        peak = fa.F32_FLOP_PER_S if item >= 4 else fa.BF16_FLOP_PER_S
        flops = 4.0 * dh * B * H * fa.attended_pairs(S, t_real, causal)
        by = "operations" if flops / peak * 1e3 >= bound else "bytes"
        out[name] = dict(b5=False, max_abs_err=err, ms=t, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by)
        tolerance = (f"{fa.F32_TOL} of |plain| + {fa.F32_TOL}"
                     if q.dtype in (torch.float32, torch.float64) else
                     f"{fa.RTOL} of |plain| + {fa.ROW_ATOL} of its row's "
                     "largest")
        print(f"[{tag}] B6 {name}: q ({B}, {S}, {H}, {dh}) over k, v ({B}, "
              f"{k.shape[1]}, {Hkv}, {dh}), {str(q.dtype)[6:]}, t_real "
              f"{t_real}, causal {causal}, {p}: max "
              f"abs err {err:.3e} against the plain version, {worst:.3f} of "
              f"the bound ({tolerance}) at most; |plain| typically "
              f"{typical:.3e}, largest {largest:.3e}; without the last "
              f"{cut_keys} keys the plain version breaks the bound in "
              f"{caught:.3e} of the elements; kernel {kern}; plain "
              f"{plain_ms:.4f} ms back to back; library "
              f"scaled_dot_product_attention (enable_gqa) {lib}; bound "
              f"{bound:.4f} ms ({by}) = {bound / t:.3f} of the kernel's "
              f"time; {flops / t / 1e9:.1f} TFLOP/s")
    return out


def b6_probe(dev) -> None:
    """B6's single-tile check, before anything else of B6 runs: the wgmma
    route's S = Q K^T (SS wgmma from TMA-loaded, swizzled tiles) within
    f32 rounding of the plain product, and P V (P in bf16 registers, RS
    wgmma, V MN-major) within ``error_bound`` of the plain version. A
    descriptor or layout mistake shows here on one tile."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    q = torch.randn(64, 128, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(128, 128, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    s, o = fa.rs_probe(q, k, v)
    torch.cuda.synchronize()
    s_want = q.float() @ k.float().T
    s_err = float(((s - s_want).abs() / (1e-4 + 1e-5 * s_want.abs())).max())
    want = ref.flash_attention(*(x.float()[None, :, None] for x in (q, k, v)))
    tol = fa.error_bound(want.bfloat16())[0, :, 0]
    want = want[0, :, 0]
    o_err = float(((o - want).abs() / tol).max())
    if not (s_err <= 1 and o_err <= 1):
        raise AssertionError(f"B6's single-tile check failed: S at {s_err} "
                             f"and O at {o_err} of their tolerances")
    print(f"[lm] B6 single-tile check of the wgmma route (64 x 128 q, 128 "
          f"keys, dh 128, bf16): S = Q K^T max abs err "
          f"{float((s - s_want).abs().max()):.3e} (tolerance 1e-4 + 1e-5 "
          f"of |S|, {s_err:.3f} of it); O with P in bf16 registers max abs "
          f"err {float((o - want).abs().max()):.3e} ({o_err:.3f} of "
          f"error_bound)")


def b6_small_cases(dev, gen) -> dict:
    """B6 cases at small sizes for the routes and dtypes the glm4-9b path
    does not take: dh 64 (wgmma), dh 16 (mma and split), f16, f32, dh 12
    (zero-padded to 16), dh 136 and 256 (wide) and f64 (computed in f32)."""
    cases = {}
    for name, (B, S, T, H, Hkv, dh, dt, causal, t_real) in {
            "dh 64 causal": (2, 600, 600, 16, 4, 64, torch.bfloat16, True,
                             600),
            "dh 16 causal": (2, 300, 300, 4, 2, 16, torch.bfloat16, True,
                             300),
            "dh 16 decode": (4, 1, 400, 4, 2, 16, torch.bfloat16, False,
                             333),
            "f16 dh 64 decode": (4, 1, 3000, 16, 1, 64, torch.float16, False,
                                 2900),
            "f32 dh 16 causal": (2, 300, 300, 4, 2, 16, torch.float32, True,
                                 300),
            "f32 dh 128 decode": (4, 1, 2000, 32, 2, 128, torch.float32,
                                  False, 1999),
            "dh 12 causal": (2, 300, 300, 4, 2, 12, torch.bfloat16, True,
                             300),
            "dh 136 causal": (2, 300, 300, 4, 2, 136, torch.bfloat16, True,
                              300),
            "f32 dh 256 decode": (4, 1, 2000, 8, 2, 256, torch.float32,
                                  False, 1999),
            "f64 dh 64 causal": (2, 300, 300, 4, 2, 64, torch.float64, True,
                                 300)}.items():
        q = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(B, T, Hkv, dh, generator=gen, device=dev).to(dt)
                for _ in range(2))
        cases[name] = (q, k, v, causal, t_real)
    return cases


#: the [lm-smoke] phase: the smoke configs of the two dense LMs (2 layers,
#: d_model 64, dh 16; glm4-smoke GQA 2:1 with QKV bias, codeqwen-smoke MHA)
#: on the card in bf16 and f32, weights drawn from LM_SEED: prefill
#: LM_SMOKE_BATCH x LM_SMOKE_SEQ tokens, then those tokens decoded one by
#: one into an LM_SMOKE_SLOTS-slot cache (the model's dtype, and f32 under
#: a bf16 model)
LM_SMOKE_ARCHS = ("glm4-9b", "codeqwen1.5-7b")
LM_SMOKE_BATCH, LM_SMOKE_SEQ, LM_SMOKE_SLOTS = 4, 96, 160
#: f32 logits (kernels against plain versions, decode against prefill):
#: elementwise within this relative plus absolute tolerance, the f32 bound
#: of tests/test_torch_transformer.py
LM_SMOKE_F32_TOL = 2e-3


def logits_err(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """The share of its tolerance the largest logit difference takes: bf16
    against LM_LOGIT_TOL of max|logit|, f32 elementwise against
    LM_SMOKE_F32_TOL relative plus absolute. At most 1 passes."""
    if dtype == torch.float32:
        d = (got.float() - want.float()).abs()
        return float((d / (LM_SMOKE_F32_TOL * (1 + want.float().abs())))
                     .max())
    return rel_err(got, want) / LM_LOGIT_TOL


def lm_smoke_phase(dev) -> tuple[int, int]:
    """[lm-smoke]: the smoke LMs on the card through B5 and B6, each run
    counted (B5 7L + 1 launches a forward or step; B6 L, on the route its
    dtype and head width give), against the same steps with the plain
    versions, decode against prefill. Returns the phase's B5 and B6
    launches."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import transformer as tfm

    B, S, slots = LM_SMOKE_BATCH, LM_SMOKE_SEQ, LM_SMOKE_SLOTS
    plain_ops = (mock.patch.object(kernel_ops, "matmul", ref.matmul),
                 mock.patch.object(kernel_ops, "flash_attention",
                                   ref.flash_attention))
    n5 = n6 = 0
    for arch in LM_SMOKE_ARCHS:
        spec = configs.get(arch)
        for dt in (torch.bfloat16, torch.float32):
            cfg = dataclasses.replace(spec.smoke_cfg, dtype=dt)
            L = cfg.n_layer
            gen = torch.Generator(device=dev).manual_seed(LM_SEED)
            model = tfm.init_params(cfg, gen, device=dev)
            prefill = configs.make_serve_step(spec, "prefill_32k", cfg)
            decode = configs.make_serve_step(spec, "decode_32k", cfg)
            toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                 device=dev)
            attn = "f32" if dt == torch.float32 else "mma"
            sm.reset_counts()
            fa.reset_counts()
            logits = prefill(model, {"tokens": toks})
            torch.cuda.synchronize()
            if sm.matmul.launches != 7 * L + 1:
                raise AssertionError(f"{cfg.name} prefill launched B5 "
                                     f"{sm.matmul.launches} times")
            b6 = b6_routes(fa, {attn: L}, f"{cfg.name} prefill")
            n5, n6 = n5 + sm.matmul.launches, n6 + L
            with plain_ops[0], plain_ops[1]:
                plain = prefill(model, {"tokens": toks})
            e_pre = logits_err(logits, plain, dt)
            if not e_pre <= 1:
                raise AssertionError(f"{cfg.name} prefill with the kernels "
                                     f"differs from the plain versions "
                                     f"({e_pre} of the tolerance)")
            what = [f"prefill {B} x {S} ({b6}) against the plain versions "
                    f"{e_pre:.3f} of the tolerance"]
            for cdt in ((dt, torch.float32) if dt == torch.bfloat16
                        else (dt,)):
                cache = tfm.init_cache(cfg, B, slots, dtype=cdt, device=dev)
                cache["k"].normal_(generator=gen)    # masked slots
                cache["v"].normal_(generator=gen)
                plain_cache = {n: c.clone() for n, c in cache.items()}
                sm.reset_counts()
                fa.reset_counts()
                steps = [decode(model, {"tokens": toks[:, i:i + 1],
                                        "cache": cache, "cache_len": i})[0]
                         for i in range(S)]
                torch.cuda.synchronize()
                if sm.matmul.launches != S * (7 * L + 1):
                    raise AssertionError(f"{cfg.name} decode launched B5 "
                                         f"{sm.matmul.launches} times")
                route = "f32" if cdt == torch.float32 else "split"
                b6 = b6_routes(fa, {route: S * L}, f"{cfg.name} decode")
                b5 = ", ".join(f"{n} {r}" for r, n in
                               sm.matmul.routes.items() if n)
                n5, n6 = n5 + sm.matmul.launches, n6 + S * L
                with plain_ops[0], plain_ops[1]:
                    plain = [decode(model, {"tokens": toks[:, i:i + 1],
                                            "cache": plain_cache,
                                            "cache_len": i})[0]
                             for i in range(S)]
                e_plain = max(logits_err(a, b, dt)
                              for a, b in zip(steps, plain))
                e_pre = max(logits_err(steps[i], logits[:, i], dt)
                            for i in range(S))
                if not (e_plain <= 1 and e_pre <= 1):
                    raise AssertionError(
                        f"{cfg.name} decode over a {cdt} cache: "
                        f"{e_plain} (plain versions) and {e_pre} (prefill) "
                        f"of the tolerance")
                what.append(f"decode of those {S} tokens over a {slots}-slot "
                            f"{str(cdt)[6:]} cache (B5 {b5}; B6 {b6}) "
                            f"against the plain versions {e_plain:.3f} and "
                            f"against prefill {e_pre:.3f} of the tolerance")
            tol = (f"{LM_SMOKE_F32_TOL} relative + absolute"
                   if dt == torch.float32 else
                   f"{LM_LOGIT_TOL} of max|logit|")
            print(f"[lm-smoke] {cfg.name} ({L} layers, d_model "
                  f"{cfg.d_model}, {cfg.n_head} query heads over {cfg.n_kv} "
                  f"kv heads of {cfg.d_head}) in {str(dt)[6:]}, tolerance "
                  f"{tol}: " + "; ".join(what))
    return n5, n6


#: the [gnn] phase: graphsage-reddit at full width on minibatch_lg's static
#: shape (its seeds, fanout and padding), GNN_BATCHES minibatches, over a
#: pool at Reddit's published scale: random_powerlaw_graph(232,965,
#: GNN_AVG_DEG) keeps 114.5M of its 114.6M directed edges (self-loops
#: dropped; Reddit has 114,615,892). Pool, features, labels, seeds and
#: weights come from GNN_SEED.
GNN_ARCH = "graphsage-reddit"
GNN_SHAPE = "minibatch_lg"
GNN_SEED = 17
GNN_BATCHES = 8
GNN_AVG_DEG = 492
#: B4 against its plain version, elementwise: rtol = atol = 1e-4
#: (tests/test_kernels.py's segment-sum tolerance: the same f32 rows added
#: in another order). A forward with the kernels against the same forward
#: with the plain versions: the largest |difference| within this share of
#: the largest |logit| (f32 throughout; two layers of f32 sums reordered).
B4_TOL = 1e-4
GNN_LOGIT_TOL = 1e-4


def b4_checks(cases: dict) -> dict:
    """B4 ``(vals, ids, S)`` cases, each held against its plain version on
    the same inputs (rtol = atol = :data:`B4_TOL`) and, for ids all in
    range (the path's), timed beside its bound, its plain version and the
    library call ``torch.zeros(S, d).index_add_(0, ids, vals)``; one
    ``[gnn]`` line per case. Returns each case's numbers."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm

    out = {}
    for name, (vals, ids, S) in cases.items():
        (E, d), dev = vals.shape, vals.device
        got, want = sm.segment_sum(vals, ids, S), ref.segment_sum(vals, ids, S)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        if not bool((diff <= B4_TOL + B4_TOL * want.abs()).all()):
            raise AssertionError(f"B4 {name} disagrees with its plain version "
                                 f"(max abs err {err})")
        in_range = bool(((ids >= 0) & (ids < S)).all())
        del got, want, diff
        bound = sm.segment_sum_bound_ms(E, d, S)
        line = (f"[gnn] B4 {name}: ({E} x {d}) into {S} segments: max abs "
                f"err {err:.3e} against the plain version (tolerance "
                f"{B4_TOL} + {B4_TOL} of |plain|)")
        rec = dict(max_abs_err=err, bound_ms=bound)
        if in_range:
            t, kern = call_times(lambda: sm.segment_sum(vals, ids, S))
            plain_ms = cuda_ms(lambda: ref.segment_sum(vals, ids, S),
                               iters=5, warmup=1)
            lib_ms, lib = call_times(lambda: torch.zeros(
                (S, d), device=dev).index_add_(0, ids, vals))
            rec.update(ms=t, plain_ms=plain_ms, library_ms=lib_ms)
            line += (f"; kernel {kern}; plain {plain_ms:.6f} ms back to "
                     f"back; library torch.zeros(S, d).index_add_ {lib}; "
                     f"bound {bound:.6f} ms (bytes: 4*E*d + 4*E + 4*S*d at "
                     f"3.35 TB/s) = {bound / t:.3f} of the kernel's time")
        out[name] = rec
        print(line)
    return out


def gnn_phase(dev) -> tuple[dict, int, float]:
    """[gnn]: GraphSAGE serving on the card at full width.

    Builds the pool on the host, draws the model on the card, then serves
    :data:`GNN_BATCHES` sampled minibatches through
    ``make_serve_step(spec, GNN_SHAPE)`` with the launch counts set to 0
    just before and read just after; each batch's logits are held against
    the same forward with the plain versions on the card. Then B4 and B5's
    f32 path against their plain versions at the path's shapes, a profiled
    forward and the peak device memory. Returns B4's kernel record, B5's
    launches in this phase's main path and B5's largest error here."""
    from repro_torch import configs
    from repro_torch.data import graph_sampler as gs
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import gnn

    spec = configs.get(GNN_ARCH)
    dims = spec.shapes[GNN_SHAPE]
    cfg = configs.cell_model_cfg(spec, GNN_SHAPE)
    n_pool, n_pad = dims["pool_nodes"], dims["n"]
    e_pad = int(np.ceil(2 * dims["e"] / 512)) * 512     # directed, padded
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    src, dst = gs.random_powerlaw_graph(n_pool, GNN_AVG_DEG, seed=GNN_SEED)
    t_gen = time.perf_counter() - t0
    rng = np.random.default_rng(GNN_SEED)
    feats = rng.standard_normal((n_pool, dims["d_feat"]), dtype=np.float32)
    labels = rng.integers(0, cfg.n_classes, n_pool).astype(np.int32)
    t0 = time.perf_counter()
    g = gs.CSRGraph(n_pool, src, dst)
    t_csr = time.perf_counter() - t0
    n_edges = int(src.shape[0])
    del src, dst
    print(f"[gnn] pool at Reddit's published scale: {n_pool:,} nodes, "
          f"{n_edges:,} directed edges (random_powerlaw_graph(n, "
          f"{GNN_AVG_DEG}), seed {GNN_SEED}; Reddit has "
          f"{dims['pool_edges']:,}), {dims['d_feat']} N(0, 1) f32 features "
          f"and {cfg.n_classes} labels per node; generated in {t_gen:.2f}s, "
          f"CSR built in {t_csr:.2f}s on the host")

    gen = torch.Generator(device=dev).manual_seed(GNN_SEED)
    model = gnn.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count}")
    print(f"[gnn] {GNN_ARCH} at full width ({cfg.n_layers} layers, d_in "
          f"{cfg.d_in}, hidden {cfg.d_hidden}, {cfg.n_classes} classes): "
          f"{n_params:,} f32 parameters drawn on the card from seed "
          f"{GNN_SEED}")

    # -- the main path: GNN_BATCHES minibatches, counted -------------------
    serve = configs.make_serve_step(spec, GNN_SHAPE)
    keys = ("node_feat", "src", "dst", "edge_mask", "seed_mask")
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain versions' f32
    sm.reset_counts()
    sm.segment_sum.launches = 0
    stats, first = [], None
    for i in range(GNN_BATCHES):
        seeds = rng.choice(n_pool, dims["seeds"], replace=False)
        t0 = time.perf_counter()
        batch = gs.sample_subgraph_batch(g, feats, labels, seeds,
                                         dims["fanout"], rng,
                                         pad_nodes=n_pad, pad_edges=e_pad)
        t_sample = time.perf_counter() - t0
        feed, t_copy = wall(lambda: {k: torch.as_tensor(batch[k]).to(dev)
                                     for k in keys})
        logits, t_fwd = wall(lambda: serve(model, feed))
        seed_logits = logits[feed["seed_mask"]]
        answer = seed_logits.argmax(-1)
        if logits.shape != (n_pad, cfg.n_classes) or not bool(
                torch.isfinite(logits).all()) or answer.shape != (
                dims["seeds"],):
            raise AssertionError(f"batch {i}: logits are not finite "
                                 f"({n_pad}, {cfg.n_classes})")
        with mock.patch.object(kernel_ops, "segment_sum", ref.segment_sum), \
                mock.patch.object(kernel_ops, "matmul", ref.matmul):
            plain = serve(model, feed)
        err = rel_err(logits, plain)
        agree = top1(seed_logits, plain[feed["seed_mask"]])
        if not err <= GNN_LOGIT_TOL:
            raise AssertionError(f"batch {i}: the forward with the kernels "
                                 f"differs from the plain versions by {err} "
                                 f"of max|logit|")
        stats.append(dict(sample=t_sample, copy=t_copy, fwd=t_fwd, err=err,
                          agree=agree, edges=int(batch["edge_mask"].sum())))
        if first is None:
            first = feed
        del logits, plain, batch
    b4_n, b5_n = sm.segment_sum.launches, sm.matmul.launches
    if b4_n <= 0 or b5_n <= 0:
        raise AssertionError("the GNN path launched B4 or B5 no time")
    if (b4_n, b5_n) != (2 * cfg.n_layers * GNN_BATCHES,
                        (2 * cfg.n_layers + 1) * GNN_BATCHES):
        raise AssertionError(f"{GNN_BATCHES} forwards launched B4 {b4_n} and "
                             f"B5 {b5_n} times")
    routes_gnn = b5_routes(sm, {"f32": b5_n}, "the GNN path")
    seeds_n = dims["seeds"]
    steady = stats[1:] or stats
    fwd = sum(r["fwd"] for r in steady) / len(steady)
    e2e = sum(r["sample"] + r["copy"] + r["fwd"] for r in steady) / len(steady)
    flops = configs.model_flops(spec, GNN_SHAPE, dims=dict(dims,
                                                           kind="serve"))
    for i, r in enumerate(stats):
        print(f"[gnn] batch {i}: {seeds_n} seeds, {r['edges']:,} real of "
              f"{e_pad:,} edges; sampling {r['sample']:.4f}s on the host, "
              f"copy to the card {r['copy'] * 1e3:.3f} ms, forward "
              f"{r['fwd'] * 1e3:.3f} ms; logits within {r['err']:.3e} of "
              f"max|logit| of the plain versions' (tolerance "
              f"{GNN_LOGIT_TOL}), seeds' top-1 agreement {r['agree']:.4f}")
    print(f"[gnn] main path: {GNN_BATCHES} minibatches through "
          f"make_serve_step(spec, '{GNN_SHAPE}') at ({n_pad:,} nodes, "
          f"{e_pad:,} edges); launches B4 {b4_n}, B5 {b5_n} ({routes_gnn}); "
          f"after the first "
          f"batch: forward {fwd * 1e3:.3f} ms = {seeds_n / fwd:.1f} seeds/s "
          f"on the card, {e2e:.4f}s per batch with sampling and copy = "
          f"{seeds_n / e2e:.1f} seeds/s end to end; model FLOPs "
          f"{flops:.4e} per forward = {flops / fwd / 67e12:.4f} of the "
          f"67 TFLOP/s f32 peak")
    print(f"[gnn] one forward under torch.profiler: " + profiled(
        lambda: serve(model, first), {"B4": is_b4, "B5": is_b5}))

    # -- B4 and B5 against their plain versions at the path's shapes ------
    x0, src0, dst0, mask0 = (first[k] for k in ("node_feat", "src", "dst",
                                                "edge_mask"))
    with torch.inference_mode():
        h1 = gnn.sage_layer(model.layers[0], x0, src0, dst0, mask0)
        h2 = gnn.sage_layer(model.layers[1], h1, src0, dst0, mask0)
        agg1 = x0[src0] * mask0[:, None]
        agg2 = h1[src0] * mask0[:, None]
    ids = rng.integers(0, n_pad, e_pad)
    u = rng.random(e_pad)
    ids[u < 0.1] = -1
    ids[(u >= 0.1) & (u < 0.15)] = n_pad + 7
    rand_ids = torch.as_tensor(ids.astype(np.int32), device=dev)
    rand_vals = torch.randn(e_pad, dims["d_feat"], generator=gen, device=dev)
    b4 = b4_checks({
        "layer-1 neighbour sum (d = 602)": (agg1, dst0, n_pad),
        "layer-2 neighbour sum (d = 128)": (agg2, dst0, n_pad),
        "degree count (d = 1)": (mask0[:, None], dst0, n_pad),
        "random unsorted ids, 10% -1, 5% >= S (d = 602)": (
            rand_vals, rand_ids, n_pad)})
    del agg1, agg2, rand_vals
    b5 = kernel_checks({"layer-1 w_self": (x0, model.layers[0].w_self),
                        "layer-2 w_self": (h1, model.layers[1].w_self),
                        "head": (h2, model.head)}, {}, tag="gnn")
    # a forward's device time, and the kernels' share of it from the
    # per-call times above (the profiler can drop records)
    fwd_dev, fwd_clause = call_times(lambda: serve(model, first), iters=10)
    b4_ms = (b4["layer-1 neighbour sum (d = 602)"]["ms"]
             + b4["layer-2 neighbour sum (d = 128)"]["ms"]
             + 2 * b4["degree count (d = 1)"]["ms"])
    b5_ms = (2 * b5["layer-1 w_self"]["ms"] + 2 * b5["layer-2 w_self"]["ms"]
             + b5["head"]["ms"])
    print(f"[gnn] one forward on the first batch: {fwd_clause}; its 4 B4 "
          f"calls take {b4_ms:.6f} ms ({b4_ms / fwd_dev:.3f} of the device "
          f"time) and its 5 B5 calls {b5_ms:.6f} ms ({b5_ms / fwd_dev:.3f}) "
          f"by the per-call times above; served, the forward took "
          f"{fwd * 1e3:.3f} ms of wall: idle share "
          f"{1 - fwd_dev / (fwd * 1e3):.3f}")
    print(f"[gnn] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f}s")

    main = b4["layer-1 neighbour sum (d = 602)"]
    record = {"name": "segment_sum", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
              "replaces": "src/repro/kernels/segment_matmul.py:104",
              "launches": b4_n,
              "max_abs_err": max(r["max_abs_err"] for r in b4.values()),
              "ms": main["ms"], "plain_ms": main["plain_ms"],
              "bound_ms": main["bound_ms"], "bound_by": "bytes",
              "library_ms": main["library_ms"]}
    return record, b5_n, max(r["max_abs_err"] for r in b5.values())


#: the [train] phase: glm4-9b at full width cut in depth to TRAIN_LAYERS of
#: its 40 layers (one card's memory: the reference's f32 moments make 40
#: layers 112.8 GB of state alone) on train_4k's sequence of TRAIN_SEQ
#: tokens, batch TRAIN_BATCH of its 256, TRAIN_STEPS steps (the first
#: counted, the rest timed); the plain comparison on a 1-layer model of the
#: same width (the plain attention's (32, 4,096, 4,096) f32 scores fit)
TRAIN_ARCH = "glm4-9b"
TRAIN_LAYERS = 8
TRAIN_SEQ, TRAIN_BATCH = 4096, 1
TRAIN_STEPS = 4
TRAIN_SEED = 19
#: bf16 gradients, kernels against the plain versions: each leaf within this
#: share of its largest |plain gradient| (PERF.md section 2's bf16 logits
#: bound), the loss within TRAIN_LOSS_TOL of itself. The key bias's gradient
#: sums the positions' key gradients, which nearly cancel (before RoPE a
#: row's key gradients sum to zero), so it is held to the scale its
#: per-position errors add up to: the same layer's wk gradient's
TRAIN_GRAD_TOL = 5e-2
TRAIN_LOSS_TOL = 1e-2
#: f32 GraphSAGE gradients: within this share of each leaf's largest
GNN_GRAD_TOL = 1e-4
#: the restart check: the --smoke CLI for RESTART_STEPS steps, a checkpoint
#: every RESTART_EVERY, a failure injected at RESTART_FAIL
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 6, 2, 3


def grad_leaf_errs(got: dict, want: dict) -> dict:
    """Each gradient's largest |kernel - plain| over the largest |plain| of
    its scale leaf (the key bias takes wk's: see TRAIN_GRAD_TOL)."""
    out = {}
    for name, g in got.items():
        scale_of = name.replace(".bk", ".wk") if name.endswith(".bk") else name
        scale = float(want[scale_of].float().abs().max())
        out[name] = float((g.float() - want[name].float()).abs().max()) / max(
            scale, 1e-30)
    return out


class ReluPattern:
    """One run's relu pattern, replayed on another run. GraphSAGE's relu
    has a kink at 0. The kernels and the plain versions sum in other
    orders, and the float atomics of B4 and of ``index_add_`` change the
    order from run to run, so a pre-activation within the f32 rounding of
    0 can take one sign in one run and the other in the next. Both
    gradients are then right, and differ by that entry's whole term: at
    graphsage-reddit's minibatch_lg such a flip put layers.1.w_self's
    gradient 1.06e-2 of its scale off the plain one's (H100 80GB HBM3,
    700 W), where the gradients otherwise agree within 7e-6. ``record`` is relu that keeps each call's input; ``replay``
    multiplies the n-th call's input by the n-th kept input's mask
    (> 0), so the second run differentiates the same piece of the
    function as the first. It counts in ``flips`` the entries whose own
    sign disagreed, and keeps the kept inputs' least nonzero |value|
    (``nearest``) and the two runs' largest difference (``gap``)."""

    def __init__(self):
        self.inputs, self.flips, self.entries = [], 0, 0
        self.nearest, self.gap = float("inf"), 0.0
        self._relu, self._next = torch.relu, 0

    def record(self, x: torch.Tensor) -> torch.Tensor:
        self.inputs.append(x.detach().clone())
        return self._relu(x)

    def replay(self, x: torch.Tensor) -> torch.Tensor:
        kept = self.inputs[self._next]
        self._next += 1
        mask = kept > 0
        self.flips += int(((x.detach() > 0) != mask).sum())
        self.entries += mask.numel()
        nonzero = kept[kept != 0]
        if nonzero.numel():
            self.nearest = min(self.nearest, float(nonzero.abs().min()))
        self.gap = max(self.gap, float((x.detach() - kept).abs().max()))
        return x * mask


def plain_ops():
    """Patches that put the plain versions in the models' kernel calls (the
    differentiable ops of kernels/ops.py): autograd then runs through plain
    PyTorch."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    return [mock.patch.object(kernel_ops, "matmul", ref.matmul),
            mock.patch.object(kernel_ops, "flash_attention",
                              ref.flash_attention),
            mock.patch.object(kernel_ops, "segment_sum", ref.segment_sum),
            mock.patch.object(kernel_ops, "gather_rows",
                              lambda x, idx: x[idx.long()])]


def loss_and_grads(spec, cfg, model, batch, plain: bool = False,
                   relu=None):
    """(loss, {name: gradient}) of one batch, with the kernels or, with
    ``plain``, the plain versions; ``relu``, where given, stands in for
    ``torch.relu`` during the call (see :class:`ReluPattern`)."""
    from repro_torch import configs
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    with contextlib.ExitStack() as stack:
        for patch in plain_ops() if plain else ():
            stack.enter_context(patch)
        if relu is not None:
            stack.enter_context(mock.patch.object(torch, "relu", relu))
        loss = configs.loss_for(spec, cfg)(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def b6_bwd_check(q, k, v, causal: bool, smi: str) -> dict:
    """B6's backward against the plain backward on the same inputs (``do``
    drawn from a seed), given the forward's lse as the train step gives it:
    dq, dk and dv within ``bwd_error_bound``, lse within 1e-4, bitwise
    reproducible, and bit-equal with ``lse=None`` (which takes lse from one
    more counted forward launch); timed beside its bound (five products),
    the routes' seven-product floor, the plain version and the library call
    (scaled_dot_product_attention's backward with enable_gqa, its forward
    run once outside the timing)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    gen = torch.Generator(device=q.device).manual_seed(TRAIN_SEED)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    plan = fa.bwd_plan(B, S, H, Hkv, T, causal, dh, q.dtype)
    before = fa.flash_attention_bwd.routes[plan.route]
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    if fa.flash_attention_bwd.routes[plan.route] != before + 1:
        raise AssertionError(f"B6's backward did not launch on its "
                             f"{plan.route} route")
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal)
    scales = ref.flash_attention_bwd_scales(q, k, v, o, do, causal=causal)
    worst, err = {}, 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - w.float()).abs()
        bound = fa.bwd_error_bound(w, *scales[name])
        worst[name] = float((diff / bound).max())
        err = max(err, float(diff.max()))
        if not bool((diff <= bound).all()):
            raise AssertionError(f"B6's backward: {name} disagrees with the "
                                 f"plain version ({worst[name]} of the bound)")
    lse_err = float((got[3] - want[3].float()).abs().max())
    if not lse_err <= 1e-4:
        raise AssertionError(f"B6's backward: lse off by {lse_err}")
    again = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("B6's backward is not bitwise reproducible")
    fwd = fa.flash_attention.launches
    own = fa.flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    if fa.flash_attention.launches != fwd + 1 or not all(
            torch.equal(a, b) for a, b in zip(got, own)):
        raise AssertionError("B6's backward with lse=None did not take lse "
                             "from one forward launch, bit-equal")
    del got, want, scales, again, own
    t, kern = call_times(lambda: fa.flash_attention_bwd(
        q, k, v, o, do, causal=causal, lse=lse), iters=10)
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd(
        q, k, v, o, do, causal=causal), iters=1, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms, lib = call_times(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    del out, qt, kt, vt, dot
    size = q.element_size()
    bound = fa.bwd_bound_ms(B, S, H, Hkv, T, T, causal, dh, size)
    floor = fa.bwd_bound_ms(B, S, H, Hkv, T, T, causal, dh, size, products=7)
    print(f"[train] B6 backward at the path's shape: q ({B}, {S}, {H}, {dh}) "
          f"over k, v ({B}, {T}, {Hkv}, {dh}), {str(q.dtype)[6:]}, causal "
          f"{causal}, {plan}: dq, dk, dv at {worst['dq']:.3f}, "
          f"{worst['dk']:.3f}, {worst['dv']:.3f} of bwd_error_bound at most "
          f"(max abs err {err:.3e}), lse (the forward's) within {lse_err:.2e} "
          f"of the plain one, bitwise reproducible, bit-equal with lse=None "
          f"(one forward launch); kernel {kern}; plain {plain_ms:.4f} ms back "
          f"to back; library scaled_dot_product_attention backward "
          f"(enable_gqa) {lib}; {t / lib_ms:.3f}x the library's time; bound "
          f"{bound:.4f} ms (operations: five products of the attended pairs "
          f"at 989 TFLOP/s) = {bound / t:.3f} of the kernel's time; the "
          f"routes' floor (seven products) {floor:.4f} ms = {floor / t:.3f} "
          f"| {smi}")
    return dict(max_abs_err=err, ms=t, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by="operations", kernel_route=plan.route,
                floor_ms=floor)


def b4_gather_check(dout, ids, what: str, smi: str) -> dict:
    """B4's gradient gather against its plain version, bit for bit, and
    timed beside its bound, the plain version and the library call
    ``dout.index_select(0, ids)`` (every id of a sampled batch is in range,
    so no clamp is needed there)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm

    got = sm.segment_gather(dout, ids)
    want = ref.segment_gather(dout, ids, torch.float32)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"B4's gather ({what}) differs from its plain "
                             f"version (max abs err {err})")
    del got, want
    E, d = ids.shape[0], dout.shape[1]
    if not bool(((ids >= 0) & (ids < dout.shape[0])).all()):
        raise AssertionError("the path's ids lie outside [0, S)")
    idl = ids.long()
    t, kern = call_times(lambda: sm.segment_gather(dout, ids))
    plain_ms = cuda_ms(lambda: ref.segment_gather(dout, ids, torch.float32),
                       iters=5, warmup=1)
    lib_ms, lib = call_times(lambda: dout.index_select(0, idl))
    rows = int(torch.unique(ids).numel())
    bound = sm.segment_gather_bound_ms(E, d, rows)
    print(f"[train] B4 gather {what}: ({dout.shape[0]} x {d}) rows gathered "
          f"by {E} ids ({rows} distinct): bit-equal to the plain version; "
          f"kernel {kern}; plain {plain_ms:.6f} ms back to back; library "
          f"index_select {lib}; bound {bound:.6f} ms (bytes: 4*rows*d + 4*E "
          f"+ 4*E*d at 3.35 TB/s) = {bound / t:.3f} of the kernel's time | "
          f"{smi}")
    return dict(max_abs_err=err, ms=t, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by="bytes")


def restart_check(arch: str, dev, smi: str) -> bool:
    """The training CLI (``--smoke``, on the card) with a checkpoint every
    RESTART_EVERY steps and a failure injected at RESTART_FAIL, against an
    uninterrupted run: the replayed steps' losses must equal the
    uninterrupted ones bit for bit where every kernel of the path is
    deterministic (the LM), within rtol 1e-5 where B4's float atomics
    reorder sums (GraphSAGE). Returns whether they were bit-equal."""
    from repro_torch.launch import train as train_cli

    base = ["--arch", arch, "--smoke", "--steps", str(RESTART_STEPS),
            "--log-every", str(10 * RESTART_STEPS), "--device", str(dev)]
    with contextlib.redirect_stdout(sys.stderr):
        clean = train_cli.main(base)
        with tempfile.TemporaryDirectory() as d:
            replayed = train_cli.main(base + [
                "--ckpt-dir", d, "--ckpt-every", str(RESTART_EVERY),
                "--inject-failure", str(RESTART_FAIL)])
    back = (RESTART_FAIL // RESTART_EVERY) * RESTART_EVERY
    want = clean[:RESTART_FAIL] + clean[back:]
    if len(replayed) != len(want) or not all(np.isfinite(replayed)):
        raise AssertionError(f"{arch}: the restarted run gave {replayed}")
    exact = replayed == want
    if arch.startswith("graphsage"):
        np.testing.assert_allclose(replayed, want, rtol=1e-5)
    elif not exact:
        raise AssertionError(f"{arch}: the restarted run's losses {replayed} "
                             f"are not the uninterrupted run's {want}")
    print(f"[train] restart: launch.train --arch {arch} --smoke --steps "
          f"{RESTART_STEPS} --ckpt-every {RESTART_EVERY} --inject-failure "
          f"{RESTART_FAIL} on the card: rolled back to step {back}, "
          f"{len(replayed)} losses, the replayed ones "
          f"{'bit-equal to' if exact else 'within rtol 1e-5 of'} the "
          f"uninterrupted run's ({' '.join(f'{x:.6f}' for x in replayed)})"
          f"{'' if exact else ' (B4 float atomics reorder its sums)'} | "
          f"{smi}")
    return exact


def train_phase(dev, smi: str) -> dict:
    """[train]: the training path on the card through its entry points.

    glm4-9b at full width, TRAIN_LAYERS layers, remat, one sequence of
    TRAIN_SEQ tokens from ``launch.train.make_batch_fn`` (TokenStream at the
    full vocab) through ``configs.make_train_step``: the first step
    counted (every launch of B5 and its gradient, B6 and its backward
    asserted from the code), then timed steps, the step split into data,
    forward + backward and AdamW, one step under torch.profiler; the
    kernels at the path's shapes against their plain versions; a 1-layer
    full-width model's loss and gradients against the plain versions;
    then graphsage-reddit at minibatch_lg the same way; then the restart
    check of the CLI. Returns the launches and records of the phase."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    spec = configs.get(TRAIN_ARCH)
    full = spec.model_cfg
    cfg = dataclasses.replace(full, n_layer=TRAIN_LAYERS)
    L = cfg.n_layer
    dims = dict(spec.shapes["train_4k"], batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    model, t_init = wall(lambda: configs.init_params(spec, cfg, gen,
                                                     device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count}")
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    step = configs.make_train_step(spec, cfg, opt_cfg)
    state = adamw.init_state(dict(model.named_parameters()))
    batch_fn = train_cli.make_batch_fn(spec, cfg, dims, dev)
    print(f"[train] {TRAIN_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_head} query heads over {cfg.n_kv} kv heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, QKV bias), cut "
          f"in depth: reduced n_layer {full.n_layer} -> {L}; batch "
          f"{spec.shapes['train_4k']['batch']} -> {TRAIN_BATCH} (seq "
          f"{TRAIN_SEQ}); remat {cfg.remat}; {n_params:,} parameters in "
          f"{cfg.dtype}, drawn on the card from seed {TRAIN_SEED} in "
          f"{t_init:.2f}s; AdamW with f32 moments | {smi}")

    losses, step_s, data_s = [], [], []
    for i in range(TRAIN_STEPS):
        batch, t_data = wall(lambda: batch_fn(i))
        if i == 0:
            sm.reset_counts()
            fa.reset_counts()
            fa.reset_bwd_counts()
        (_, state, m), t = wall(lambda: step(model, state, batch))
        if i == 0:
            b5, b5_grad = sm.matmul.launches, sm.matmul_grads.launches
            b5_by_route = b5_routes(sm, {"wgmma": 28 * L + 3}, "a train step")
            b6, b6_bwd = fa.flash_attention.launches, \
                fa.flash_attention_bwd.launches
            b6_by_route = b6_routes(fa, {"wgmma": 2 * L}, "a train step")
            want = (28 * L + 3, 14 * L + 2, 2 * L, L)
            if (b5, b5_grad, b6, b6_bwd) != want:
                raise AssertionError(
                    f"a train step launched B5 {b5} (gradients {b5_grad}), B6 "
                    f"{b6} and its backward {b6_bwd} times, not {want}")
            if fa.flash_attention_bwd.routes["wgmma"] != L:
                raise AssertionError("B6's backward left the wgmma route: "
                                     f"{fa.flash_attention_bwd.routes}")
        losses.append(float(m["loss"]))
        step_s.append(t)
        data_s.append(t_data)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses are not finite: {losses}")
    ln_v = float(np.log(cfg.vocab))
    if not abs(losses[0] - ln_v) <= 1.5:
        raise AssertionError(f"the first loss {losses[0]} is not near ln("
                             f"{cfg.vocab}) = {ln_v}")
    timed = sorted(step_s[1:])
    t_step = timed[len(timed) // 2]
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops = configs.model_flops(spec, "train_4k", dims=dims, model_cfg=cfg)
    data_step = sorted(data_s[1:])[len(data_s[1:]) // 2]
    print(f"[train] main path: {TRAIN_STEPS} steps of make_train_step, the "
          f"first counted: B5 {b5} per step ({b5_by_route}: 7L + 1 forward, "
          f"7L recomputed by remat, 14L + 2 gradient products = {b5_grad}), "
          f"B6 forward {b6} ({b6_by_route}: L + L recomputed), B6 backward "
          f"{b6_bwd} (all on the wgmma route); losses "
          f"{' '.join(f'{x:.4f}' for x in losses)} (ln {cfg.vocab} = "
          f"{ln_v:.4f}); step {t_step:.4f}s (median of {len(timed)} timed; "
          f"first {step_s[0]:.4f}s) = {tokens / t_step:.1f} tokens/s; model "
          f"FLOPs {flops:.4e} per step = {flops / t_step / 989e12:.4f} of "
          f"989 TFLOP/s; data (TokenStream.batch on the host at vocab "
          f"{cfg.vocab} + upload) {data_step:.4f}s per step, outside the "
          f"step; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")

    # -- the step's split, and one step under the profiler ----------------
    batch = batch_fn(TRAIN_STEPS)
    params = dict(model.named_parameters())
    (_, grads), t_fb = wall(lambda: loss_and_grads(spec, cfg, model, batch))
    _, t_opt = wall(lambda: adamw.apply_updates(opt_cfg, params, grads,
                                                state))
    del grads
    t_copy = cuda_ms(lambda: model.head.t().contiguous(), iters=3, warmup=1)
    print(f"[train] step split: forward + backward {t_fb:.4f}s, AdamW "
          f"{t_opt:.4f}s ({n_params:,} parameters, f32 moments), data "
          f"{data_step:.4f}s on the host; B5's gradient copies each "
          f"transposed operand: the head's (1.24 GB) takes {t_copy:.4f} ms "
          f"| {smi}")
    shares = {}
    print(f"[train] one train step under torch.profiler: " + profiled(
        lambda: step(model, state, batch),
        {"B5": is_b5, "B6": lambda k: "flash_wgmma<" in k,
         "B6 backward": lambda k: "flash_bwd" in k}, shares) + f" | {smi}")
    print(f"[train] beside the step with the mma backward (H100 80GB HBM3, "
          f"700 W): step {t_step:.4f}s (then {MMA_BWD_STEP_S}s), forward + "
          f"backward "
          f"{t_fb:.4f}s, AdamW {t_opt:.4f}s; B6's backward "
          f"{shares.get('B6 backward', float('nan')):.3f} of the busy time "
          f"(then {MMA_BWD_SHARE}) | {smi}")
    del model, state, params, batch
    torch.cuda.empty_cache()

    # -- kernels at the path's shapes ---------------------------------------
    one = dataclasses.replace(full, n_layer=1, remat=False)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    m1 = configs.init_params(spec, one, gen, device=dev)
    b1 = batch_fn(0)
    p0 = m1.layers[0]
    pos = torch.arange(TRAIN_SEQ, dtype=torch.int32, device=dev)[None, :]
    with torch.no_grad():
        # the id vocab, which TokenStream emits now and then, takes the
        # last row, as in transformer.train_forward
        ids = b1["tokens"].long().clamp(0, one.vocab - 1)
        h = tfm.rms_norm(m1.embed[ids], p0.ln1)
        q, k, v = tfm.qkv(p0, one, h, pos)
        q, k, v = (x.contiguous() for x in (q, k, v))
    b6_rec = b6_bwd_check(q, k, v, True, smi)
    del q, k, v
    g2 = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)

    def rnd(*shape):
        return torch.randn(shape, generator=g2, device=dev).bfloat16()

    x2, dq_ = h[0].contiguous(), rnd(TRAIN_SEQ, cfg.n_head * cfg.d_head)
    dff, dvoc = rnd(TRAIN_SEQ, cfg.d_ff), rnd(TRAIN_SEQ, cfg.vocab)
    b5g = kernel_checks({
        "grad dA of wq (dC @ wq^T)": (dq_, p0.wq.detach().t().contiguous()),
        "grad dB of ffn.wi (x^T @ dC)": (x2.t().contiguous(), dff),
        "grad dA of ffn.wo (dC @ wo^T)": (
            rnd(TRAIN_SEQ, cfg.d_model),
            p0.ffn.wo.detach().t().contiguous()),
        "grad dB of head (x^T @ dC)": (x2.t().contiguous(), dvoc),
        "grad dA of head (dC @ head^T)": (
            dvoc, m1.head.detach().t().contiguous())}, {}, tag="train")
    del x2, dq_, dff, dvoc, h

    # -- a 1-layer full-width model: kernels against the plain versions ----
    (loss_k, grads_k), t_k = wall(lambda: loss_and_grads(spec, one, m1, b1))
    (loss_p, grads_p), t_p = wall(lambda: loss_and_grads(spec, one, m1, b1,
                                                         plain=True))
    errs = grad_leaf_errs(grads_k, grads_p)
    worst = max(errs, key=errs.get)
    if not abs(loss_k - loss_p) <= TRAIN_LOSS_TOL * abs(loss_p):
        raise AssertionError(f"1-layer loss {loss_k} with the kernels, "
                             f"{loss_p} with the plain versions")
    if not errs[worst] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"gradient {worst} differs from the plain "
                             f"version's by {errs[worst]} of its scale")
    print(f"[train] 1-layer full-width {TRAIN_ARCH}, one sequence of "
          f"{TRAIN_SEQ}: loss {loss_k:.6f} with the kernels ({t_k:.3f}s), "
          f"{loss_p:.6f} with the plain versions on the card ({t_p:.3f}s; "
          f"tolerance {TRAIN_LOSS_TOL} relative); every one of the "
          f"{len(errs)} gradients within {errs[worst]:.3e} of its largest "
          f"|plain| at most ({worst}; tolerance {TRAIN_GRAD_TOL}; per leaf "
          + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()) + f") | {smi}")
    del m1, grads_k, grads_p
    torch.cuda.empty_cache()
    peak_lm = torch.cuda.max_memory_allocated() / 2**30

    # -- graphsage-reddit at minibatch_lg ------------------------------------
    torch.cuda.reset_peak_memory_stats()
    gspec = configs.get(GNN_ARCH)
    gcfg = configs.cell_model_cfg(gspec, GNN_SHAPE)
    gdims = dict(gspec.shapes[GNN_SHAPE])
    gfn, t_graph = wall(lambda: train_cli.make_batch_fn(gspec, gcfg, gdims,
                                                        dev))
    gmodel = configs.init_params(gspec, gcfg,
                                 torch.Generator(device=dev).manual_seed(
                                     TRAIN_SEED), device=dev)
    gstep = configs.make_train_step(gspec, gcfg, opt_cfg)
    gstate = adamw.init_state(dict(gmodel.named_parameters()))
    seeds_n = max(gdims["n"] // 8, 2)
    g_losses, g_step, g_data = [], [], []
    for i in range(TRAIN_STEPS):
        gb, t_data = wall(lambda: gfn(i))
        if i == 0:
            sm.reset_counts()
            sm.segment_sum.launches = sm.segment_gather.launches = 0
            first_gb = gb
        (_, gstate, m), t = wall(lambda: gstep(gmodel, gstate, gb))
        if i == 0:
            counts = (sm.segment_sum.launches, sm.segment_gather.launches,
                      sm.matmul.launches, sm.matmul_grads.launches)
            if counts != (5, 1, 13, 8):
                raise AssertionError(f"a GraphSAGE train step launched B4 "
                                     f"{counts[0]}, its gather {counts[1]} "
                                     f"and B5 {counts[2]} (gradients "
                                     f"{counts[3]}) times, not (5, 1, 13, 8)")
            g_routes = b5_routes(sm, {"f32": 13}, "a GraphSAGE train step")
        g_losses.append(float(m["loss"]))
        g_step.append(t)
        g_data.append(t_data)
    if not all(np.isfinite(g_losses)):
        raise AssertionError(f"GraphSAGE losses are not finite: {g_losses}")
    gt = sorted(g_step[1:])[len(g_step[1:]) // 2]
    gd = sorted(g_data[1:])[len(g_data[1:]) // 2]
    E = int(first_gb["src"].shape[0])
    print(f"[train] {GNN_ARCH} at {GNN_SHAPE}'s full dims ({gdims['n']:,} "
          f"nodes, d_in {gcfg.d_in}, hidden {gcfg.d_hidden}, "
          f"{gcfg.n_classes} classes) through launch.train's make_batch_fn "
          f"(power-law graph, average degree 6, built in {t_graph:.2f}s; "
          f"{seeds_n:,} seeds a step, fanout (5, 5), {E:,} edges padded) and "
          f"make_train_step: first step counted: B4 {counts[0]} (4 forward, "
          f"1 the neighbour gather's gradient), B4 gather {counts[1]}, B5 "
          f"{counts[2]} ({g_routes}; {counts[3]} of them gradients); losses "
          f"{' '.join(f'{x:.4f}' for x in g_losses)}; step {gt:.4f}s = "
          f"{1 / gt:.3f} steps/s = {seeds_n / gt:.1f} seeds/s trained on the "
          f"card; the sampler {gd:.4f}s per step on the host (outside the "
          f"step) | {smi}")
    pattern = ReluPattern()
    (gl_k, gg_k), _ = wall(lambda: loss_and_grads(
        gspec, gcfg, gmodel, first_gb, relu=pattern.record))
    (gl_p, gg_p), _ = wall(lambda: loss_and_grads(
        gspec, gcfg, gmodel, first_gb, plain=True, relu=pattern.replay))
    gerrs = grad_leaf_errs(gg_k, gg_p)
    gworst = max(gerrs, key=gerrs.get)
    if not (abs(gl_k - gl_p) <= 1e-5 * abs(gl_p)
            and gerrs[gworst] <= GNN_GRAD_TOL):
        raise AssertionError(f"GraphSAGE: loss {gl_k} against {gl_p}, "
                             f"gradient {gworst} off by {gerrs[gworst]} "
                             f"({pattern.flips} relu inputs flipped; per "
                             f"leaf {gerrs})")
    print(f"[train] GraphSAGE loss {gl_k:.7f} with the kernels, {gl_p:.7f} "
          f"with the plain versions; gradients within {gerrs[gworst]:.3e} of "
          f"each leaf's largest |plain| ({gworst}; tolerance "
          f"{GNN_GRAD_TOL}); the plain run differentiates the kernel run's "
          f"relu pattern, where {pattern.flips} of {pattern.entries:,} "
          f"pre-activations took the other sign (the nearest to 0 "
          f"{pattern.nearest:.3e}, the runs' largest difference "
          f"{pattern.gap:.3e}) | {smi}")
    gather_recs = [
        b4_gather_check(torch.randn(gdims["n"], gcfg.d_hidden, generator=gen,
                                    device=dev), first_gb["dst"],
                        "layer 2 (d = 128), the path's", smi),
        b4_gather_check(torch.randn(gdims["n"], gcfg.d_in, generator=gen,
                                    device=dev), first_gb["dst"],
                        "at d = 602", smi)]
    print(f"[train] GraphSAGE peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; glm4's "
          f"{peak_lm:.2f} GiB | {smi}")
    del gmodel, gstate, first_gb, gb
    torch.cuda.empty_cache()

    exact = restart_check(TRAIN_ARCH, dev, smi)
    restart_check(GNN_ARCH, dev, smi)
    print(f"[train] phase {time.perf_counter() - t_phase:.1f}s | {smi}")
    csrc = "src/repro_torch/kernels/csrc/"
    gmain = gather_recs[0]
    bmain = b5g["grad dB of ffn.wi (x^T @ dC)"]
    return {
        "b5": b5 - b5_grad + counts[2] - counts[3], "b6": b6,
        "b4": counts[0], "restart_exact": exact,
        "records": [
            {"name": "matmul (gradient)", "route": "cuda",
             "source": csrc + "matmul.cu",
             "replaces": "src/repro/kernels/segment_matmul.py:52",
             "launches": b5_grad + counts[3],
             "max_abs_err": max(r["max_abs_err"] for r in b5g.values()),
             "ms": bmain["ms"], "plain_ms": bmain["plain_ms"],
             "bound_ms": bmain["bound_ms"], "bound_by": bmain["bound_by"],
             "library_ms": bmain["library_ms"]},
            {"name": "flash_attention_bwd", "route": "cuda",
             "source": csrc + "flash_attention_bwd.cu",
             "replaces": "src/repro/kernels/flash_attention.py:96",
             "launches": b6_bwd, **b6_rec},
            {"name": "segment_gather", "route": "cuda",
             "source": csrc + "segment_sum.cu",
             "replaces": "src/repro/kernels/segment_matmul.py:104",
             "launches": counts[1],
             "max_abs_err": max(r["max_abs_err"] for r in gather_recs),
             **{k: gmain[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}]}


def sweep_split(g, ks, dev) -> dict:
    """The card build's steps one at a time, each timed: the pair CSR and
    the t_uv rows on the host, their upload, the stratum sweep (CUDA
    events around its launches), the rows' download, and the host's
    delta compression and stratification. Returns the times, the rows
    (a (|K|, t_max + 1, n) card tensor), the per-stratum counts and the
    sweep's operands of the first block."""
    from repro_torch.core import core_time as ct
    from repro_torch.kernels import segmented_select as ss

    inf = g.t_max + 1
    t0 = time.perf_counter()
    csr = ct._pair_csr(g)
    t_csr = time.perf_counter() - t0
    blocks = [(lo, min(lo + ct.TUV_BLOCK, g.t_max + 1))
              for lo in range(1, g.t_max + 1, ct.TUV_BLOCK)]
    t0 = time.perf_counter()
    tuv_np = [np.ascontiguousarray(ct._tuv_rows(csr, lo, hi, g.t_max))
              for lo, hi in blocks]
    t_tuv = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops = [torch.as_tensor(a, device=dev) for a in (
        csr.src, csr.vptr.astype(np.int32), csr.dst,
        np.asarray(ks, np.int32))]
    tuv = [torch.as_tensor(a, device=dev) for a in tuv_np]
    rows = torch.full((len(ks), g.t_max + 1, g.n), inf, dtype=torch.int32,
                      device=dev)
    carry = torch.zeros((len(ks), g.n), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    counts = 0
    start.record()
    for (lo, hi), t in zip(blocks, tuv):
        counts = counts + ss.stratum_sweep(t, *ops[:3], ops[3], carry, inf,
                                           out=rows[:, lo:hi])[1]
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end)
    host_rows, t_down = wall(lambda: rows.cpu().numpy())
    t0 = time.perf_counter()
    ct.StratifiedCoreTable.from_tables(
        g, ks, [ct._compress(g, v) for v in host_rows])
    t_compress = time.perf_counter() - t0
    return dict(t_csr=t_csr, t_tuv=t_tuv, t_up=t_up, kernel_ms=kernel_ms,
                t_down=t_down, t_compress=t_compress, rows=rows,
                counts=counts.cpu().numpy(), host_rows=host_rows,
                ops=[tuv[0], *ops[:3]], blocks=blocks)


def construct_phase(dev):
    """``[construct]``: the CollegeMsg-scale strata built on the card (the
    main path of the stratum sweep, counted) and on the host, every field
    equal; the build's split, idle share, bound and serial chain; the
    kernel against its plain version on the card. Returns ``(g, ks,
    strata, t_dev, t_host, b2_launches, record)``."""
    from repro_torch.core import core_time as ct
    from repro_torch.core.temporal_graph import gen_temporal_graph
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented_select as ss

    from repro_torch.core import kcore
    from repro_torch.kernels import kcore_peel

    g = gen_temporal_graph(**COLLEGEMSG)
    f0 = kcore_peel.kcore_fixpoint.launches
    ks, t_ks = wall(lambda: ct.default_ks(g, device=dev))
    fix = kcore_peel.kcore_fixpoint.launches - f0
    if ks != ct.default_ks(g) or fix != kmax_probes(ks[-1]):
        raise AssertionError(f"the card's k range {ks[0]}..{ks[-1]} ({fix} "
                             f"kcore_fixpoint launches) differs from "
                             f"numpy's or from one launch per k_max probe")
    print(f"[construct] k range on the card: default_ks = {ks[0]}.."
          f"{ks[-1]} through kcore.k_max (kcore_fixpoint launches {fix}, one "
          f"per probe; equal to numpy's k_max {kcore.k_max(g)}) in "
          f"{t_ks:.4f}s")
    inf = g.t_max + 1
    host_strata, t_host = wall(lambda: ct.stratified_core_times(
        g, ks, device="cpu"))
    stats: dict = {}
    ss.reset_sweep_counts()
    ss.segmented_count_le.launches = 0
    strata, t_dev = wall(lambda: ct.stratified_core_times(
        g, ks, engine="device", device=dev, stats=stats))
    launches = ss.stratum_sweep.launches
    routes = dict(ss.stratum_sweep.routes)
    b2_launches = ss.segmented_count_le.launches
    blocks = -(-g.t_max // ct.TUV_BLOCK)
    route = ss.sweep_route(g.n)
    if launches <= 0:
        raise AssertionError("the device build launched the stratum sweep "
                             "no time")
    if launches != blocks or routes[route] != blocks:
        raise AssertionError(f"the build made {launches} sweep launches "
                             f"({routes}), expected {blocks} on the {route} "
                             "route, one per t_uv block")
    if b2_launches:
        raise AssertionError(f"B2 launched {b2_launches} times during the "
                             "build (it is off the build path)")
    for f in dataclasses.fields(strata):
        a, b = getattr(strata, f.name), getattr(host_strata, f.name)
        if not (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b):
            raise AssertionError(f"card-built strata differ from the "
                                 f"host's in {f.name}")
    same = sum(np.array_equal(strata.table_for(k).vertex_ct,
                              host_strata.table_for(k).vertex_ct)
               for k in ks)
    if same != len(ks):
        raise AssertionError(f"only {same} of {len(ks)} strata equal")
    per = stats["strata"]
    if stats["iterations"] - stats["climbs"] != g.t_max * len(ks):
        raise AssertionError("every (k, ts) must end on a passing probe")
    E = int(ct._pair_csr(g).src.shape[0])
    print(f"[construct] n={g.n} m={g.m} t_max={g.t_max} E={E} slots "
          f"|K|={len(ks)} (k={ks[0]}..{ks[-1]}): {same}/{len(ks)} card-built "
          f"strata array-equal to the host's (every field; tolerance 0: "
          f"integer tables); card build {t_dev:.2f}s, host fused sweep "
          f"{t_host:.2f}s; stratum_sweep launches {launches} "
          f"(ceil(t_max / {ct.TUV_BLOCK}) = {blocks}; routes {routes}), B2 "
          f"launches {b2_launches} during the build; probes "
          f"{stats['iterations']}, climbs {stats['climbs']} (strata run "
          f"independently)")

    # the build's split: the same steps one at a time
    sp = sweep_split(g, ks, dev)
    if not np.array_equal(sp["counts"], per):
        raise AssertionError("the split run's counts differ from the build's")
    for i, k in enumerate(ks):
        if not np.array_equal(sp["host_rows"][i],
                              strata.table_for(k).vertex_ct):
            raise AssertionError(f"the split run's stratum k={k} differs")
    chain = int(per[:, 0].max())
    bound = sum(ss.sweep_bound_ms(len(ks), hi - lo, E, g.n)
                for lo, hi in sp["blocks"])
    t_parts = (sp["t_csr"] + sp["t_tuv"] + sp["t_up"] + sp["kernel_ms"] / 1e3
               + sp["t_down"] + sp["t_compress"])
    print(f"[construct] build split: pair CSR {sp['t_csr']:.4f}s, _tuv_rows "
          f"{sp['t_tuv']:.4f}s, upload {sp['t_up']:.4f}s, stratum_sweep "
          f"{sp['kernel_ms']:.3f} ms (CUDA events, {len(sp['blocks'])} "
          f"launch(es)), download {sp['t_down']:.4f}s, host _compress + "
          f"stratify {sp['t_compress']:.4f}s; sum {t_parts:.2f}s. Kernel "
          f"bound {bound:.6f} ms (bytes: t_uv block read once, rows written "
          f"once, CSR, ks, carry and counts moved once, at 3.35 TB/s); "
          f"serial chain: the longest stratum's {chain} probes (k="
          f"{ks[int(per[:, 0].argmax())]}), "
          f"{sp['kernel_ms'] * 1e3 / chain:.2f} us per probe; per-stratum "
          f"probes {int(per[:, 0].min())}..{chain}, climbs "
          f"{int(per[:, 1].min())}..{int(per[:, 1].max())}")

    # the whole card build under the profiler: the device's idle share
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_prof = wall(lambda: ct.stratified_core_times(
            g, ks, engine="device", device=dev))
    rows = device_rows(prof)
    busy_us = sum(t for _, t, _ in rows)
    sweep_us = sum(t for key, t, _ in rows if "stratum_sweep" in key)
    print(f"[construct] card build under torch.profiler: wall {t_prof:.2f}s; "
          + (f"device busy {busy_us / 1e6:.4f}s (idle share "
             f"{1 - busy_us / 1e6 / t_prof:.4f}), stratum_sweep "
             f"{sweep_us / 1e3:.3f} ms; top kernels: " + top_rows(rows)
             if busy_us else "device busy not measured (no device events)"))
    del prof

    # the kernel against its plain version on the card, the same operands:
    # stratum k0 alone (the old path's cost: a host loop of small launches
    # and a flag read per probe), then every stratum
    tuv, seg, vptr, dst = sp["ops"]
    if len(sp["blocks"]) != 1:
        raise AssertionError("the plain comparison sweeps one t_uv block")
    k0 = ks[0]
    kt0 = torch.tensor([k0], dtype=torch.int32, device=dev)
    c_p = torch.zeros((1, g.n), dtype=torch.int32, device=dev)
    out_p = torch.empty((1, g.t_max, g.n), dtype=torch.int32, device=dev)
    st_p, t_plain0 = wall(lambda: ref.stratum_sweep(tuv, seg, vptr, dst, kt0,
                                                    c_p, inf, out_p))
    c_k = torch.zeros_like(c_p)
    (out_k, st_k), t_kern0 = wall(lambda: ss.stratum_sweep(
        tuv, seg, vptr, dst, kt0, c_k, inf))
    err = max(check_equal(f"stratum k={k0} rows", out_k, out_p),
              check_equal(f"stratum k={k0} carry", c_k, c_p),
              check_equal(f"stratum k={k0} counts", st_k, st_p),
              check_equal(f"stratum k={k0} rows vs the build", out_k[0],
                          sp["rows"][0, 1:]))
    if not np.array_equal(st_k.cpu().numpy()[0], per[0]):
        raise AssertionError(f"stratum k={k0}'s counts differ from the "
                             "build's")
    kt = torch.as_tensor(np.asarray(ks, np.int32), device=dev)
    c_all = torch.zeros((len(ks), g.n), dtype=torch.int32, device=dev)
    out_all = torch.empty((len(ks), g.t_max, g.n), dtype=torch.int32,
                          device=dev)
    st_all, t_plain = wall(lambda: ref.stratum_sweep(
        tuv, seg, vptr, dst, kt, c_all, inf, out_all))
    err = max(err, check_equal("every stratum's rows", sp["rows"][:, 1:],
                               out_all))
    if not np.array_equal(st_all.cpu().numpy(), per):
        raise AssertionError("the plain version's counts differ from the "
                             "kernel's")
    carry = torch.zeros_like(c_all)

    def launch():
        carry.zero_()
        ss.stratum_sweep(tuv, seg, vptr, dst, kt, carry, inf)

    ms = cuda_ms(launch, iters=5, warmup=1)
    print(f"[construct] stratum_sweep against ref.stratum_sweep on the card, "
          f"same operands (R={g.t_max}, E={E}, n={g.n}): stratum k={k0} alone "
          f"rows, carry and counts {st_k.tolist()[0]} equal (tolerance 0), "
          f"kernel {t_kern0 * 1e3:.3f} ms wall, plain {t_plain0:.3f}s wall "
          f"(the old path's cost: a host loop, a flag read per probe); all "
          f"{len(ks)} strata equal, kernel {ms:.3f} ms per launch (CUDA "
          f"events, 5 launches), plain {t_plain:.3f}s wall; bound "
          f"{bound:.6f} ms; library: none (no PyTorch call computes the "
          f"sweep)")
    record = {"name": "stratum_sweep", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/stratum_sweep.cu",
              "replaces": "src/repro/kernels/segmented_select.py:117, "
                          "src/repro/core/core_time.py:346",
              "launches": launches, "max_abs_err": err, "ms": ms,
              "plain_ms": t_plain * 1e3, "bound_ms": bound,
              "bound_by": "bytes", "library_ms": None}
    return g, ks, strata, t_dev, t_host, b2_launches, record


def distinct_pairs(g, dev):
    """The graph's distinct pairs (min, max) as int32 on the card, sorted,
    and the index of each edge's pair: (us, ud, inv)."""
    from repro_torch.core import kcore

    us, ud, inv = kcore.distinct_pairs(g.src, g.dst, g.n)
    return (torch.as_tensor(us.astype(np.int32), device=dev),
            torch.as_tensor(ud.astype(np.int32), device=dev), inv)


def device_times(calls, sleep_ms: float):
    """Device ms of each of ``calls`` (functions of no argument) by CUDA
    events between them, the card asleep for ``sleep_ms`` + 10 ms first so
    that the host enqueues ahead of it; run again, three times at most,
    while the host fell behind all the same (the first event had
    completed by the time the last call was enqueued). Returns (ms per
    call, whether the host stayed ahead, the calls' results)."""
    for _ in range(3):
        evs = [torch.cuda.Event(enable_timing=True)
               for _ in range(len(calls) + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(int((sleep_ms + 10.0) * 2e6))  # ~2 GHz cycles
        evs[0].record()
        outs = []
        for call, ev in zip(calls, evs[1:]):
            outs.append(call())
            ev.record()
        ahead = not evs[0].query()
        torch.cuda.synchronize()
        if ahead:
            break
    return ([a.elapsed_time(b) for a, b in zip(evs, evs[1:])], ahead,
            outs)


def old_fixpoint(us, ud, n: int, k: int):
    """The peel as it ran before the fixpoint kernel: B3a then B3b per
    round, one read of the change flag per round. (mask, rounds)."""
    from repro_torch.kernels import kcore_peel

    alive = torch.ones(us.shape[0], dtype=torch.bool, device=us.device)
    changed = torch.zeros(1, dtype=torch.int32, device=us.device)
    rounds = 0
    while True:
        changed.zero_()
        new = kcore_peel.peel_round(us, ud, alive, n, k, changed=changed)
        rounds += 1
        if not int(changed.item()):
            return new, rounds
        alive = new


def peel_graph(label: str, g, us, ud, inv, peel_ks, host_ks) -> dict:
    """``[peel]`` on one graph: ``ops.kcore_fixpoint`` over its distinct
    pairs for every k of ``peel_ks`` (the main path, counted: one launch
    per fixpoint, no B3a/B3b launch); every mask and round count against
    the plain version on the card, in the counted run and in the timed
    one, the ks of ``host_ks`` against the host's k-core; the wall of all
    fixpoints, the device time of each by CUDA events, the serial chain
    and the bound; the old path (B3a + B3b and a flag read per round) on
    the same operands."""
    from repro_torch.core import kcore
    from repro_torch.kernels import kcore_peel, ref
    from repro_torch.kernels import ops as kernel_ops

    dev, n, m, F = us.device, g.n, int(us.shape[0]), len(peel_ks)
    rounds = torch.zeros(F, dtype=torch.int32, device=dev)
    # one call outside the counted run: the kernel's module loads at its
    # first launch
    kcore_peel.kcore_fixpoint(us, ud, n, peel_ks[0])
    torch.cuda.synchronize()
    kcore_peel.kcore_fixpoint.launches = 0
    kcore_peel.degree_count.launches = 0
    kcore_peel.peel_threshold.launches = 0
    masks, t_peel = wall(lambda: [
        kernel_ops.kcore_fixpoint(us, ud, n, k, rounds=rounds[i:i + 1])
        for i, k in enumerate(peel_ks)])
    launches = kcore_peel.kcore_fixpoint.launches
    b3 = (kcore_peel.degree_count.launches,
          kcore_peel.peel_threshold.launches)
    if launches <= 0:
        raise AssertionError(f"the {label} peel launched kcore_fixpoint no "
                             "time")
    if launches != F:
        raise AssertionError(f"the {label} peel made {launches} kcore_fixpoint"
                             f" launches, expected {F}, one per fixpoint")
    if b3 != (0, 0):
        raise AssertionError(f"B3a/B3b launched {b3} times during the "
                             f"{label} peel (they are off the fixpoint path)")

    # every mask and round count against the plain version on the card
    plain_rounds = torch.zeros_like(rounds)
    plain, t_plain = wall(lambda: [
        ref.kcore_fixpoint(us, ud, n, k, rounds=plain_rounds[i:i + 1])
        for i, k in enumerate(peel_ks)])
    err = max(check_equal(f"{label} {k}-core", a, b)
              for k, a, b in zip(peel_ks, masks, plain))
    err = max(err, check_equal(f"{label} rounds", rounds, plain_rounds))
    per = rounds.cpu().tolist()

    # the old path on the same operands
    old, t_old = wall(lambda: [old_fixpoint(us, ud, n, k) for k in peel_ks])
    for k, a, (b, r_old), r in zip(peel_ks, masks, old, per):
        check_equal(f"{label} {k}-core by the old path", b, a)
        if r_old != r:
            raise AssertionError(f"{label} k={k}: the old path ran {r_old} "
                                 f"rounds, the kernel {r}")

    # the listed ks against the host's k-core
    t0 = time.perf_counter()
    for k in host_ks:
        want = kcore.distinct_kcore_edge_mask(g.src, g.dst, n, k)
        if not np.array_equal(masks[peel_ks.index(k)].cpu().numpy()[inv],
                              want):
            raise AssertionError(f"the card's {label} {k}-core differs from "
                                 "the host's")
    t_host = time.perf_counter() - t0
    sizes = torch.stack(masks).sum(1).cpu().tolist() if m else [0] * F
    if sizes[-1] != 0 or sizes[-2] == 0:
        raise AssertionError(f"{label}: k_max's core must be non-empty, "
                             "k_max + 1's empty")

    # device time of each fixpoint, its masks and rounds held to the
    # counted run's
    timed_rounds = torch.zeros_like(rounds)
    dev_ms, ahead, timed = device_times(
        [functools.partial(kcore_peel.kcore_fixpoint, us, ud, n, k,
                           rounds=timed_rounds[i:i + 1])
         for i, k in enumerate(peel_ks)], 2 * t_peel * 1e3)
    for k, a, b in zip(peel_ks, timed, masks):
        check_equal(f"{label} {k}-core of the timed run", a, b)
    check_equal(f"{label} rounds of the timed run", timed_rounds, rounds)
    host = host_ms(lambda: kcore_peel.kcore_fixpoint(us, ud, n,
                                                     peel_ks[F // 2]))
    longest = int(np.argmax(per))
    bound = kcore_peel.fixpoint_bound_ms(m)
    print(f"[peel] {label}: ops.kcore_fixpoint on the card over {m} distinct "
          f"pairs (n={n}) for k={peel_ks[0]}..{peel_ks[-1]} ({F} fixpoints):"
          f" kcore_fixpoint launches {launches} (one per fixpoint, "
          f"{kcore_peel.grid_blocks(m, n)} co-resident blocks of 1,024 "
          f"threads), B3a launches {b3[0]}, B3b {b3[1]}; every mask "
          f"bit-equal to ref.kcore_fixpoint on the card and every round "
          f"count equal, in the counted and the timed run (max abs err "
          f"{err}, tolerance 0: bool masks and integer counts), {sum(per)} "
          f"rounds; k in {list(host_ks)} equal to "
          f"kcore.distinct_kcore_edge_mask on the host ({t_host:.3f}s); "
          f"core sizes (pairs) {sizes[0]}..{sizes[-2]}, then {sizes[-1]}")
    print(f"[peel] {label}: wall of all {F} fixpoints {t_peel:.6f}s "
          f"({t_peel / F * 1e3:.6f} ms each, host and card); device time by "
          f"CUDA events {sum(dev_ms):.6f} ms ("
          f"{'host ahead' if ahead else 'the host fell behind: back to back'}"
          f"), {sum(dev_ms) / F:.6f} ms per fixpoint (min "
          f"{min(dev_ms):.6f}, max {max(dev_ms):.6f}); host {host:.6f} ms per "
          f"call; serial chain: the longest fixpoint's {per[longest]} rounds "
          f"(k={peel_ks[longest]}) in {dev_ms[longest]:.6f} ms, "
          f"{dev_ms[longest] * 1e3 / per[longest]:.3f} us per round; bound "
          f"{bound:.6f} ms per fixpoint (bytes: 9*m + 4 at 3.35 TB/s), "
          f"{bound * F:.6f} ms in all, {bound * F / sum(dev_ms):.6f} of the "
          f"device time. The old path on the same operands (B3a + B3b per "
          f"round, one flag read each; {sum(r for _, r in old)} rounds, masks "
          f"equal): {t_old:.6f}s wall, {t_old / t_peel:.1f}x the kernel's; "
          f"the plain version on the card {t_plain:.6f}s wall; library: none "
          f"(no PyTorch call computes a k-core fixpoint)")
    return dict(launches=launches, b3=b3, err=err, ms=sum(dev_ms) / F,
                plain_ms=t_plain / F * 1e3, bound_ms=bound)


def peel_phase(g, us, ud, inv, ks) -> tuple[dict, tuple[int, int]]:
    """``[peel]`` on the CollegeMsg-scale graph (``ks``: every k of the
    index and k_max + 1, each also against the host) and on an
    sx-superuser-scale graph (k = 2..k_max + 1; SX_HOST_KS against the
    host). Returns the kcore_fixpoint record (launches over both graphs,
    times and bound from the CollegeMsg run, per fixpoint) and the B3a
    and B3b launches of both peels."""
    from repro_torch.core import kcore
    from repro_torch.core.temporal_graph import gen_temporal_graph

    cm = peel_graph("CollegeMsg", g, us, ud, inv, ks, ks)
    t0 = time.perf_counter()
    sx = gen_temporal_graph(**SX_SUPERUSER)
    sx_us, sx_ud, sx_inv = distinct_pairs(sx, us.device)
    sx_kmax = kcore.k_max(sx)
    print(f"[peel] sx-superuser scale: n={sx.n} m={sx.m} t_max={sx.t_max}, "
          f"{int(sx_us.shape[0])} distinct pairs, k_max {sx_kmax} on the "
          f"host, made in {time.perf_counter() - t0:.2f}s")
    sx_ks = list(range(2, sx_kmax + 2))
    host_ks = sorted({max(2, int(f * sx_kmax)) for f in SX_HOST_KS}
                     | {sx_kmax + 1})
    sxr = peel_graph("sx-superuser", sx, sx_us, sx_ud, sx_inv, sx_ks,
                     host_ks)
    return {"name": "kcore_fixpoint", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kcore_fixpoint.cu",
            "replaces": "src/repro/kernels/kcore_peel.py:62, :117 (iterated "
                        "by src/repro/kernels/ref.py:33)",
            "launches": cm["launches"] + sxr["launches"],
            "max_abs_err": max(cm["err"], sxr["err"]), "ms": cm["ms"],
            "plain_ms": cm["plain_ms"], "bound_ms": cm["bound_ms"],
            "bound_by": "bytes", "library_ms": None}, tuple(
                a + b for a, b in zip(cm["b3"], sxr["b3"]))


#: [baselines]: the shares of k_max bench_paper.py's bench_vary_k sweeps
#: around the default k (benchmarks/common.py default_k: 0.7), its query
#: count, and the queries also held to the brute-force oracle on the card
BASELINE_FRACS = (0.5, 0.7, 0.9)
BASELINE_QUERIES = 1000
BASELINE_ORACLE = 64
#: the reference package's counts on the COLLEGEMSG graph per k (its
#: core_time, pecb_index, ctmsf_index and ef_index): versions, PECB,
#: CT-MSF and EF bytes, EF chain forests, distinct cores and enumerated
#: core edges; the port must reproduce them exactly
BASELINE_COUNTS = {
    19: (595532, 784468, 349896, 2852600, 158, 12459, 206178150),
    27: (669785, 406768, 179944, 1776640, 104, 5628, 117414963),
    34: (455461, 144532, 62044, 715640, 43, 1058, 27749364)}


def kmax_probes(km: int) -> int:
    """Fixpoints ``kcore.k_max`` runs to find ``km``: the doubling's
    probes (the last one empty), then the bisection's."""
    probes, lo, hi = 0, 1, 1
    while hi <= km:
        probes += 1
        lo, hi = hi, hi * 2
    probes += 1
    while lo + 1 < hi:
        probes += 1
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if mid <= km else (lo, mid)
    return probes


def boruvka_check(g, tab, ef, dev) -> dict:
    """Borůvka on the card (torch ops) at every start time with active
    versions, each mask array-equal to the host's Kruskal and to the
    forest EF stores for that start time."""
    from repro_torch.core import ctmsf
    from repro_torch.core.ecb_forest import active_versions

    stats: dict = {}
    t_card = t_host = 0.0
    edges = 0
    for ts in range(1, g.t_max + 1):
        e_ids, cts = active_versions(tab, ts)
        if not e_ids.size:
            continue
        u, v = g.src[e_ids], g.dst[e_ids]
        ops_ = [torch.as_tensor(a, device=dev) for a in (u, v, cts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ctmsf.boruvka_msf(*ops_, g.n, stats=stats).cpu().numpy()
        t_card += time.perf_counter() - t0
        want, t = wall(lambda: ctmsf.kruskal_msf(u, v, cts, g.n))
        t_host += t
        if not np.array_equal(got, want):
            raise AssertionError(f"Borůvka on the card differs from Kruskal "
                                 f"at ts={ts}")
        f = ef.forests[int(ef.ts_to_forest[ts])]
        if not (np.array_equal(f.node_u, u[got]) and np.array_equal(
                f.node_v, v[got]) and np.array_equal(f.node_ct, cts[got])):
            raise AssertionError(f"Borůvka's forest differs from EF's at "
                                 f"ts={ts}")
        edges += int(got.sum())
    r = stats["rounds"]
    return dict(checked=len(r), rounds=r, card_s=t_card, host_s=t_host,
                edges=edges)


def baselines_phase(g, dev, smi: str) -> tuple[int, int, int]:
    """``[baselines]``: the paper's comparison (Figures 4-6) at CollegeMsg
    scale through the port's entry points. k_max on the card (one
    kcore_fixpoint launch per probe) equal to numpy's; at 0.5, 0.7 and 0.9
    of it the core-time table on the card (equal to the host engine's) and
    PECB, CT-MSF and EF built from it, each one's bytes and build seconds,
    EF's forests, distinct cores and enumerated core edges, all equal to
    BASELINE_COUNTS; at the default k Borůvka on the card against Kruskal
    at every start time; 1,000 random_queries at each k through the three
    host answerers and the PECB's device batch on B1, all equal, 64 of
    them against the oracle on the card (one fixpoint launch per window
    and oracle) and every answer mode of EF and CT-MSF. Returns the
    phase's (kcore_fixpoint, B1, stratum_sweep) launches."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core import kcore
    from repro_torch.core.ctmsf_index import CTMSFIndex
    from repro_torch.core.ef_index import EFIndex
    from repro_torch.core.pecb_index import build_pecb_index
    from repro_torch.core.query_api import ResultMode, TCCSQuery
    from repro_torch.core.temporal_graph import random_queries
    from repro_torch.kernels import kcore_peel, label_prop
    from repro_torch.kernels import segmented_select as ss

    tag = f"({smi})"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kcore_peel.kcore_fixpoint.launches = 0
    label_prop.label_prop_round.launches = 0
    ss.reset_sweep_counts()

    km, t_km = wall(lambda: kcore.k_max(g, device=dev))
    probes = kcore_peel.kcore_fixpoint.launches
    km_np, t_km_np = wall(lambda: kcore.k_max(g))
    if km != km_np:
        raise AssertionError(f"k_max on the card {km} != numpy's {km_np}")
    if probes != kmax_probes(km):
        raise AssertionError(f"k_max made {probes} kcore_fixpoint launches, "
                             f"expected {kmax_probes(km)} (one per probe)")
    ks = [max(2, int(round(f * km))) for f in BASELINE_FRACS]
    k_def = ks[BASELINE_FRACS.index(0.7)]
    print(f"[baselines] {tag} k_max {km} on the card (equal to numpy's "
          f"{km_np}): kcore_fixpoint launches {probes} (one per probe of "
          f"the doubling and the bisection, one upload), {t_km:.4f}s, numpy "
          f"{t_km_np:.4f}s; default k max(2, round(0.7 * k_max)) = {k_def}; "
          f"ks {ks} (0.5, 0.7, 0.9 of k_max)")

    built = {}
    for k in ks:
        tab, t_tab = wall(lambda: ct.edge_core_times(g, k, device=dev))
        host_tab, t_tab_host = wall(lambda: ct.edge_core_times(
            g, k, device="cpu"))
        for f in ("edge_id", "ts_from", "ts_to", "ct", "vertex_ct"):
            if not np.array_equal(getattr(tab, f), getattr(host_tab, f)):
                raise AssertionError(f"k={k}: the card's core-time table "
                                     f"differs from the host's in {f}")
        pecb, t_pecb = wall(lambda: build_pecb_index(g, k, tab))
        cm, t_cm = wall(lambda: CTMSFIndex(g, k, tab))
        ef, t_ef = wall(lambda: EFIndex(g, k, tab))
        counts = (tab.num_versions, pecb.nbytes(), cm.nbytes(), ef.nbytes(),
                  len(ef.forests), ef.num_distinct_cores,
                  ef.enumerated_core_edges)
        if counts != BASELINE_COUNTS.get(k):
            raise AssertionError(f"k={k}: counts {counts} differ from the "
                                 f"reference's {BASELINE_COUNTS.get(k)}")
        built[k] = tab, pecb, cm, ef
        print(f"[baselines] {tag} k={k}: core-time table on the card "
              f"{t_tab:.4f}s (host engine {t_tab_host:.4f}s, every field "
              f"equal), {counts[0]} versions. Bytes (Figure 4): PECB "
              f"{counts[1]}, CT-MSF {counts[2]}, EF {counts[3]} (EF / PECB "
              f"{counts[3] / counts[1]:.3f}, CT-MSF / PECB "
              f"{counts[2] / counts[1]:.3f}). Build s from the table (Figure "
              f"5, host): PECB {t_pecb:.4f}, CT-MSF {t_cm:.4f}, EF "
              f"{t_ef:.4f} (EF / PECB {t_ef / t_pecb:.2f}x); EF "
              f"{counts[4]} chain forests, {counts[5]} distinct cores, "
              f"{counts[6]} enumerated core edges; all equal to the "
              f"reference's counts")

    tab, pecb, cm, ef = built[k_def]
    bo = boruvka_check(g, tab, ef, dev)
    r = bo["rounds"]
    print(f"[baselines] {tag} Borůvka at k={k_def} on the card (torch "
          f"ops): {bo['checked']} start times with active versions, every "
          f"mask array-equal to Kruskal on the host and to EF's stored "
          f"forest ({bo['edges']} forest edges in all); rounds "
          f"{min(r)}..{max(r)}, {sum(r)} in all; card "
          f"{bo['card_s'] / bo['checked'] * 1e3:.3f} ms per start time "
          f"(upload, rounds with one flag read each, download), host "
          f"Kruskal {bo['host_s'] / bo['checked'] * 1e3:.3f} ms")

    qs = random_queries(g, BASELINE_QUERIES)
    modes = (ResultMode.VERTICES, ResultMode.EDGES, ResultMode.SUBGRAPH,
             ResultMode.COUNT)
    oracle_fix = 0
    for k in ks:
        tab, pecb, cm, ef = built[k]
        answers, us_q = {}, {}
        for name, idx in (("PECB", pecb), ("CT-MSF", cm), ("EF", ef)):
            answers[name], t = wall(lambda: [
                idx._component_vertices(u, ts, te) for (u, ts, te) in qs])
            us_q[name] = t / len(qs) * 1e6
        dix = bq.to_device(pecb, dev)
        b0 = label_prop.label_prop_round.launches
        stats: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = []
        for i in range(0, len(qs), BUCKET):
            cols = bq._query_columns(qs[i:i + BUCKET], (0, 1, 2), dev)
            mask = bq.batch_query(dix, *cols, stats=stats).cpu().numpy()
            got += [set(np.flatnonzero(row).tolist()) for row in mask]
        t_b1 = time.perf_counter() - t0
        b1 = label_prop.label_prop_round.launches - b0
        if b1 <= 0 or b1 != sum(stats["rounds"]):
            raise AssertionError(f"k={k}: B1 launches {b1} != rounds "
                                 f"{stats['rounds']}")
        answers["PECB on B1"] = got
        bad = sum(len({frozenset(a[i]) for a in answers.values()}) != 1
                  for i in range(len(qs)))
        if bad:
            raise AssertionError(f"k={k}: the four answerers disagree on "
                                 f"{bad} of {len(qs)} queries")
        f0 = kcore_peel.kcore_fixpoint.launches
        windows = 0
        for i, (u, ts, te) in enumerate(qs[:BASELINE_ORACLE]):
            want_v = frozenset(kcore.tccs_oracle(g, k, u, ts, te,
                                                 device=dev))
            want_e = frozenset(kcore.tccs_oracle_edges(g, k, u, ts, te,
                                                       device=dev))
            windows += 2 * int(g.project(ts, te)[0].size > 0)
            if frozenset(answers["PECB"][i]) != want_v:
                raise AssertionError(f"k={k}: query {i} differs from the "
                                     "oracle on the card")
            for idx in (cm, ef):
                res = {md: idx.answer(TCCSQuery(u, ts, te, k, md))
                       for md in modes}
                e_ids = res[ResultMode.EDGES].edges.edge_ids()
                if not (res[ResultMode.VERTICES].vertices == want_v
                        and res[ResultMode.EDGES].vertices == want_v
                        and e_ids == want_e
                        and res[ResultMode.SUBGRAPH].subgraph.m == len(want_e)
                        and res[ResultMode.COUNT].num_vertices == len(want_v)):
                    raise AssertionError(f"k={k}: {idx.backend_name}'s "
                                         f"answer modes differ from the "
                                         f"oracle on query {i}")
        fix = kcore_peel.kcore_fixpoint.launches - f0
        if fix != windows or fix <= 0:
            raise AssertionError(f"k={k}: the oracle made {fix} "
                                 f"kcore_fixpoint launches, expected "
                                 f"{windows} (one per window with edges)")
        oracle_fix += fix
        sizes = [len(a) for a in answers["EF"]]
        print(f"[baselines] {tag} k={k}: {len(qs)} random_queries, PECB, "
              f"CT-MSF, EF and the PECB's device batch on B1 agree on all "
              f"(0 mismatches; {sum(1 for s in sizes if s)} non-empty, "
              f"largest {max(sizes)} vertices). Host us per query (Figure "
              f"6): PECB {us_q['PECB']:.2f}, CT-MSF {us_q['CT-MSF']:.2f}, "
              f"EF {us_q['EF']:.2f}. B1 batches of {BUCKET}: "
              f"{len(qs) / t_b1:.1f} q/s ({t_b1:.4f}s with uploads and "
              f"downloads), B1 launches {b1} = rounds {stats['rounds']}. "
              f"{BASELINE_ORACLE} held to tccs_oracle and tccs_oracle_edges "
              f"on the card (kcore_fixpoint launches {fix}, one per window "
              f"and oracle) and to EF's and CT-MSF's VERTICES, EDGES, "
              f"SUBGRAPH and COUNT answers: 0 mismatches")

    fix = kcore_peel.kcore_fixpoint.launches
    if fix != probes + oracle_fix:
        raise AssertionError(f"kcore_fixpoint launches {fix} != the phase's "
                             f"fixpoints {probes + oracle_fix}")
    b1 = label_prop.label_prop_round.launches
    sweeps = ss.stratum_sweep.launches
    if sweeps != len(ks) * -(-g.t_max // ct.TUV_BLOCK):
        raise AssertionError(f"stratum_sweep launches {sweeps}, expected one "
                             f"per t_uv block of each table")
    print(f"[baselines] {tag} phase: {time.perf_counter() - t_phase:.2f}s, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"kcore_fixpoint launches {fix} (= fixpoints run: {probes} k_max "
          f"probes + {oracle_fix} oracle windows), B1 launches {b1}, "
          f"stratum_sweep launches {sweeps} (the {len(ks)} tables)")
    return fix, b1, sweeps


#: the [epoch] phase's ingest split and trim cut, from the reference's
#: benchmarks: bench_streaming.py's frac = 0.98 (epoch 0 ends on day
#: int(193 * 0.98) = 189; the days 190..193 follow as one epoch each) and
#: bench_retention.py's frac = 0.5 (t_cut = 96)
EPOCH_FRAC = 0.98
TRIM_FRAC = 0.5
#: queries of each served batch held to Algorithm 1 (kcore.tccs_oracle)
EPOCH_VERIFY = 32
#: the host engine (the reference's frontier fixpoint), timed on the last
#: daily epoch for comparison, starts no stratum after this many seconds
HOST_EXTEND_CAP_S = 30.0


@contextlib.contextmanager
def epoch_stages(times: dict):
    """Time the steps of the epoch-plane entry point called inside the
    block, summed over calls into ``times``: ``sweep_s`` (the wall of
    core_time's ``_sweep_device_stratified``: pair CSR, t_uv rows,
    uploads, launches and download), ``kernel_ms`` (CUDA events around
    each stratum_sweep launch), ``download_s`` (from the synchronize after
    the last launch to the rows on the host), ``launches`` (the wrapper's
    own count), ``rows_s`` (the host engine's rows,
    ``_extend_rows_host``), ``expand_s`` (``StratifiedCoreTable.table_for``:
    a stratum's dense rows re-expanded from its runs), ``records_s``
    (``_compress`` or the interval recompress ``_extend_records``),
    ``stratify_s`` (``StratifiedCoreTable.from_tables``) and ``layout_s``
    (``batch_query._host_layout``)."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.kernels import segmented_select as ss

    sweep_fn, kernel_fn = ct._sweep_device_stratified, ct.stratum_sweep
    events, synced = [], []
    for key in ("sweep_s", "kernel_ms", "download_s", "launches", "rows_s",
                "expand_s", "records_s", "stratify_s", "layout_s"):
        times.setdefault(key, 0)
    before = ss.stratum_sweep.launches

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times[key] += time.perf_counter() - t0
            return out
        return call

    def kernel(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = kernel_fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        events.append((start, end))
        synced.append(time.perf_counter())
        return out

    def sweep(*args, **kw):
        t0 = time.perf_counter()
        out = sweep_fn(*args, **kw)
        t1 = time.perf_counter()
        times["sweep_s"] += t1 - t0
        if synced:
            times["download_s"] += t1 - synced[-1]
            synced.clear()
        return out

    table = ct.StratifiedCoreTable
    with contextlib.ExitStack() as stack:
        for owner, name, fn in (
                (ct, "_sweep_device_stratified", sweep),
                (ct, "stratum_sweep", kernel),
                (ct, "_extend_rows_host", timed("rows_s",
                                                ct._extend_rows_host)),
                (ct, "_compress", timed("records_s", ct._compress)),
                (ct, "_extend_records", timed("records_s",
                                              ct._extend_records)),
                (table, "table_for", timed("expand_s", table.table_for)),
                (table, "from_tables", staticmethod(
                    timed("stratify_s", table.from_tables))),
                (bq, "_host_layout", timed("layout_s", bq._host_layout))):
            stack.enter_context(mock.patch.object(owner, name, fn))
        yield times
    times["kernel_ms"] += sum(s.elapsed_time(e) for s, e in events)
    times["launches"] += ss.stratum_sweep.launches - before


def staged(fn):
    """``(result, seconds, step times)`` of ``fn`` under
    :func:`epoch_stages`, the card synchronised after it."""
    times: dict = {}
    with epoch_stages(times):
        out, t = wall(fn)
    return out, t, times


def cold_build(g, dev):
    """A cold card build of ``g``'s k-stratified index through the entry
    points, its stages timed: ``(strata, sx, dix, stages)``."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core.pecb_index import build_stratified_index

    strata, t_core, core = staged(lambda: ct.stratified_core_times(
        g, engine="device", device=dev))
    sx, t_forest, forest = staged(lambda: build_stratified_index(
        g, strata=strata, device=dev))
    dix, t_up, up = staged(lambda: bq.to_device(sx, dev))
    return strata, sx, dix, dict(core=(t_core, core),
                                 forest=(t_forest, forest), up=(t_up, up))


def core_line(t_core: float, t: dict) -> str:
    """The core-time stage: the card sweep and the host steps after it."""
    line = (f"core times {t_core:.4f}s = sweep {t['sweep_s']:.4f}s "
            f"(stratum_sweep {t['kernel_ms']:.3f} ms by CUDA events, "
            f"{t['launches']} launch(es); download {t['download_s']:.4f}s)"
            f" + {'re' if t['expand_s'] else ''}compress + stratify "
            f"{t_core - t['sweep_s']:.4f}s")
    parts = [f"re-expand {t['expand_s']:.4f}s" if t["expand_s"] else "",
             f"{'interval recompress' if t['expand_s'] else 'compress'} "
             f"{t['records_s']:.4f}s",
             f"stratify (from_tables) {t['stratify_s']:.4f}s"]
    return line + f" ({', '.join(p for p in parts if p)})"


def refresh_line(t_ref: float, t: dict, rs: dict) -> str:
    return (f"refresh {t_ref:.4f}s (host layouts {t['layout_s']:.4f}s; "
            f"reused {rs['reused']}, suffix {rs['suffix']}, full "
            f"{rs['full']} arrays; reused {rs['reused_bytes'] / 1e6:.1f} MB, "
            f"uploaded {rs['uploaded_bytes'] / 1e6:.1f} MB, freed "
            f"{rs['freed_bytes'] / 1e6:.1f} MB)")


def cold_line(c: dict) -> str:
    (t_core, core), (t_forest, forest), (t_up, up) = (c["core"],
                                                      c["forest"], c["up"])
    return (f"{core_line(t_core, core)}, forest build {t_forest:.4f}s "
            f"(re-expand {forest['expand_s']:.4f}s), upload {t_up:.4f}s "
            f"(host layout {up['layout_s']:.4f}s); total "
            f"{t_core + t_forest + t_up:.4f}s")


def assert_index_equal(got, want, what: str) -> int:
    """Raise unless two indexes (or tables) are equal in every dataclass
    field, arrays by dtype and value (tolerance 0); returns the number of
    fields compared."""
    n = 0
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            n += assert_index_equal(a, b, f"{what}.{f.name}")
            continue
        same = (a.dtype == b.dtype and np.array_equal(a, b)
                if isinstance(b, np.ndarray) else a == b)
        if not same:
            raise AssertionError(f"{what}: field {f.name} differs")
        n += 1
    return n


def assert_mirror_equal(got, want, what: str) -> int:
    """Raise unless two device mirrors are equal array for array (dtype,
    device, values) and in every meta field; returns the arrays compared."""
    from repro_torch.core import batch_query as bq

    for f in bq._ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype != b.dtype or a.device != b.device or not torch.equal(a,
                                                                         b):
            raise AssertionError(f"{what}: mirror array {f} differs from "
                                 "a fresh upload's")
    for f in bq._META_FIELDS:
        if getattr(got, f) != getattr(want, f):
            raise AssertionError(f"{what}: mirror meta {f} differs")
    return len(bq._ARRAY_FIELDS)


def epoch_batch(g, sx, dix, dev, rng) -> dict:
    """One batch of BUCKET mixed-k vertex queries through
    ``batch_query_full_mixed`` on B1, every fourth window ending on the
    newest day; the first EPOCH_VERIFY held to Algorithm 1
    (``kcore.tccs_oracle``). Returns q/s, B1 launches, rounds, answers."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import kcore
    from repro_torch.kernels import label_prop

    u = rng.integers(0, g.n, BUCKET)
    k = rng.choice(np.asarray(sx.supported_ks), BUCKET)
    ts = rng.integers(1, g.t_max + 1, BUCKET)
    te = rng.integers(ts, g.t_max + 1)
    te[::4] = g.t_max
    slot = bq.mixed_slots(sx, list(zip(u.tolist(), k.tolist())))
    cols = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (slot, ts, te, k)]
    before = label_prop.label_prop_round.launches
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vmask, _ = bq.batch_query_full_mixed(dix, *cols, stats=stats)
    masks = vmask.cpu().numpy()
    t_batch = time.perf_counter() - t0
    launches = label_prop.label_prop_round.launches - before
    if launches <= 0 or launches != sum(stats["rounds"]):
        raise AssertionError(f"the batch made {launches} B1 launches for "
                             f"{stats['rounds']} rounds")
    bad = [i for i in range(EPOCH_VERIFY)
           if set(np.flatnonzero(masks[i]).tolist()) != kcore.tccs_oracle(
               g, int(k[i]), int(u[i]), int(ts[i]), int(te[i]))]
    if bad:
        raise AssertionError(f"{len(bad)} of {EPOCH_VERIFY} answers differ "
                             f"from Algorithm 1 (queries {bad[:5]})")
    newest = masks[te == g.t_max].any(axis=1)
    return dict(qps=BUCKET / t_batch, t=t_batch, launches=launches,
                rounds=stats["rounds"][0], newest=int(newest.size),
                newest_nonempty=int(newest.sum()),
                nonempty=int(masks.any(axis=1).sum()))


def batch_line(b: dict) -> str:
    return (f"batch of {BUCKET} mixed-k queries: "
            f"{b['qps']:.1f} q/s ({b['t']:.4f}s), B1 launches "
            f"{b['launches']} ({b['rounds']} rounds), {b['nonempty']} "
            f"non-empty answers, {b['newest']} windows end on the newest day "
            f"({b['newest_nonempty']} non-empty); {EPOCH_VERIFY} checked "
            f"against Algorithm 1, 0 mismatches")


def host_extend(g1, prev, want, cap: float) -> tuple[list, float, dict]:
    """The host engine (the reference's suffix sweep and frontier
    fixpoint) on one epoch, stratum by stratum in ascending k until
    ``cap`` seconds have passed; each stratum equal to ``want``'s (the
    device engine's). Returns the strata covered, the seconds and the
    step times (:func:`epoch_stages`)."""
    from repro_torch.core import core_time as ct

    done, times = [], {}
    t0 = time.perf_counter()
    with epoch_stages(times):
        for k in want.ks:
            if k not in prev.ks or time.perf_counter() - t0 > cap:
                continue
            got = ct.extend_core_times(g1, k, prev.table_for(k),
                                       engine="host")
            assert_index_equal(got, want.table_for(k), f"host engine k={k}")
            done.append(k)
    return done, time.perf_counter() - t0, times


def epoch_phase(g, sx, dix, dev) -> tuple[int, int]:
    """``[epoch]``: the epoch planes at CollegeMsg scale, driven through
    the entry points a user calls. Epoch 0 is ``g.split_at(189)``, built
    cold on the card; each of the days 190..193 is one suffix epoch
    (``extend``, ``extend_stratified_core_times(engine="device")`` with
    one stratum_sweep launch, ``extend_stratified_index``,
    ``refresh_device``), followed by one served batch on B1; the day-193
    index must equal ``sx`` (the cold build of ``g``) in every field and
    its mirror ``dix`` array for array. Then one trim
    (``expire_before(96)``, the shrinks, ``refresh_device``), equal to a
    cold card build of the trimmed graph, and one more batch. Returns the
    phase's stratum_sweep and B1 launches."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core import streaming as st
    from repro_torch.kernels import label_prop
    from repro_torch.kernels import segmented_select as ss

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(19)
    ss.reset_sweep_counts()
    label_prop.label_prop_round.launches = 0

    t_old = max(1, int(g.t_max * EPOCH_FRAC))
    cur, suffix = g.split_at(t_old)
    tab, sx_cur, dix_cur, cold = cold_build(cur, dev)
    print(f"[epoch] epoch 0 = g.split_at({t_old}): m={cur.m} t_max="
          f"{cur.t_max} |K|={len(sx_cur.ks)} N={sx_cur.num_nodes}; cold card "
          f"build: {cold_line(cold)}; after the upload, "
          + batch_line(epoch_batch(cur, sx_cur, dix_cur, dev, rng)))
    n_cold = cold["core"][1]["launches"]
    sweeps = n_cold
    for day in range(t_old + 1, g.t_max + 1):
        edges = [tuple(e) for e in suffix[suffix[:, 2] == day].tolist()]
        g1 = cur.extend(edges)
        ks = ct.default_ks(g1, device=dev)
        tab1, t_core, core = staged(
            lambda: ct.extend_stratified_core_times(g1, tab, ks,
                                                    engine="device",
                                                    device=dev))
        blocks = -(-g1.t_max // ct.TUV_BLOCK)
        if core["launches"] != blocks:
            raise AssertionError(f"day {day}'s extend made "
                                 f"{core['launches']} stratum_sweep "
                                 f"launches, expected {blocks}")
        sweeps += core["launches"]
        sx1, t_forest, forest = staged(lambda: st.extend_stratified_index(
            g1, sx_cur, ks, strata=tab1, device=dev))
        (dix1, rs), t_ref, ref_t = staged(lambda: bq.refresh_device(
            sx_cur, dix_cur, sx1))
        print(f"[epoch] day {day}: appended {g1.m - cur.m} edges (m "
              f"{cur.m} -> {g1.m}), |K| {len(tab.ks)} -> {len(ks)}, N "
              f"{sx_cur.num_nodes} -> {sx1.num_nodes}; "
              f"{core_line(t_core, core)}, forest extend {t_forest:.4f}s "
              f"(re-expand {forest['expand_s']:.4f}s), "
              f"{refresh_line(t_ref, ref_t, rs)}; epoch "
              f"{t_core + t_forest + t_ref:.4f}s; after the refresh, "
              + batch_line(epoch_batch(g1, sx1, dix1, dev, rng)))
        if day == g.t_max:
            done, t_host, host = host_extend(g1, tab, tab1,
                                             HOST_EXTEND_CAP_S)
            print(f"[epoch] day {day} on the host engine (the reference's "
                  f"suffix sweep and frontier fixpoint), capped at "
                  f"{HOST_EXTEND_CAP_S:.0f}s: {len(done)} of the "
                  f"{len(tab.ks)} strata the epoch extends (k={done[0]}.."
                  f"{done[-1]}) in {t_host:.4f}s, each equal to the device "
                  f"engine's: rows {host['rows_s']:.4f}s "
                  f"({host['rows_s'] / len(done):.4f}s per stratum), "
                  f"re-expand {host['expand_s']:.4f}s, interval recompress "
                  f"{host['records_s']:.4f}s; the device engine's rows (its "
                  f"sweep of all {len(ks)} strata) took "
                  f"{core['sweep_s']:.4f}s"
                  if done else f"[epoch] day {day}: no stratum on the host "
                  "engine within the cap")
        cur, tab, sx_cur, dix_cur = g1, tab1, sx1, dix1
    n_f = assert_index_equal(sx_cur, sx, "the day-193 index")
    n_a = assert_mirror_equal(dix_cur, dix, "the day-193 mirror")
    print(f"[epoch] day {g.t_max}: the extended index equals the cold build "
          f"of g in all {n_f} fields (tolerance 0) and its refreshed mirror "
          f"a fresh upload in all {n_a} arrays")

    t_cut = max(2, int(g.t_max * TRIM_FRAC))
    g2 = cur.expire_before(t_cut)
    ks2 = tuple(k for k in ct.default_ks(g2, device=dev) if k in tab.ks)
    tab2, t_core, core = staged(lambda: ct.shrink_stratified_core_times(
        g2, tab, ks2))
    sx2, t_forest, forest = staged(lambda: st.shrink_stratified_index(
        g2, sx_cur, ks2, strata=tab2, device=dev))
    (dix2, rs), t_ref, ref_t = staged(lambda: bq.refresh_device(
        sx_cur, dix_cur, sx2))
    if rs["freed_bytes"] <= 0:
        raise AssertionError("the trim freed no device memory")
    _, csx, cdix, cold2 = cold_build(g2, dev)
    n_cold += cold2["core"][1]["launches"]
    sweeps += cold2["core"][1]["launches"]
    n_f = assert_index_equal(sx2, csx, "the trimmed index")
    n_a = assert_mirror_equal(dix2, cdix, "the trimmed mirror")
    print(f"[epoch] trim expire_before({t_cut}): expired {cur.m - g2.m} edges "
          f"(m {cur.m} -> {g2.m}, t_max {cur.t_max} -> {g2.t_max}), |K| "
          f"{len(tab.ks)} -> {len(ks2)}, N {sx_cur.num_nodes} -> "
          f"{sx2.num_nodes}; core times {t_core:.4f}s (re-expand "
          f"{core['expand_s']:.4f}s, stratify {core['stratify_s']:.4f}s), "
          f"forest shrink {t_forest:.4f}s (re-expand "
          f"{forest['expand_s']:.4f}s), {refresh_line(t_ref, ref_t, rs)}; "
          f"trim {t_core + t_forest + t_ref:.4f}s; equal to the cold card "
          f"build of the trimmed graph in all {n_f} fields and {n_a} mirror "
          f"arrays; that build: {cold_line(cold2)}; after the refresh, "
          + batch_line(epoch_batch(g2, sx2, dix2, dev, rng)))
    if ss.stratum_sweep.launches != sweeps:
        raise AssertionError("stratum_sweep launches outside the timed "
                             "builds and extends")
    b1 = label_prop.label_prop_round.launches
    print(f"[epoch] phase: stratum_sweep launches {sweeps} (cold builds "
          f"{n_cold}, extends {sweeps - n_cold}), B1 launches {b1}; "
          f"{time.perf_counter() - t_phase:.2f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the "
          f"batches' (256, V) version masks)")
    return sweeps, b1


#: the [engine] phase: bench_engine.py's engine settings and traffic
ENGINE_QUERIES = 2048
ENGINE_CHUNK = 256
ENGINE_THREADS = 4
ENGINE_LOADS = (250.0, 1000.0)
ENGINE_VERIFY = 256
ENGINE_STRAGGLERS = 32
ENGINE_EDGES = 16
#: queries per submission of the thread that serves during the ingests
INGEST_CHUNK = 64


def pct(xs, q) -> float:
    """The q-th percentile of a list of seconds, in ms (0 when empty)."""
    return float(np.percentile(np.asarray(xs), q)) * 1e3 if xs else 0.0


def submit_all(eng, name, specs, threads: int = 1,
               chunk: int = ENGINE_CHUNK) -> tuple[list, float]:
    """``specs`` through ``submit_specs`` in chunks, chunk i from caller
    thread i % threads, then one flush: the results in order and the
    seconds from the first submission to the last answer."""
    chunks = [specs[i:i + chunk] for i in range(0, len(specs), chunk)]
    futs = [None] * len(chunks)

    def caller(t):
        for i in range(t, len(chunks), threads):
            futs[i] = eng.submit_specs(name, chunks[i])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(caller, t) for t in range(threads)]:
            f.result()
    eng.flush()
    results = [f.result(timeout=300) for fs in futs for f in fs]
    return results, time.perf_counter() - t0


def paced(eng, name, specs, load: float) -> tuple[list, float]:
    """``specs`` one at a time at ``load`` queries/s, as
    ``benchmarks/bench_engine.py`` paces an offered load."""
    t0 = time.perf_counter()
    period = 1.0 / load
    futures = []
    for i, q in enumerate(specs):
        delay = t0 + i * period - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futures.append(eng.submit_spec(name, q))
    eng.flush()
    results = [f.result(timeout=300) for f in futures]
    return results, time.perf_counter() - t0


def check_alg1(pecb, specs, results, what: str, n: int = ENGINE_VERIFY
               ) -> int:
    """``n`` answers spread over the stream against Algorithm 1 on the
    host (``pecb.answer``); raises on a mismatch. Edge modes compare the
    member edge ids too."""
    idx = np.linspace(0, len(specs) - 1, min(n, len(specs))).astype(int)
    bad = []
    for i in idx.tolist():
        want, got = pecb.answer(specs[i]), results[i]
        same = (got.vertices == want.vertices
                and got.num_vertices == want.num_vertices)
        if want.edges is not None:
            same = same and got.edges.edge_ids() == want.edges.edge_ids()
        if not same:
            bad.append(i)
    if bad:
        raise AssertionError(f"[engine] {what}: {len(bad)} of {len(idx)} "
                             f"answers differ from Algorithm 1 ({bad[:5]})")
    return len(idx)


def traffic_line(eng, results, t: float, rounds: list) -> str:
    """q/s, e2e percentiles and route counts of one replay, read from the
    engine's metrics, which are then reset; the replay's propagation
    rounds are added to ``rounds`` first."""
    snap = eng.metrics.snapshot(include_sources=False)
    c, e2e = snap["counters"], snap["latency"].get("e2e", {})
    rounds.append(c.get("propagation_rounds", 0))
    eng.metrics.reset()
    routes = dict(collections.Counter(r.provenance.route for r in results))
    return (f"{len(results) / t:.1f} q/s ({len(results)} in {t:.4f}s); e2e "
            f"p50 {e2e.get('p50_ms', 0):.3f} p95 {e2e.get('p95_ms', 0):.3f} "
            f"p99 {e2e.get('p99_ms', 0):.3f} ms; device batches "
            f"{c.get('device_batches', 0)}, host batches "
            f"{c.get('host_batches', 0)}, padded slots "
            f"{c.get('device_padded_slots', 0)}; B1 rounds "
            f"{c.get('propagation_rounds', 0)}; routes {routes}")


def serve_during_ingest(eng, name, ks, t_last: int, seed: int):
    """One caller thread submitting INGEST_CHUNK mixed-k vertex specs at a
    time (windows ending on ``t_last``, the newest day to come) until
    ``stop`` is set, each chunk awaited. Returns (thread, stop event,
    records [(t_submit, t_done, spec, result)])."""
    from repro_torch.core.query_api import TCCSQuery

    stop = threading.Event()
    records = []
    rng = np.random.default_rng(seed)
    n = eng.registry.resolve_graph(name).n

    def run():
        while not stop.is_set():
            specs = [TCCSQuery(int(rng.integers(0, n)),
                               int(rng.integers(1, t_last - 4)), t_last,
                               int(rng.choice(ks)))
                     for _ in range(INGEST_CHUNK)]
            t0 = time.perf_counter()
            futs = eng.submit_specs(name, specs)
            eng.flush()
            for q, f in zip(specs, futs):
                r = f.result(timeout=300)
                records.append((t0, time.perf_counter(), q, r))

    th = threading.Thread(target=run, name="ingest-traffic")
    th.start()
    return th, stop, records


def engine_phase(g, sx, dev, smi: str) -> tuple[int, int]:
    """``[engine]``: the port's serving engine on the card at CollegeMsg
    scale, through the entry points a user calls. Epoch 0 =
    ``g.split_at(189)``, registered by name; ``warmup`` runs the registry's
    cold build on the card; then open-loop traffic from four caller
    threads, paced offered loads, stragglers on the host route, a cached
    replay, a window sweep, an edges-mode batch, the days 190..193 ingested
    one at a time while a caller thread keeps serving, and one trim. Every
    stream's sampled answers are held to Algorithm 1, the day-193 handle to
    ``sx`` (the cold build of ``g``) and the trimmed one to a cold card
    build. Returns the phase's B1 and stratum_sweep launches, each checked
    against the rounds and builds the engine ran."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core.query_api import ResultMode, TCCSQuery, WindowSweep
    from repro_torch.core.temporal_graph import random_queries
    from repro_torch.kernels import kcore_peel, label_prop
    from repro_torch.kernels import segmented_select as ss
    from repro_torch.launch import serve
    from repro_torch.serving import EngineConfig, ServingEngine

    tag = f"({smi})"
    t_phase = time.perf_counter()
    ss.reset_sweep_counts()
    label_prop.label_prop_round.launches = 0
    fix0 = kcore_peel.kcore_fixpoint.launches
    rounds: list = []
    name = "collegemsg"
    t_old = max(1, int(g.t_max * EPOCH_FRAC))
    g0, suffix = g.split_at(t_old)
    cfg = EngineConfig(max_batch=256, flush_ms=2.0, cache_capacity=0)
    with ServingEngine(cfg, device=dev) as eng:
        eng.register_graph(name, g0)
        h, t_warm = wall(lambda: eng.warmup(name))
        builds = ss.stratum_sweep.launches
        print(f"[engine] {tag} cold build through warmup: epoch 0 = "
              f"g.split_at({t_old}), m={g0.m}, |K|={len(h.supported_ks)}, "
              f"N={h.pecb.num_nodes}; {h.build_seconds:.4f}s (stages "
              + ", ".join(f"{s} {v:.4f}s" for s, v in h.build_stages.items())
              + f"), warmup {t_warm:.4f}s with the buckets 8..256; "
              f"stratum_sweep launches {builds}; kernel builds "
              f"{eng.metrics.counter('kernel_builds')} (B1's library was "
              f"loaded in [build])")
        rounds.append(eng.metrics.counter("propagation_rounds"))
        eng.metrics.reset()

        rng = np.random.default_rng(10)
        specs = [TCCSQuery(u, ts, te, int(rng.choice(h.supported_ks)))
                 for (u, ts, te) in random_queries(g0, ENGINE_QUERIES,
                                                   seed=9)]
        res, t = submit_all(eng, name, specs, threads=ENGINE_THREADS)
        n_ok = check_alg1(h.pecb, specs, res, "open loop")
        first = res
        print(f"[engine] {tag} open loop, {ENGINE_QUERIES} mixed-k specs in "
              f"chunks of {ENGINE_CHUNK} from {ENGINE_THREADS} threads: "
              + traffic_line(eng, res, t, rounds)
              + f"; {n_ok} checked against Algorithm 1, 0 mismatches")
        for load in ENGINE_LOADS:
            res, t = paced(eng, name, specs, load)
            n_ok = check_alg1(h.pecb, specs, res, f"offered {load:g} q/s")
            print(f"[engine] {tag} offered load {load:g} q/s: "
                  + traffic_line(eng, res, t, rounds)
                  + f"; {n_ok} checked, 0 mismatches")

        strag = [specs[i:i + 3] for i in range(0, 3 * ENGINE_STRAGGLERS, 3)]
        res = []
        t0 = time.perf_counter()
        for batch in strag:
            futs = eng.submit_specs(name, batch)
            eng.flush()
            res += [f.result(timeout=300) for f in futs]
        t = time.perf_counter() - t0
        flat = [q for b in strag for q in b]
        c = eng.metrics.snapshot(include_sources=False)["counters"]
        if (c.get("host_batches"), c.get("device_batches", 0)) != (
                ENGINE_STRAGGLERS, 0):
            raise AssertionError(f"[engine] stragglers: routes {c}")
        check_alg1(h.pecb, flat, res, "stragglers")
        # the engine's executor: its rounds count in the engine's metrics
        dev_masks = eng.executor.run(
            h.device, bq.mixed_slots(h.pecb, [(q.u, q.k) for q in flat]),
            [q.ts for q in flat], [q.te for q in flat],
            eng.executor.final_bucket(len(flat), 8, 256))
        if any(frozenset(np.flatnonzero(m).tolist()) != r.vertices
               for m, r in zip(dev_masks, res)):
            raise AssertionError("[engine] stragglers: the host route "
                                 "disagrees with a device batch")
        print(f"[engine] {tag} stragglers, {ENGINE_STRAGGLERS} submissions "
              f"of 3 flushed one at a time: " + traffic_line(eng, res, t,
                                                            rounds)
              + "; every answer equal to Algorithm 1 and to one device "
              "batch of the same specs (its B1 rounds are those above)")

        ccfg = EngineConfig(max_batch=256, flush_ms=2.0, cache_capacity=4096)
        with ServingEngine(ccfg, registry=eng.registry, device=dev) as ce:
            res1, t1 = submit_all(ce, name, specs)
            line1 = traffic_line(ce, res1, t1, rounds)
            res2, t2 = submit_all(ce, name, specs)
            share = sum(r.provenance.route == "cache" for r in res2) / len(
                res2)
            if any(a.vertices != b.vertices for a, b in zip(res2, res1)) or \
                    any(a.vertices != b.vertices for a, b in zip(res1, first)):
                raise AssertionError("[engine] cached answers differ")
            print(f"[engine] {tag} cache (4,096 entries), the open-loop "
                  f"stream twice: first pass {line1}; second pass "
                  + traffic_line(ce, res2, t2, rounds)
                  + f"; cache share {share:.4f}, answers equal the first "
                  "pass's and the open loop's")

        k_sweep = h.supported_ks[len(h.supported_ks) // 4]
        windows = [(d, min(d + 40, g.t_max)) for d in range(1, 65)]
        (sw, t_sw) = wall(lambda: eng.sweep(name, WindowSweep(
            u=0, k=k_sweep, windows=windows)))
        direct = serve.serve_sweep(h.pecb, h.device, 0, k_sweep, windows)
        rounds.append(sum(direct["rounds"]))
        c = eng.metrics.snapshot(include_sources=False)["counters"]
        rounds.append(c.get("propagation_rounds", 0))
        eng.metrics.reset()
        if [r.vertices for r in sw] != direct["answers"]:
            raise AssertionError("[engine] sweep differs from serve_sweep")
        print(f"[engine] {tag} sweep u=0 k={k_sweep}, {len(windows)} "
              f"windows: {t_sw:.4f}s, {c.get('sweep_launches', 0)} device "
              f"batch(es), equal to serve.serve_sweep's answers (each "
              f"checked against Algorithm 1, 0 mismatches)")

        torch.cuda.reset_peak_memory_stats()
        ecfg = EngineConfig(max_batch=ENGINE_EDGES, flush_ms=2.0,
                            cache_capacity=0)
        # the busiest vertices at the three lowest k over long windows:
        # components with many member edges to check
        deg = np.bincount(np.concatenate([g0.src, g0.dst]), minlength=g0.n)
        modes = (ResultMode.EDGES, ResultMode.SUBGRAPH)
        especs = [TCCSQuery(int(u), 1 + 20 * (i % 4), g0.t_max,
                            h.supported_ks[i % 3], modes[i % 2])
                  for i, u in enumerate(np.argsort(deg)[-ENGINE_EDGES:])]
        with ServingEngine(ecfg, registry=eng.registry, device=dev) as ee:
            res, t = submit_all(ee, name, especs, chunk=ENGINE_EDGES)
            check_alg1(h.pecb, especs, res, "edges")
            line = traffic_line(ee, res, t, rounds)
        if min(r.num_edges for r in res) == 0:
            raise AssertionError("[engine] edges: an empty component")
        print(f"[engine] {tag} edges: {ENGINE_EDGES} EDGES and SUBGRAPH "
              f"specs at max_batch {ENGINE_EDGES}: {line}; "
              f"{sum(r.num_edges for r in res)} member edges (each answer "
              f"{min(r.num_edges for r in res)}.."
              f"{max(r.num_edges for r in res)}), every edge set equal to "
              f"Algorithm 1's; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the "
              f"({ENGINE_EDGES}, V) version masks, V = "
              f"{h.device.num_versions:,})")

        # -- ingest while serving ------------------------------------------
        th, stop, recs = serve_during_ingest(eng, name, h.supported_ks,
                                             g.t_max, seed=12)
        time.sleep(1.0)                       # the baseline before any ingest
        spans, handles = [], {t_old: h}
        cur = g0
        for day in range(t_old + 1, g.t_max + 1):
            edges = [tuple(e) for e in suffix[suffix[:, 2] == day].tolist()]
            t0 = time.perf_counter()
            fut = eng.ingest(name, edges)[name]
            hd = fut.result(timeout=300)
            t1 = time.perf_counter()
            cur = cur.extend(edges)
            handles[day] = hd
            spans.append((day, t0, t1, hd))
            time.sleep(0.5)                   # serve the new epoch a while
        stop.set()
        th.join(timeout=300)
        if th.is_alive():
            raise AssertionError("[engine] the serving thread is stuck")
        eng.drain(timeout=300)
        base = [b - a for a, b, _, _ in recs if b < spans[0][1]]
        during = [b - a for a, b, _, _ in recs
                  if any(t0 <= a < t1 for _, t0, t1, _ in spans)]
        for day, t0, t1, hd in spans:
            old = sum(1 for a, _, _, r in recs
                      if t0 <= a < t1 and r.query.te == day - 1)
            print(f"[engine] {tag} ingest day {day}: refresh "
                  f"{hd.build_seconds:.4f}s (" + ", ".join(
                      f"{s} {v:.4f}s" for s, v in hd.build_stages.items())
                  + f"), ingest to swap {t1 - t0:.4f}s; {old} answers "
                  f"served from epoch {day - 1 - t_old} while it ran")
        by_epoch = collections.defaultdict(list)
        for _, _, q, r in recs:
            by_epoch[r.query.te].append((q, r))
        n_ok = 0
        for te, pairs in sorted(by_epoch.items()):
            qs, rs = zip(*pairs)
            n_ok += check_alg1(handles[te].pecb, list(qs), list(rs),
                               f"ingest, epoch ending {te}",
                               n=ENGINE_VERIFY // len(by_epoch) + 1)
        print(f"[engine] {tag} served during the ingests: {len(recs)} "
              f"queries in chunks of {INGEST_CHUNK}; p99 before any ingest "
              f"{pct(base, 99):.3f} ms (p50 {pct(base, 50):.3f}, "
              f"{len(base)} queries), p99 while a refresh was in flight "
              f"{pct(during, 99):.3f} ms (p50 {pct(during, 50):.3f}, "
              f"{len(during)} queries); {n_ok} checked against Algorithm 1 "
              f"on their own epoch, 0 mismatches")
        c = eng.metrics.snapshot(include_sources=False)["counters"]
        rounds.append(c.get("propagation_rounds", 0))
        eng.metrics.reset()
        hd = eng.registry.get_nowait(name)
        n_f = assert_index_equal(hd.pecb, sx, "the day-193 handle")
        rng = np.random.default_rng(13)
        vspecs = [TCCSQuery(u, ts, te, int(rng.choice(hd.supported_ks)))
                  for (u, ts, te) in random_queries(g, ENGINE_VERIFY,
                                                    seed=14)]
        res, t = submit_all(eng, name, vspecs)
        check_alg1(hd.pecb, vspecs, res, "day 193")
        print(f"[engine] {tag} day {g.t_max}: the handle equals the cold "
              f"build of g in all {n_f} fields (tolerance 0); "
              f"{len(vspecs)} queries: " + traffic_line(eng, res, t, rounds)
              + ", 0 mismatches against Algorithm 1")

        # -- trim --------------------------------------------------------
        t_cut = max(2, int(g.t_max * TRIM_FRAC))
        (futs, t_trim) = wall(lambda: eng.retain(name, t_cut, wait=True,
                                                 timeout=300))
        ht = futs[name].result()
        freed = eng.metrics.counter("retention_freed_bytes")
        g2 = cur.expire_before(t_cut)
        _, csx, cdix, _ = cold_build(g2, dev)
        n_f = assert_index_equal(ht.pecb, csx, "the trimmed handle")
        n_a = assert_mirror_equal(ht.device, cdix, "the trimmed mirror")
        tspecs = [TCCSQuery(u, ts, te, int(rng.choice(ht.supported_ks)))
                  for (u, ts, te) in random_queries(g2, ENGINE_VERIFY,
                                                    seed=15)]
        res, t = submit_all(eng, name, tspecs)
        check_alg1(ht.pecb, tspecs, res, "after the trim")
        print(f"[engine] {tag} trim retain({t_cut}): {t_trim:.4f}s, "
              f"{freed / 1e6:.1f} MB freed, the handle equal to the cold card "
              f"build of the trimmed graph in all {n_f} fields and {n_a} "
              f"mirror arrays; {len(tspecs)} queries: "
              + traffic_line(eng, res, t, rounds) + ", 0 mismatches")

        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "engine_trace.json"
            eng.export_trace(str(path))
            doc = json.loads(path.read_text())
        names = collections.Counter(e["name"] for e in doc["traceEvents"]
                                    if e["ph"] == "X")
        print(f"[engine] {tag} trace: {len(doc['traceEvents'])} events load "
              f"as JSON ({doc['otherData']['dropped_spans']} spans dropped "
              f"by the ring), spans by name {dict(names)}")

    b1 = label_prop.label_prop_round.launches
    sweeps = ss.stratum_sweep.launches
    if b1 <= 0 or b1 != sum(rounds):
        raise AssertionError(f"[engine] B1 launches {b1} != rounds run "
                             f"{sum(rounds)}")
    # one launch per t_uv block of each card sweep: the cold build of
    # epoch 0, each ingest's extend, the trimmed graph's cold build
    want = sum(-(-t // ct.TUV_BLOCK)
               for t in [t_old, *range(t_old + 1, g.t_max + 1), g2.t_max])
    if sweeps != want:
        raise AssertionError(f"[engine] stratum_sweep launches {sweeps}, "
                             f"expected {want}")
    print(f"[engine] {tag} phase: B1 launches {b1} (= the rounds the "
          f"engines' executors and serve_sweep ran, counted exactly across "
          f"the batcher worker threads), "
          f"stratum_sweep launches {sweeps} (cold build, 4 ingests, the "
          f"trimmed graph's cold build), kcore_fixpoint launches "
          f"{kcore_peel.kcore_fixpoint.launches - fix0}; "
          f"{time.perf_counter() - t_phase:.2f}s")
    return b1, sweeps


#: the [store] phase: the ingest feed's engine settings, no cache (every
#: answer must show the index's own provenance), and the CLI's workload
STORE_VERIFY = 256
STORE_CLI = ("--workload", "fb_like", "--queries", "256", "--batch", "64")


def store_commits(store, before: dict, what: str) -> dict:
    """The one commit ``store`` made since its stats read ``before``: its
    mode and bytes, and the ``store_commit`` span's seconds."""
    st = store.stats()
    modes = [m for m in ("full", "delta", "noop")
             if st[f"commits_{m}"] > before[f"commits_{m}"]]
    if st["commits"] + st["commits_noop"] != before["commits"] + before[
            "commits_noop"] + 1 or len(modes) != 1:
        raise AssertionError(f"[store] {what}: expected one commit, stats "
                             f"{before} -> {st}")
    span = store.tracer.spans("store_commit")[-1]
    return dict(mode=modes[0], seconds=span.duration_s,
                bytes=st["bytes_written"] - before["bytes_written"])


def commit_line(c: dict) -> str:
    return (f"{c['mode']} commit {c['bytes'] / 1e6:.3f} MB in "
            f"{c['seconds']:.4f}s")


def dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def store_phase(g, dev, smi: str) -> tuple[int, int]:
    """``[store]``: the disk tier (A6) at CollegeMsg scale, through the
    entry points a user calls. An engine with ``store_dir`` builds epoch
    0 = ``g.split_at(189)`` cold on the card and writes it through, ingests
    the days 190..193 (one delta commit each), trims with retain(96) and
    closes. A second engine on the same directory adopts the graph and
    promotes the stored index to the card with no build: equal to a cold
    card build of the trimmed graph in every field and mirror array; 256
    mixed-k answers through B1 with provenance ``disk`` equal to
    Algorithm 1, 16 EDGES specs at max_batch 16; one more day ingested
    onto the promoted handle as a delta commit, equal to a cold build.
    Then a corrupted newest segment (the previous epoch recovered and
    promoted), every manifest deleted (a cold build, the asserted
    outcome), the serving CLI twice on one store (the second run
    promoted), and graphsage-reddit's parameters checkpointed from the
    card and restored onto it bit-equal. Returns the phase's B1 and
    stratum_sweep launches, each checked against the rounds and builds the
    engines ran."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import core_time as ct
    from repro_torch.core.query_api import ResultMode, TCCSQuery
    from repro_torch.core.temporal_graph import random_queries
    from repro_torch.kernels import label_prop
    from repro_torch.kernels import segmented_select as ss
    from repro_torch.models import gnn
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.store import segment as seg
    from repro_torch.store.index_store import key_dirname

    tag = f"({smi})"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ss.reset_sweep_counts()
    label_prop.label_prop_round.launches = 0
    name = "collegemsg"
    root = tempfile.mkdtemp(prefix="store-")
    keydir = Path(root) / key_dirname(name)
    cfg = EngineConfig(store_dir=root, max_batch=256, flush_ms=2.0,
                       cache_capacity=0)
    t_old = max(1, int(g.t_max * EPOCH_FRAC))
    g0, suffix = g.split_at(t_old)
    stores, registries, rounds = [], [], []

    def engine(**kw):
        eng = ServingEngine(kw.pop("config", cfg), device=dev, **kw)
        if eng.store is not None:
            stores.append(eng.store)
            registries.append(eng.registry)
        return eng

    def sweeps_since(before: int, want: int, what: str) -> int:
        got = ss.stratum_sweep.launches - before
        if got != want:
            raise AssertionError(f"[store] {what}: stratum_sweep launches "
                                 f"{got}, expected {want}")
        return got

    try:
        # -- 1. the first process: cold build, ingests, trim ----------------
        with engine() as eng:
            eng.register_graph(name, g0)
            st0 = eng.store.stats()
            h0 = eng.warmup(name)
            c = store_commits(eng.store, st0, "epoch 0")
            if (h0.source, c["mode"]) != ("build", "full"):
                raise AssertionError(f"[store] epoch 0: {h0.source}, {c}")
            t_cold = h0.build_seconds
            print(f"[store] {tag} epoch 0 = g.split_at({t_old}), m={g0.m}: "
                  f"cold card build {t_cold:.4f}s (" + ", ".join(
                      f"{s} {v:.4f}s" for s, v in h0.build_stages.items())
                  + f"); write-through {commit_line(c)}")
            cur = g0
            for day in range(t_old + 1, g.t_max + 1):
                edges = [tuple(e) for e in suffix[suffix[:, 2] == day].tolist()]
                st0, s0 = eng.store.stats(), ss.stratum_sweep.launches
                hd = eng.ingest(name, edges)[name].result(timeout=300)
                cur = cur.extend(edges)
                sweeps_since(s0, 1, f"ingest of day {day}")
                c = store_commits(eng.store, st0, f"day {day}")
                print(f"[store] {tag} ingest day {day} ({len(edges)} edges, "
                      f"epoch {hd.epoch}): refresh {hd.build_seconds:.4f}s, "
                      f"1 stratum_sweep launch; {commit_line(c)}")
            t_cut = max(2, int(g.t_max * TRIM_FRAC))
            st0 = eng.store.stats()
            ht = eng.retain(name, t_cut, wait=True, timeout=300)[name].result()
            c = store_commits(eng.store, st0, "trim")
            g_trim = cur.expire_before(t_cut)
            print(f"[store] {tag} trim retain({t_cut}) (epoch {ht.epoch}): "
                  f"shrink {ht.build_seconds:.4f}s; {commit_line(c)}; "
                  f"{dir_bytes(root) / 1e6:.1f} MB on disk; the engine "
                  "closes")
            rounds.append(eng.metrics.counter("propagation_rounds"))

        # -- 2. warm restart: adopt the graph, promote, no build ------------
        s0 = ss.stratum_sweep.launches
        with engine() as eng:
            hp, t_warm = wall(lambda: eng.warmup(name))
            sweeps_since(s0, 0, "warm restart")
            st = eng.registry.stats()
            if (hp.source, st["promotions"], st["builds"], hp.epoch) != (
                    "disk", 1, 0, ht.epoch):
                raise AssertionError(f"[store] warm restart: source "
                                     f"{hp.source}, registry {st}")
            if hp.device.device != dev:
                raise AssertionError("[store] the promoted mirror is not on "
                                     "the card")
            stages = hp.build_stages
            print(f"[store] {tag} warm restart: warmup {t_warm:.4f}s, "
                  f"source disk, promotions 1, builds 0, stratum_sweep "
                  f"launches 0; promotion {hp.build_seconds:.4f}s = "
                  f"open_latest with crc32 verification "
                  f"{stages['open']:.4f}s + from_parts "
                  f"{stages['assemble']:.4f}s + upload to the card "
                  f"{stages['device']:.4f}s ({hp.device.nbytes() / 1e6:.1f} "
                  f"MB), against the cold build's {t_cold:.4f}s "
                  f"({t_cold / hp.build_seconds:.1f}x); "
                  f"{eng.store.stats()['load_bytes'] / 1e6:.1f} MB loaded")
            s0 = ss.stratum_sweep.launches
            _, csx, cdix, _ = cold_build(g_trim, dev)
            sweeps_since(s0, 1, "the trimmed graph's cold build")
            n_f = assert_index_equal(hp.pecb, csx, "the promoted handle")
            n_a = assert_mirror_equal(hp.device, cdix, "the promoted mirror")
            print(f"[store] {tag} the promoted handle equals a cold card "
                  f"build of the trimmed graph in all {n_f} fields and its "
                  f"mirror in all {n_a} arrays (tolerance 0)")

            # -- 3. serve from it ---------------------------------------
            rng = np.random.default_rng(10)
            specs = [TCCSQuery(u, ts, te, int(rng.choice(hp.supported_ks)))
                     for (u, ts, te) in random_queries(g_trim, STORE_VERIFY,
                                                       seed=9)]
            res, t = submit_all(eng, name, specs)
            routes = collections.Counter(r.provenance.route for r in res)
            if routes != {"disk": len(specs)}:
                raise AssertionError(f"[store] routes {dict(routes)}")
            n_ok = check_alg1(hp.pecb, specs, res, "promoted",
                              n=STORE_VERIFY)
            c = eng.metrics.snapshot(include_sources=False)["counters"]
            print(f"[store] {tag} {len(specs)} mixed-k specs from the "
                  f"promoted handle: {len(specs) / t:.1f} q/s, device "
                  f"batches {c.get('device_batches', 0)}, B1 rounds "
                  f"{c.get('propagation_rounds', 0)}; routes "
                  f"{dict(routes)}; {n_ok} checked against Algorithm 1, 0 "
                  "mismatches")
            ecfg = EngineConfig(max_batch=ENGINE_EDGES, flush_ms=2.0,
                                cache_capacity=0)
            deg = np.bincount(np.concatenate([g_trim.src, g_trim.dst]),
                              minlength=g_trim.n)
            modes = (ResultMode.EDGES, ResultMode.SUBGRAPH)
            especs = [TCCSQuery(int(u), 1 + 10 * (i % 4), g_trim.t_max,
                                hp.supported_ks[i % 3], modes[i % 2])
                      for i, u in enumerate(np.argsort(deg)[-ENGINE_EDGES:])]
            with engine(config=ecfg, registry=eng.registry) as ee:
                eres, _ = submit_all(ee, name, especs, chunk=ENGINE_EDGES)
                check_alg1(hp.pecb, especs, eres, "promoted edges")
                rounds.append(ee.metrics.counter("propagation_rounds"))
            if {r.provenance.route for r in eres} != {"disk"}:
                raise AssertionError("[store] edges: a route other than disk")
            print(f"[store] {tag} {ENGINE_EDGES} EDGES and SUBGRAPH specs at "
                  f"max_batch {ENGINE_EDGES}: route disk, "
                  f"{sum(r.num_edges for r in eres)} member edges, every "
                  "edge set equal to Algorithm 1's")

            # -- 4. ingest onto the promoted handle -------------------------
            day = g_trim.t_max
            edges = [(int(u), int(v), day + 1) for u, v, t in zip(
                g_trim.src, g_trim.dst, g_trim.t) if t == day]
            st0, s0 = eng.store.stats(), ss.stratum_sweep.launches
            hi = eng.ingest(name, edges)[name].result(timeout=300)
            sweeps_since(s0, 1, "the ingest after promotion")
            c = store_commits(eng.store, st0, "ingest after promotion")
            if c["mode"] != "delta":
                raise AssertionError(f"[store] the ingest after promotion "
                                     f"made a {c['mode']} commit")
            g_grown = g_trim.extend(edges)
            s0 = ss.stratum_sweep.launches
            _, gsx, gdix, _ = cold_build(g_grown, dev)
            sweeps_since(s0, 1, "the grown graph's cold build")
            n_f = assert_index_equal(hi.pecb, gsx, "the ingested handle")
            n_a = assert_mirror_equal(hi.device, gdix, "the ingested mirror")
            print(f"[store] {tag} ingest after promotion: day {day} "
                  f"re-appended as day {day + 1} ({len(edges)} edges, epoch "
                  f"{hi.epoch}), refresh {hi.build_seconds:.4f}s from the "
                  f"mmap-backed arrays; {commit_line(c)} onto the promoted "
                  f"chain; equal to a cold card build of the grown graph in "
                  f"all {n_f} fields and {n_a} mirror arrays")
            rounds.append(eng.metrics.counter("propagation_rounds"))
        del gsx, gdix

        # -- 5. recovery -------------------------------------------------
        newest, prev = [json.loads((keydir / n).read_text()) for _, n in
                        seg.list_manifests(str(keydir))[:2]]
        part = next(p for ent in newest["arrays"].values()
                    for p in ent["parts"]
                    if p["segment"] not in prev["segments"])
        with open(keydir / part["segment"], "r+b") as f:
            f.seek(part["offset"])
            byte = f.read(1)
            f.seek(part["offset"])
            f.write(bytes([byte[0] ^ 0xFF]))
        s0 = ss.stratum_sweep.launches
        with engine() as eng:
            eng.register_graph(name, g_trim)   # the last good commit's graph
            hr = eng.warmup(name)
            sweeps_since(s0, 0, "recovery")
            st = eng.store.stats()
            opened = eng.store.tracer.spans("store_open")[-1].attrs
            if hr.source != "disk" or opened["epoch"] != prev["epoch"] or \
                    st["recovered_commits"] < 1:
                raise AssertionError(f"[store] recovery: {hr.source}, "
                                     f"{opened}, {st}")
            n_f = assert_index_equal(hr.pecb, csx, "the recovered handle")
            n_a = assert_mirror_equal(hr.device, cdix, "the recovered mirror")
            rounds.append(eng.metrics.counter("propagation_rounds"))
        print(f"[store] {tag} recovery: one byte of {part['segment']} "
              f"flipped (epoch {newest['epoch']}'s delta); the reopened store "
              f"skipped {st['recovered_commits']} commit(s) and promoted "
              f"epoch {opened['epoch']} in {hr.build_seconds:.4f}s, equal to its "
              f"cold card build in all {n_f} fields and {n_a} mirror arrays")
        del csx, cdix
        for man in keydir.glob("manifest_*.json"):
            man.unlink()
        s0 = ss.stratum_sweep.launches
        with engine() as eng:
            eng.register_graph(name, g_trim)
            hb = eng.warmup(name)
            sweeps_since(s0, 1, "the cold build after total loss")
            if hb.source != "build" or eng.registry.stats()["builds"] != 1:
                raise AssertionError(f"[store] total loss: source "
                                     f"{hb.source}")
            rounds.append(eng.metrics.counter("propagation_rounds"))
        print(f"[store] {tag} every manifest deleted: warmup fell back to a "
              f"cold card build (source build, {hb.build_seconds:.4f}s), the "
              "one case in which a rebuild is the asserted outcome")

        # -- 6. the CLI on one store, twice --------------------------------
        cli_root = tempfile.mkdtemp(prefix="store-cli-")
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        outs = []
        for extra in ((), ("--expect-warm",)):
            cmd = [sys.executable, "-m", "repro_torch.launch.serve",
                   *STORE_CLI, "--store-dir", cli_root, *extra]
            (p, t) = wall(lambda: subprocess.run(
                cmd, capture_output=True, text=True, timeout=300, env=env))
            if p.returncode:
                raise AssertionError(f"[store] CLI {extra} exited "
                                     f"{p.returncode}:\n{p.stdout[-3000:]}"
                                     f"\n{p.stderr[-3000:]}")
            lines = p.stdout.splitlines()
            warm = next(x for x in lines if x.startswith("[warmup]"))
            verify = next(x for x in lines if x.startswith("[verify]"))
            store_line = next(x for x in lines if x.startswith("[store]"))
            if not verify.endswith(" 0 mismatches"):
                raise AssertionError(f"[store] CLI: {verify}")
            outs.append((warm, store_line, verify, t))
        if "index built" not in outs[0][0] or \
                "index promoted from store" not in outs[1][0]:
            raise AssertionError(f"[store] CLI: {outs}")
        for (warm, store_line, verify, t), what in zip(outs, (
                "first run", "second run, --expect-warm")):
            print(f"[store] {tag} CLI {' '.join(STORE_CLI)} --store-dir "
                  f"({what}, {t:.2f}s): {warm} | "
                  f"{store_line.split(' ', 2)[2]} | {verify}")
        shutil.rmtree(cli_root, ignore_errors=True)

        # -- 7. the checkpoint manager on the card -------------------------
        spec = configs.get(GNN_ARCH)
        mcfg = configs.cell_model_cfg(spec, GNN_SHAPE)
        model = gnn.init_params(mcfg, torch.Generator(device=dev).manual_seed(
            GNN_SEED), device=dev)
        sd = model.state_dict()
        n_params = sum(v.numel() for v in sd.values())
        mgr = CheckpointManager(tempfile.mkdtemp(prefix="ckpt-"))
        _, t_save = wall(lambda: mgr.save(1, sd, {"arch": GNN_ARCH}))
        _, t_async = wall(lambda: mgr.save_async(2, sd))
        _, t_wait = wall(mgr.wait)
        for step in (1, 2):
            (got_step, got, _), t_rest = wall(lambda: mgr.restore(
                step, device=dev))
            if got_step != step or list(got) != list(sd) or not all(
                    v.device == dev
                    and v.dtype == sd[k].dtype and torch.equal(v, sd[k])
                    for k, v in got.items()):
                raise AssertionError(f"[store] checkpoint step {step} is not "
                                     f"bit-equal on {dev}")
        shutil.rmtree(mgr.dir, ignore_errors=True)
        print(f"[store] {tag} checkpoint of {GNN_ARCH}'s {n_params:,} f32 "
              f"parameters from the card: save {t_save:.4f}s, save_async "
              f"{t_async:.4f}s + wait {t_wait:.4f}s, restore onto {dev} "
              f"{t_rest:.4f}s; both steps bit-equal")

        # -- 8. the phase's totals -----------------------------------------
        totals = collections.Counter()
        for s in stores:
            totals.update({k: v for k, v in s.stats().items()
                           if k != "root"})
        fails = collections.Counter()
        for r in registries:
            st = r.stats()
            fails.update(load=st["store_load_failures"],
                         commit=st["store_commit_failures"])
        if fails["load"] or fails["commit"]:
            raise AssertionError(f"[store] store failures {dict(fails)}")
        on_disk = dir_bytes(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    b1 = label_prop.label_prop_round.launches
    sweeps = ss.stratum_sweep.launches
    if b1 <= 0 or b1 != sum(rounds):
        raise AssertionError(f"[store] B1 launches {b1} != rounds run "
                             f"{sum(rounds)}")
    want = sum(-(-t // ct.TUV_BLOCK) for t in (
        t_old, *range(t_old + 1, g.t_max + 1), g_trim.t_max,
        g_trim.t_max + 1, g_trim.t_max + 1, g_trim.t_max))
    if sweeps != want:
        raise AssertionError(f"[store] stratum_sweep launches {sweeps}, "
                             f"expected {want}")
    print(f"[store] {tag} phase: {on_disk / 1e6:.1f} MB on disk at the end; "
          f"commits full {totals['commits_full']}, delta "
          f"{totals['commits_delta']}, noop {totals['commits_noop']} "
          f"({totals['bytes_written'] / 1e6:.1f} MB written); loads "
          f"{totals['loads']} ({totals['load_bytes'] / 1e6:.1f} MB), "
          f"recovered commits {totals['recovered_commits']}; "
          f"store_load_failures 0, store_commit_failures 0; B1 launches "
          f"{b1} (= the engines' rounds), stratum_sweep launches {sweeps} (5 "
          f"builds and ingests of the first process, 2 cold builds to "
          f"compare, 1 ingest after promotion, 1 cold build after total "
          f"loss; 0 for each promotion); "
          f"{time.perf_counter() - t_phase:.2f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return b1, sweeps


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1

    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core import ecb_native
    from repro_torch.core.pecb_index import build_stratified_index
    from repro_torch.kernels import (flash_attention, kcore_peel, label_prop,
                                     ref, segment_matmul, segmented_select)
    from repro_torch.launch import serve
    from repro_torch.serving import executor

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)          # the context, outside timed phases

    # -- gpu ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"[gpu] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)}")

    # -- build: every native library at once ------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(10) as pool:
        libs = {name: pool.submit(build) for name, build in (
            ("B1", label_prop.build), ("B2", segmented_select.build),
            ("sweep", segmented_select.build_sweep),
            ("B3", kcore_peel.build),
            ("fixpoint", kcore_peel.build_fixpoint),
            ("B4", segment_matmul.build_segment_sum),
            ("B5", segment_matmul.build), ("B6", flash_attention.build),
            ("B6 backward", flash_attention.build_bwd))}
        host = pool.submit(ecb_native.available)
        libs = {name: f.result() for name, f in libs.items()}
        native = host.result()
    for name, so in libs.items():
        print(f"[build] {name} {so.name}")
        for k in ptxas_kernels(so.with_suffix(".log").read_text()):
            print(f"[build] {name} ptxas {k}")
    print(f"[build] B1, B2, the stratum sweep, B3, the peel fixpoint, B4 "
          f"(and its gradient gather), B5, B6, B6's backward + host "
          f"forest engine "
          f"({'native C' if native else 'Python: no C compiler'}) in "
          f"{time.perf_counter() - t0:.2f}s")

    kcore_peel.kcore_fixpoint.launches = 0
    g, ks, strata, t_dev, t_host, b2_launches, sweep_record = \
        construct_phase(dev)
    csr = ct._pair_csr(g)

    # -- index: forests on the host from the card-built strata -------------
    t0 = time.perf_counter()
    sx = build_stratified_index(g, strata=strata, device=dev)
    t_build = time.perf_counter() - t0
    # the k ranges of the card build: construct's default_ks and the
    # index's k_max_graph, one kcore_fixpoint launch per probe each
    fix_builds = kcore_peel.kcore_fixpoint.launches
    if fix_builds != 2 * kmax_probes(sx.k_max_graph):
        raise AssertionError(f"the card build's k ranges made {fix_builds} "
                             f"kcore_fixpoint launches, expected "
                             f"{2 * kmax_probes(sx.k_max_graph)}")
    meta, arrays = bq._host_layout(sx)
    layout_mb = sum(a.nbytes for a in arrays.values()) / 1e6
    N = sx.num_nodes
    print(f"[index] n={g.n} m={g.m} t_max={g.t_max} |K|={len(sx.ks)} "
          f"(k={sx.ks[0]}..{sx.ks[-1]}) N={N} entries={sx.ent_ts.shape[0]} "
          f"vertex_entries={sx.vent_ts.shape[0]} "
          f"versions={meta['num_versions']} index_MB={layout_mb:.1f} "
          f"forests_from_card_strata_s={t_build:.2f} "
          f"(build from graph: {t_dev + t_build:.2f}s with the card's "
          f"strata, {t_host + t_build:.2f}s with the host's); k_max_graph "
          f"{sx.k_max_graph} on the card; kcore_fixpoint launches of the "
          f"build's k ranges {fix_builds}")

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
    _, rand_kern = call_times(lambda: label_prop.label_prop_round(
        labels, *links, active, changed=flag))
    rand_plain_ms = cuda_ms(lambda: ref.label_prop_round(labels, *links,
                                                         active),
                            iters=5, warmup=1)
    n_active = int(active.sum())
    rand_bound = label_prop.bound_ms(*shape, n_active)
    print(f"[kernel] B1 label_prop_round at (B, N)={shape}, random links, "
          f"active share {n_active / active.numel():.4f}: bit-identical to "
          f"the plain version (max abs err {max_err}, tolerance 0: integer "
          f"output must match exactly); kernel {rand_kern}; plain "
          f"{rand_plain_ms:.4f} ms back to back, bound {rand_bound:.4f} ms "
          f"(bytes: 9*B*N + 12*active at 3.35 TB/s)")
    del labels, links, active, got, want

    # -- kernel: B2 on the sweep's operands and on random ids --------------
    count = segmented_select.segmented_count_le
    E, n = int(csr.src.shape[0]), g.n
    seg = torch.as_tensor(csr.src, device=dev)
    dst = torch.as_tensor(csr.dst.astype(np.int64), device=dev)
    tuv1 = torch.as_tensor(np.ascontiguousarray(
        ct._tuv_rows(csr, 1, 2, g.t_max)[0]), device=dev)
    c0 = torch.zeros(n, dtype=torch.int32, device=dev)
    w1 = torch.maximum(tuv1, c0[dst])            # ts = 1, k = ks[0], c = 0
    rand_seg = rng.integers(0, n, E).astype(np.int32)
    rand_seg[rng.random(E) < 0.1] = -1
    cases = {
        "sweep's first operands (ts=1, c=0)": (w1, seg, c0),
        "CSR ids, random thresholds": (
            w1, seg, torch.as_tensor(rng.integers(0, g.t_max + 2, n,
                                                  dtype=np.int32),
                                     device=dev)),
        "random unsorted ids, 10% -1 pads": (
            torch.as_tensor(rng.integers(0, g.t_max + 2, E, dtype=np.int32),
                            device=dev),
            torch.as_tensor(rand_seg, device=dev),
            torch.as_tensor(rng.integers(0, g.t_max + 2, n, dtype=np.int32),
                            device=dev))}
    b2_err = 0
    for what, (w, s, thr) in cases.items():
        b2_err = max(b2_err, check_equal(f"B2 on {what}", count(w, s, thr, n),
                                         ref.segmented_count_le(w, s, thr, n)))
    t = {"kernel": call_times(lambda: count(w1, seg, c0, n)),
         "plain": call_times(lambda: ref.segmented_count_le(w1, seg, c0,
                                                            n))}
    b2_ms, b2_plain = t["kernel"][0], t["plain"][0]
    b2_bound = segmented_select.bound_ms(E, n)
    print(f"[kernel] B2 segmented_count_le at E={E} slots, n={n} segments: "
          f"bit-identical to the plain version on {len(cases)} inputs "
          f"({'; '.join(cases)}; max abs err {b2_err}, tolerance 0). On the "
          f"sweep's first operands: {show(t)}; bound {b2_bound:.6f} ms "
          f"(bytes: 8*E + 8*n at 3.35 TB/s); library: none (no single "
          f"PyTorch call gathers a per-segment threshold, compares and "
          f"counts)")

    # -- kernel: B3a and B3b on the graph's edges, then the peel's operands --
    src_e = torch.as_tensor(g.src, device=dev)
    dst_e = torch.as_tensor(g.dst, device=dev)
    alive_e = torch.as_tensor(rng.random(g.m) < 0.7, device=dev)
    us, ud, inv = distinct_pairs(g, dev)
    alive_p = torch.ones(us.shape[0], dtype=torch.bool, device=dev)
    b3_err = [0, 0]
    degs = []
    for s, d, a in ((src_e, dst_e, alive_e), (us, ud, alive_p)):
        deg = kcore_peel.degree_count(s, d, a, n)
        degs.append(deg)
        b3_err[0] = max(b3_err[0], check_equal(
            "B3a", deg, ref.degree_count(s, d, a, n)))
        for k in (ks[0], ks[len(ks) // 2]):
            flag.zero_()
            got = kcore_peel.peel_threshold(s, d, a, deg, k, changed=flag)
            want = ref.peel_threshold(s, d, a, deg, k)
            b3_err[1] = max(b3_err[1], check_equal("B3b", got, want))
            if int(flag.item()) != int(bool((want != a).any())):
                raise AssertionError("B3b change flag disagrees with the "
                                     "outputs")
    # timed on the peel's first-round operands (all distinct pairs alive)
    m_p = int(us.shape[0])
    deg_e, deg_p = degs
    ends = torch.cat([us[alive_p], ud[alive_p]])      # masking, not timed
    ta = {"kernel": call_times(lambda: kcore_peel.degree_count(
              us, ud, alive_p, n)),
          "plain": call_times(lambda: ref.degree_count(us, ud, alive_p, n)),
          "library (torch.bincount over the alive endpoints, concatenated "
          "and masked outside the timed call)":
          call_times(lambda: torch.bincount(ends, minlength=n))}
    tb = {"kernel": call_times(lambda: kcore_peel.peel_threshold(
              us, ud, alive_p, deg_p, ks[0], changed=flag)),
          "plain": call_times(lambda: ref.peel_threshold(us, ud, alive_p,
                                                         deg_p, ks[0]))}
    (b3a_ms, b3a_plain, b3a_lib), (b3b_ms, b3b_plain) = (
        [v[0] for v in ta.values()], [v[0] for v in tb.values()])
    b3a_bound = kcore_peel.degree_bound_ms(m_p, n)
    b3b_bound = kcore_peel.threshold_bound_ms(m_p, n)
    full_ms = [call_times(lambda: kcore_peel.degree_count(src_e, dst_e,
                                                          alive_e, n))[0],
               call_times(lambda: kcore_peel.peel_threshold(
                   src_e, dst_e, alive_e, deg_e, ks[0], changed=flag))[0]]
    print(f"[kernel] B3a degree_count and B3b peel_threshold on the graph's "
          f"{g.m} edges (random alive, share 0.7) and on the peel's "
          f"{m_p} distinct pairs (all alive), k in ({ks[0]}, "
          f"{ks[len(ks) // 2]}): bit-identical to the plain versions (max "
          f"abs err {b3_err[0]} and {b3_err[1]}, tolerance 0), change flags "
          f"right. On the peel's first-round operands: B3a {show(ta)}; "
          f"bound {b3a_bound:.6f} ms (bytes: 9*m + 4*n). B3b {show(tb)}; "
          f"bound {b3b_bound:.6f} ms (bytes: 10*m + 4*n); library none (no "
          f"single PyTorch call gathers two degrees and thresholds). On all "
          f"{g.m} edges (device time with the host ahead, else back to "
          f"back): B3a {full_ms[0]:.6f} ms, B3b {full_ms[1]:.6f} ms")

    # -- peel: the main path of B3 (the fixpoint kernel), counted ----------
    fix_record, b3_peel = peel_phase(g, us, ud, inv,
                                     list(ks) + [sx.k_max_graph + 1])

    # -- baselines: EF-Index, CT-MSF, Borůvka and the oracle on the card ----
    base_fix, base_b1, base_sweeps = baselines_phase(g, dev, smi)
    sweep_record["launches"] += base_sweeps

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
    ms, b1_kern = call_times(lambda: label_prop.label_prop_round(
        lab0, *ops, changed=flag))
    plain_ms = cuda_ms(lambda: ref.label_prop_round(lab0, *ops),
                       iters=5, warmup=1)
    print(f"[plain] batch of {BUCKET}: labels and masks identical with B1 "
          f"and with the plain round ({rounds_k} rounds each); stage "
          f"seconds: entry {t_entry:.4f}, links+active {t_links:.4f}, "
          f"propagation {t_prop:.4f} (plain round {t_prop_plain:.4f}), "
          f"members {t_members:.4f}, download {t_down:.4f}")
    print(f"[plain] B1 on the batch's first-round operands (active share "
          f"{n_active / active.numel():.4f}, the same in every round): "
          f"bit-identical to the plain version; kernel {b1_kern}; plain "
          f"{plain_ms:.4f} ms back to back, bound {bound:.4f} ms (9*B*N + "
          f"12*active bytes) = {bound / ms:.3f} of bound; "
          f"{label_prop.bound_ms(BUCKET, N, active.numel()) / ms:.3f} of "
          f"the all-active 21*B*N bound; {t_prop / rounds_k * 1e3:.4f} ms "
          f"per round in the loop (kernel + flag read)")

    # -- profile: one served batch under torch.profiler ---------------------
    ex = executor.ShardedExecutor(dev)
    ex.run(dix, slots, ts, te, BUCKET)                  # warm
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_batch = wall(lambda: ex.run(dix, slots, ts, te, BUCKET))
    kern = device_rows(prof)
    busy_us = sum(t for _, t, _ in kern)
    b1_us = sum(t for key, t, _ in kern if "label_prop_round" in key)
    busy = (f"device busy {busy_us / 1e6:.4f}s (idle share "
            f"{1 - busy_us / 1e6 / t_batch:.3f}), B1 {b1_us / 1e6:.4f}s"
            if busy_us else "device busy not measured (no device events)")
    print(f"[profile] one batch of {BUCKET}: wall {t_batch:.4f}s, {busy}; "
          f"top kernels: " + top_rows(kern))

    f0 = kcore_peel.kcore_fixpoint.launches
    epoch_sweeps, epoch_b1 = epoch_phase(g, sx, dix, dev)
    sweep_record["launches"] += epoch_sweeps
    engine_b1, engine_sweeps = engine_phase(g, sx, dev, smi)
    sweep_record["launches"] += engine_sweeps
    store_b1, store_sweeps = store_phase(g, dev, smi)
    sweep_record["launches"] += store_sweeps
    fix_epochs = kcore_peel.kcore_fixpoint.launches - f0
    if fix_epochs <= 0:
        raise AssertionError("the card builds, ingests and trims of [epoch], "
                             "[engine] and [store] peeled no k range on the "
                             "card")
    peel_fix = fix_record["launches"]
    fix_record["launches"] = peel_fix + base_fix + fix_builds + fix_epochs
    print(f"[kcore] kcore_fixpoint launches {fix_record['launches']}: [peel] "
          f"{peel_fix}, [baselines] {base_fix}, the k ranges of the card "
          f"builds "
          f"{fix_builds} ([construct] and [index]) + {fix_epochs} (the "
          f"builds, ingests and trims of [epoch], [engine] and [store])")

    lm_records = lm_phase(dev)
    smoke_b5, smoke_b6 = lm_smoke_phase(dev)
    lm_records[0]["launches"] += smoke_b5
    lm_records[1]["launches"] += smoke_b6
    b4_record, b5_gnn_launches, b5_gnn_err = gnn_phase(dev)
    b5_record = lm_records[0]
    b5_record["launches"] += b5_gnn_launches
    b5_record["max_abs_err"] = max(b5_record["max_abs_err"], b5_gnn_err)
    trained = train_phase(dev, smi)
    b5_record["launches"] += trained["b5"]
    lm_records[1]["launches"] += trained["b6"]
    b4_record["launches"] += trained["b4"]

    csrc = "src/repro_torch/kernels/csrc/"
    records = [
        {"name": "label_prop_round", "route": "cuda",
         "source": csrc + "label_prop.cu",
         "replaces": "src/repro/kernels/label_prop.py:70",
         "launches": launches + base_b1 + epoch_b1 + engine_b1 + store_b1,
         "max_abs_err": max_err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
         "library_ms": None},
        {"name": "segmented_count_le", "route": "cuda",
         "source": csrc + "segmented_count_le.cu",
         "replaces": "src/repro/kernels/segmented_select.py:117",
         "launches": b2_launches, "max_abs_err": b2_err, "ms": b2_ms,
         "plain_ms": b2_plain, "bound_ms": b2_bound, "bound_by": "bytes",
         "library_ms": None},
        sweep_record,
        {"name": "degree_count", "route": "cuda",
         "source": csrc + "kcore_peel.cu",
         "replaces": "src/repro/kernels/kcore_peel.py:62",
         "launches": b3_peel[0], "max_abs_err": b3_err[0], "ms": b3a_ms,
         "plain_ms": b3a_plain, "bound_ms": b3a_bound, "bound_by": "bytes",
         "library_ms": b3a_lib},
        {"name": "peel_threshold", "route": "cuda",
         "source": csrc + "kcore_peel.cu",
         "replaces": "src/repro/kernels/kcore_peel.py:117",
         "launches": b3_peel[1], "max_abs_err": b3_err[1], "ms": b3b_ms,
         "plain_ms": b3b_plain, "bound_ms": b3b_bound, "bound_by": "bytes",
         "library_ms": None}, fix_record, b4_record] + lm_records + \
        trained["records"]
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}s"
          f" ({smi})")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
