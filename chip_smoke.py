#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card (H100), nvcc and a C compiler; builds every
kernel of the main path from the sources in this checkout. Phases, one
result line each; any failure raises and exits non-zero:

  gpu      card name and power limit (nvidia-smi)
  build    B1 (label propagation), B2 (segmented count), B3 (k-core
           peel), B4 (segment sum), B5 (GEMM) and B6 (flash attention) with
           nvcc for sm_90a, the host forest engine with cc, all started
           together
  construct  a CollegeMsg-scale temporal graph (SNAP CollegeMsg: 1,899
           users, 59,835 messages, 193 days), generated from a seed; its 37
           core-time strata swept on the card (the device engine, B2 as the
           counter; B2's launch count over this phase must be > 0) and on
           the host (the fused numpy sweep): every stratum array-equal;
           both times, the fixpoint iterations (host reads of the
           convergence flag) and climbs; then one stratum swept once more
           under torch.profiler (device busy time, idle share, B2's share)
  index    the k-stratified PECB index: forests built on the host from the
           card-built strata, so everything served below comes from them
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
  peel     the main path of B3: ``ops.kcore_fixpoint`` on the card over the
           full window's distinct pairs for every k of the index and
           k_max + 1, each equal to the host's distinct k-core mask; B3a
           and B3b launch counts over this phase must be > 0
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
  lm       glm4-9b at full width and depth (9,399,951,360 parameters, bf16,
           drawn on the card from a seed): prefill of 1 x 4,096 tokens
           through make_serve_step(spec, "prefill_32k") and 8 greedy decode
           steps of batch 16 at the end of a 32,768-slot cache through
           make_serve_step(spec, "decode_32k"), each counted (B5 and B6
           launch counts must be > 0); the prefill's logits against the
           same forward with the plain versions on the card; a 16-token
           decode against the prefill's logits at each position; B5 and B6
           against their plain versions at the path's shapes, timed beside
           their bounds and library yardsticks; one prefill and one decode
           step under torch.profiler (device busy, idle share, B5's and
           B6's shares); tokens/s and the model-FLOP share of 989 TFLOP/s
  gnn      graphsage-reddit at full width (602 -> 128 -> 128, 41 classes,
           192,384 f32 parameters drawn on the card from a seed) serving
           8 minibatches of 1,024 seed vertices, fanout (15, 10), from a
           pool at Reddit's published scale (232,965 nodes, 114.5M directed
           edges, 602 features; generated from a seed), each padded to
           minibatch_lg's 169,984 nodes and 337,920 edges and sent through
           make_serve_step(spec, "minibatch_lg"), counted (B4 and B5 launch
           counts must be > 0); each batch's logits against the same forward
           with the plain versions on the card; B4 against its plain version
           on the first batch's operands (d = 602, 128, 1) and on random
           unsorted ids with -1 and >= S entries, B5's f32 path at the
           layers' shapes, each timed beside its bound and library
           yardstick (index_add_, torch.matmul); sampling, copy and forward
           times per batch, seeds/s; one forward under torch.profiler

Then a line of kernel records (JSON), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
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
    return "gemm_bf16<" in key or "gemm_f32(" in key or "splitk_reduce(" in key


def is_b6(key: str) -> bool:
    return "flash_attn_bf16<" in key or "flash_combine(" in key


def is_b4(key: str) -> bool:
    return "segment_sum_kernel(" in key


def profiled(fn, kernels: dict) -> str:
    """``fn`` once under torch.profiler: wall, device busy, idle share, the
    share in the busy time of each kernel of ``kernels`` (name -> a test of
    a device row's name) with the launches the profiler recorded for it
    (it can drop records), the top device rows and the top host operations
    by their own time."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t = wall(fn)
    rows = device_rows(prof)
    busy = sum(us for _, us, _ in rows) / 1e6
    if not busy:
        return f"wall {t:.4f}s, device busy not measured (no device events)"
    shares = []
    for name, test in kernels.items():
        secs = sum(us for k, us, _ in rows if test(k)) / 1e6
        n = sum(c for k, _, c in rows if test(k))
        shares.append(f"{name} {secs:.4f}s ({secs / busy:.3f} of busy, "
                      f"{n} launches recorded)")
    host = [(e.key, e.self_cpu_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    return (f"wall {t:.4f}s, device busy {busy:.4f}s (idle share "
            f"{1 - busy / t:.3f}), " + ", ".join(shares) + "; top kernels: "
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
    sm.matmul.launches = fa.flash_attention.launches = 0
    logits, t_first = wall(lambda: prefill(model, {"tokens": toks}))
    b5_pre, b6_pre = sm.matmul.launches, fa.flash_attention.launches
    if (b5_pre, b6_pre) != (7 * L + 1, L):
        raise AssertionError(f"prefill launched B5 {b5_pre} and B6 {b6_pre} "
                             f"times, not {7 * L + 1} and {L}")
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
          f"{b5_pre}, B6 {b6_pre}. Logits against the same forward with the "
          f"plain versions on the card ({t_plain:.4f}s): largest |diff| "
          f"{err_pre:.4e} of max|logit| (tolerance {LM_LOGIT_TOL}), top-1 "
          f"agreement {agree_pre:.4f}")
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
    b6_cases = {"prefill causal S = T": (q, k, v, True, seq)}
    results = kernel_checks(b5_cases, b6_cases)
    del h, q, k, v, act, logits

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
    sm.matmul.launches = fa.flash_attention.launches = 0
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
    if out.shape != (batch, cfg.vocab) or not bool(torch.isfinite(out).all()):
        raise AssertionError("decode logits are not finite (B, vocab)")
    flops_dec = configs.model_flops(spec, "decode_32k", dims=dec_dims)
    print(f"[lm] decode {batch} x 1 tokens over the {slots}-slot cache "
          f"({cache_gb:.2f} GB) through make_serve_step(spec, 'decode_32k'), "
          f"{steps} greedy steps at cache_len {slots - steps}..{slots - 1}: "
          f"{t_dec * 1e3:.3f} ms per step = {batch / t_dec:.1f} tokens/s; "
          f"model FLOPs {flops_dec:.4e} per step = "
          f"{flops_dec / t_dec / 989e12:.4f} of 989 TFLOP/s; launches B5 "
          f"{b5_dec}, B6 {b6_dec}; peak device memory "
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
              f"{'bf16' if bf16 else 'f32'} -> f32"
              + (f", plan (skinny, splits, k_split) {sm.plan(M, N, K)}"
                 if bf16 else "") + f": max abs err "
              f"{err:.3e} against the plain version (tolerance {B5_RTOL} "
              f"relative + {B5_ATOL_PER_K * K:.2e}); kernel {kern}; plain "
              f"{plain_ms:.4f} ms back to back; library torch.matmul "
              f"({'bf16 out' if bf16 else 'f32, TF32 off'}) {lib}; bound "
              f"{bound:.4f} ms ({by}) = {bound / t:.3f} of the kernel's "
              f"time; {2.0 * M * N * K / t / 1e9:.1f} TFLOP/s")
    for name, (q, k, v, causal, t_real) in b6_cases.items():
        B, S, H, dh = q.shape
        Hkv = k.shape[2]
        got = fa.flash_attention(q, k, v, causal=causal, t_real=t_real)
        want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
        torch.cuda.synchronize()
        tol = fa.error_bound(want)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        worst = float((diff / tol.clamp_min(1e-30)).max())
        if not bool((diff <= tol).all()):
            raise AssertionError(f"B6 {name} disagrees with its plain version "
                                 f"(max abs err {err}, {worst} of the bound)")
        typical = float(want.float().abs().mean())
        largest = float(want.float().abs().max())
        # the bound's reach: the plain version without the last key tile
        cut = ref.flash_attention(q, k, v, causal=causal,
                                  t_real=t_real - fa.KV_TILE)
        caught = float(((cut.float() - want.float()).abs() > tol)
                       .float().mean())
        if not caught > 0:
            raise AssertionError(f"B6 {name}: the bound does not see the "
                                 f"last {fa.KV_TILE} keys left out")
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
        bound = fa.bound_ms(B, S, H, Hkv, t_real, causal, dh)
        flops = 4.0 * dh * B * H * fa.attended_pairs(S, t_real, causal)
        by = "operations" if flops / fa.BF16_FLOP_PER_S * 1e3 >= bound \
            else "bytes"
        out[name] = dict(b5=False, max_abs_err=err, ms=t, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by)
        print(f"[lm] B6 {name}: q ({B}, {S}, {H}, {dh}) over k, v ({B}, "
              f"{k.shape[1]}, {Hkv}, {dh}), t_real {t_real}, causal {causal}, "
              f"plan (nwq, q tiles, splits, tiles per split) "
              f"{fa.plan(B, S, H, Hkv, t_real, causal)}: max abs err "
              f"{err:.3e} against the plain version, {worst:.3f} of the "
              f"bound ({fa.RTOL} of |plain| + {fa.ROW_ATOL} of its row's "
              f"largest) at most; |plain| typically {typical:.3e}, largest "
              f"{largest:.3e}; without the last {fa.KV_TILE} keys the plain "
              f"version breaks the bound in {caught:.3e} of the elements; "
              f"kernel {kern}; plain {plain_ms:.4f} ms "
              f"back to back; library scaled_dot_product_attention "
              f"(enable_gqa) {lib}; bound {bound:.4f} ms ({by}) = "
              f"{bound / t:.3f} of the kernel's time")
    return out


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
    sm.segment_sum.launches = sm.matmul.launches = 0
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
          f"{e_pad:,} edges); launches B4 {b4_n}, B5 {b5_n}; after the first "
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1

    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core import ecb_native, kcore
    from repro_torch.core.pecb_index import build_stratified_index
    from repro_torch.core.temporal_graph import gen_temporal_graph
    from repro_torch.kernels import (flash_attention, kcore_peel, label_prop,
                                     ref, segment_matmul, segmented_select)
    from repro_torch.kernels import ops as kernel_ops
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
    with ThreadPoolExecutor(7) as pool:
        libs = {name: pool.submit(build) for name, build in (
            ("B1", label_prop.build), ("B2", segmented_select.build),
            ("B3", kcore_peel.build),
            ("B4", segment_matmul.build_segment_sum),
            ("B5", segment_matmul.build), ("B6", flash_attention.build))}
        host = pool.submit(ecb_native.available)
        libs = {name: f.result() for name, f in libs.items()}
        native = host.result()
    for name, so in libs.items():
        ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name} {so.name}; ptxas: {' | '.join(ptxas)}")
    print(f"[build] B1, B2, B3, B4, B5, B6 + host forest engine "
          f"({'native C' if native else 'Python: no C compiler'}) in "
          f"{time.perf_counter() - t0:.2f}s")

    # -- construct: the strata on the card (main path of B2) and the host --
    g = gen_temporal_graph(**COLLEGEMSG)
    ks = ct.default_ks(g)
    host_strata, t_host = wall(lambda: ct.stratified_core_times(
        g, ks, device="cpu"))
    stats: dict = {}
    segmented_select.segmented_count_le.launches = 0
    strata, t_dev = wall(lambda: ct.stratified_core_times(
        g, ks, engine="device", device=dev, stats=stats))
    b2_launches = segmented_select.segmented_count_le.launches
    if b2_launches <= 0:
        raise AssertionError("the device build launched B2 no time")
    steps = segmented_select.bisection_steps(g.t_max + 1)
    if b2_launches != stats["iterations"] + steps * stats["climbs"]:
        raise AssertionError("B2 launches do not match the sweep's probes "
                             "and climbs")
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
    t0 = time.perf_counter()
    ct.StratifiedCoreTable.from_tables(
        g, ks, [ct._compress(g, strata.table_for(k).vertex_ct) for k in ks])
    t_compress = time.perf_counter() - t0
    csr = ct._pair_csr(g)
    print(f"[construct] n={g.n} m={g.m} t_max={g.t_max} "
          f"E={csr.src.shape[0]} slots |K|={len(ks)} "
          f"(k={ks[0]}..{ks[-1]}): {same}/{len(ks)} card-built strata "
          f"array-equal to the host's (every field; tolerance 0: integer "
          f"tables); card build {t_dev:.2f}s, host fused sweep "
          f"{t_host:.2f}s; fixpoint iterations (flag reads) "
          f"{stats['iterations']}, climbs {stats['climbs']} of {steps} "
          f"steps, B2 launches {b2_launches} "
          f"({t_dev / b2_launches * 1e6:.1f} us of build per launch); host "
          f"compress + stratify {t_compress:.2f}s of the card build")

    # one stratum's sweep once more, under the profiler: where it goes
    k0 = ks[0]
    st0: dict = {}
    segmented_select.segmented_count_le.launches = 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        vct0, t_k0 = wall(lambda: ct._sweep_device(g, k0, device=dev,
                                                   stats=st0))
    k0_launches = segmented_select.segmented_count_le.launches
    if not np.array_equal(vct0, strata.table_for(k0).vertex_ct):
        raise AssertionError(f"the per-k sweep of k={k0} differs from its "
                             "stratum")
    rows = device_rows(prof)
    busy_us = sum(t for _, t, _ in rows)
    b2_us = sum(t for key, t, _ in rows if "segmented_count_le" in key)
    print(f"[construct] stratum k={k0} alone under torch.profiler: wall "
          f"{t_k0:.2f}s, iterations {st0['iterations']}, climbs "
          f"{st0['climbs']}, B2 launches {k0_launches}; "
          + (f"device busy {busy_us / 1e6:.4f}s (idle share "
             f"{1 - busy_us / 1e6 / t_k0:.3f}), B2 {b2_us / 1e6:.4f}s = "
             f"{b2_us / max(k0_launches, 1):.2f} us per launch; top kernels: "
             + top_rows(rows) if busy_us else
             "device busy not measured (no device events)"))
    del prof

    # -- index: forests on the host from the card-built strata -------------
    t0 = time.perf_counter()
    sx = build_stratified_index(g, strata=strata)
    t_build = time.perf_counter() - t0
    meta, arrays = bq._host_layout(sx)
    layout_mb = sum(a.nbytes for a in arrays.values()) / 1e6
    N = sx.num_nodes
    print(f"[index] n={g.n} m={g.m} t_max={g.t_max} |K|={len(sx.ks)} "
          f"(k={sx.ks[0]}..{sx.ks[-1]}) N={N} entries={sx.ent_ts.shape[0]} "
          f"vertex_entries={sx.vent_ts.shape[0]} "
          f"versions={meta['num_versions']} index_MB={layout_mb:.1f} "
          f"forests_from_card_strata_s={t_build:.2f} "
          f"(build from graph: {t_dev + t_build:.2f}s with the card's "
          f"strata, {t_host + t_build:.2f}s with the host's)")

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
    key = np.minimum(g.src, g.dst).astype(np.int64) * n + np.maximum(g.src,
                                                                     g.dst)
    uniq, inv = np.unique(key, return_inverse=True)
    us = torch.as_tensor((uniq // n).astype(np.int32), device=dev)
    ud = torch.as_tensor((uniq % n).astype(np.int32), device=dev)
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

    # -- peel: the main path of B3, counted ----------------------------------
    peel_ks = list(ks) + [sx.k_max_graph + 1]
    kcore_peel.degree_count.launches = 0
    kcore_peel.peel_threshold.launches = 0
    t0 = time.perf_counter()
    masks = [kernel_ops.kcore_fixpoint(us, ud, n, k).cpu().numpy()
             for k in peel_ks]
    t_peel = time.perf_counter() - t0
    b3a_launches = kcore_peel.degree_count.launches
    b3b_launches = kcore_peel.peel_threshold.launches
    if b3a_launches <= 0 or b3b_launches <= 0:
        raise AssertionError("the peel launched B3a or B3b no time")
    if b3a_launches != b3b_launches:
        raise AssertionError("every peel round launches B3a then B3b")
    t0 = time.perf_counter()
    for k, mask in zip(peel_ks, masks):
        want = kcore.distinct_kcore_edge_mask(g.src, g.dst, n, k)
        if not np.array_equal(mask[inv], want):
            raise AssertionError(f"the card's {k}-core differs from the "
                                 "host's")
    t_host_peel = time.perf_counter() - t0
    sizes = [int(mk.sum()) for mk in masks]
    if sizes[-1] != 0 or sizes[-2] == 0:
        raise AssertionError("k_max's core must be non-empty, k_max + 1's "
                             "empty")
    print(f"[peel] ops.kcore_fixpoint on the card over {m_p} distinct "
          f"pairs for k={peel_ks[0]}..{peel_ks[-1]} ({len(peel_ks)} "
          f"fixpoints): each equal to kcore.distinct_kcore_edge_mask on the "
          f"host; {b3b_launches} rounds (B3a {b3a_launches}, B3b "
          f"{b3b_launches} launches, one flag read each) in "
          f"{t_peel:.3f}s on the card, {t_host_peel:.3f}s on the host; "
          f"core sizes (pairs) {sizes[0]}..{sizes[-2]}, then {sizes[-1]}")

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
    executor.run(dix, slots, ts, te, BUCKET)            # warm
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_batch = wall(lambda: executor.run(dix, slots, ts, te, BUCKET))
    kern = device_rows(prof)
    busy_us = sum(t for _, t, _ in kern)
    b1_us = sum(t for key, t, _ in kern if "label_prop_round" in key)
    busy = (f"device busy {busy_us / 1e6:.4f}s (idle share "
            f"{1 - busy_us / 1e6 / t_batch:.3f}), B1 {b1_us / 1e6:.4f}s"
            if busy_us else "device busy not measured (no device events)")
    print(f"[profile] one batch of {BUCKET}: wall {t_batch:.4f}s, {busy}; "
          f"top kernels: " + top_rows(kern))

    lm_records = lm_phase(dev)
    b4_record, b5_gnn_launches, b5_gnn_err = gnn_phase(dev)
    b5_record = lm_records[0]
    b5_record["launches"] += b5_gnn_launches
    b5_record["max_abs_err"] = max(b5_record["max_abs_err"], b5_gnn_err)

    csrc = "src/repro_torch/kernels/csrc/"
    records = [
        {"name": "label_prop_round", "route": "cuda",
         "source": csrc + "label_prop.cu",
         "replaces": "src/repro/kernels/label_prop.py:70",
         "launches": launches, "max_abs_err": max_err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
         "library_ms": None},
        {"name": "segmented_count_le", "route": "cuda",
         "source": csrc + "segmented_count_le.cu",
         "replaces": "src/repro/kernels/segmented_select.py:117",
         "launches": b2_launches, "max_abs_err": b2_err, "ms": b2_ms,
         "plain_ms": b2_plain, "bound_ms": b2_bound, "bound_by": "bytes",
         "library_ms": None},
        {"name": "degree_count", "route": "cuda",
         "source": csrc + "kcore_peel.cu",
         "replaces": "src/repro/kernels/kcore_peel.py:62",
         "launches": b3a_launches, "max_abs_err": b3_err[0], "ms": b3a_ms,
         "plain_ms": b3a_plain, "bound_ms": b3a_bound, "bound_by": "bytes",
         "library_ms": b3a_lib},
        {"name": "peel_threshold", "route": "cuda",
         "source": csrc + "kcore_peel.cu",
         "replaces": "src/repro/kernels/kcore_peel.py:117",
         "launches": b3b_launches, "max_abs_err": b3_err[1], "ms": b3b_ms,
         "plain_ms": b3b_plain, "bound_ms": b3b_bound, "bound_by": "bytes",
         "library_ms": None}, b4_record] + lm_records
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
