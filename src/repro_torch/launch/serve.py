"""TCCS query-serving driver — thin client of the serving engine
(``repro_torch.serving``, DESIGN.md §7), the port's counterpart of
``python -m repro.launch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --workload cm_like \\
        --k 3 --queries 4096 --batch 256 --flush-ms 2

``main`` owns nothing but the traffic: it warms the engine (the index
build on ``--device``, default ``cuda``: the core times through the
stratum-sweep kernel there, the host sweep with ``--device cpu``; forests
on the host; the mirror uploaded; every bucket run once), replays a random
stream of typed ``TCCSQuery`` specs through ``submit_specs`` (``--mode``
picks the result mode), prints the engine's own per-stage metrics,
compares against the sequential Algorithm 1 baseline, and verifies
exactness on a sample. All batching, routing and caching policy lives in
the engine. With ``--store-dir`` the engine's registry writes the index
through to a persistent store, and a second run on the same directory
promotes the stored index instead of rebuilding it (``--expect-warm``
fails the run unless it did).

``serve_graph`` and ``serve_sweep`` drive the device plane directly,
without the engine: every batch goes to the device in arrival order
through :class:`~repro_torch.serving.executor.ShardedExecutor`, and the
answers are checked against the port's Algorithm 1.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.batch_query import (mixed_slots, stratum_device,
                                          to_device)
from repro_torch.core.core_time import kcore_device
from repro_torch.core.kcore import k_max
from repro_torch.core.pecb_index import StratifiedPECB, build_stratified_index
from repro_torch.core.query_api import Provenance, ResultMode, TCCSQuery
from repro_torch.core.temporal_graph import (BENCH_WORKLOADS, TemporalGraph,
                                             bench_graph, random_queries)
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.executor import ShardedExecutor
from repro_torch.serving.planner import assemble_device_results

_EDGE_MODES = (ResultMode.EDGES, ResultMode.SUBGRAPH)


def answer_batch(sx: StratifiedPECB, dix, specs, *, max_batch: int = 256,
                 stats: dict | None = None) -> list:
    """Typed results for one batch of specs against the stratified index
    ``sx`` and its device mirror ``dix``.

    Specs are validated and canonicalized; an empty window or a k without
    a stratum is answered on the host (``sx.answer``: exactly empty above
    the graph's k-max, ``InvalidQueryError`` otherwise). The rest run as
    one device batch padded to its power-of-two bucket (at least 8, the
    reference engine's smallest)."""
    results = [None] * len(specs)
    lanes = []
    for i, q in enumerate(specs):
        cq = q.validate(n=sx.n).canonical(sx.t_max)
        if cq.is_empty_window or cq.k not in sx.supported_ks:
            results[i] = sx.answer(q)
        else:
            lanes.append((i, cq))
    if not lanes:
        return results
    b = len(lanes)
    ex = ShardedExecutor(dix.device)
    bucket = ex.final_bucket(b, min(8, max_batch), max_batch)
    slots = mixed_slots(sx, [(q.u, q.k) for _, q in lanes])
    ts = [q.ts for _, q in lanes]
    te = [q.te for _, q in lanes]
    need_edges = any(q.mode in _EDGE_MODES for _, q in lanes)
    t0 = time.perf_counter()
    if need_edges:
        vmask, vermask = ex.run_full_mixed(
            dix, slots, ts, te, [q.k for _, q in lanes], bucket, stats=stats)
    else:
        vmask = ex.run(dix, slots, ts, te, bucket, stats=stats)
        vermask = None
    prov = Provenance(route="device",
                      backend="pecb-device" + ("-full" if need_edges else ""),
                      batch_size=b, bucket=bucket,
                      timings={"exec_s": time.perf_counter() - t0})
    done = assemble_device_results(sx.versions, [q for _, q in lanes],
                                   vmask, vermask, prov)
    for (i, _), res in zip(lanes, done):
        results[i] = res
    return results


def _matches(sx: StratifiedPECB, q: TCCSQuery, res) -> bool:
    """One served result against the port's Algorithm 1 on the host."""
    cq = q.canonical(sx.t_max)
    if cq.is_empty_window or cq.k not in sx.supported_ks:
        return res.num_vertices == 0
    ix = sx.slice_k(cq.k)
    want = frozenset(ix._component_vertices(cq.u, cq.ts, cq.te))
    if cq.mode is ResultMode.COUNT:
        return res.num_vertices == len(want)
    if res.vertices != want:
        return False
    if cq.mode in _EDGE_MODES:
        edges = ix.versions.member_edges(want, cq.ts, cq.te)
        return res.edges.edge_ids() == edges.edge_ids()
    return True


def mixed_specs(g: TemporalGraph, ks, n_queries: int, *, seed: int = 0,
                k: int | None = None, mode: str = "vertices") -> list:
    """``n_queries`` specs of :func:`serve_graph`'s stream over ``g``:
    ``random_queries(g, n_queries, seed)``, each query's k drawn from
    ``ks`` (the supported strata) with ``default_rng(seed + 1)``, or ``k``
    for all of them."""
    queries = random_queries(g, n_queries, seed=seed)
    if k is None:
        rng = np.random.default_rng(seed + 1)
        kk = rng.choice(np.asarray(ks), n_queries).tolist()
    else:
        kk = [k] * n_queries
    return [TCCSQuery(u, ts, te, q_k, ResultMode(mode))
            for (u, ts, te), q_k in zip(queries, kk)]


def serve_graph(g: TemporalGraph, *, k: int | None = None,
                n_queries: int = 2048, batch: int = 256,
                mode: str = "vertices", verify: int = 32, device="cuda",
                seed: int = 0, index: StratifiedPECB | None = None,
                dix=None) -> dict:
    """Serve ``n_queries`` random specs over ``g`` on ``device`` and verify
    the first ``verify`` against Algorithm 1 (raises on a mismatch).

    ``index``/``dix`` reuse an index already built / uploaded. ``k=None``
    draws each query's k uniformly from the supported strata (a mixed-k
    stream). Returns the run's numbers: queries/s over all batches and
    over all but the first, per-batch propagation rounds (one B1 round
    each on the card) and wall times, and the verification count."""
    if index is None:
        t0 = time.perf_counter()
        index = build_stratified_index(g, device=device)
        print(f"[build] n={g.n} m={g.m} t_max={g.t_max} |K|={len(index.ks)} "
              f"N={index.num_nodes} in {time.perf_counter() - t0:.3f}s")
    sx = index
    if dix is None:
        t0 = time.perf_counter()
        dix = to_device(sx, device)
        print(f"[upload] {dix.nbytes() / 1e6:.1f} MB to {dix.device} in "
              f"{time.perf_counter() - t0:.3f}s")
    specs = mixed_specs(g, sx.supported_ks, n_queries, seed=seed, k=k,
                        mode=mode)
    ks = [q.k for q in specs]

    stats: dict = {}
    results, batch_s = [], []
    for i in range(0, len(specs), batch):
        t0 = time.perf_counter()
        results += answer_batch(sx, dix, specs[i:i + batch],
                                max_batch=batch, stats=stats)
        batch_s.append(time.perf_counter() - t0)
    total = sum(batch_s)
    steady = (len(specs) - batch) / sum(batch_s[1:]) if len(batch_s) > 1 \
        else None
    rounds = stats.get("rounds", [])
    print(f"[serve] {len(specs)} {mode} queries, k in {min(ks)}..{max(ks)} "
          f"({len(set(ks))} strata), "
          f"{len(batch_s)} batches of <= {batch}: {len(specs) / total:,.1f} "
          f"q/s" + (f" ({steady:,.1f} q/s after the first batch)"
                    if steady else ""))
    print(f"[serve] rounds per batch {rounds}; "
          f"batch seconds {[round(s, 4) for s in batch_s]}")

    n_seq = min(max(verify, 1) * 4, len(specs))
    t0 = time.perf_counter()
    for q in specs[:n_seq]:
        sx.slice_k(q.k)._component_vertices(q.u, q.ts, q.te)
    t_seq = (time.perf_counter() - t0) / n_seq
    print(f"[serve] sequential Algorithm 1 on the host: {t_seq * 1e6:.1f} "
          f"us/query")
    checked = min(verify, len(specs))
    bad = sum(not _matches(sx, q, r)
              for q, r in zip(specs[:checked], results[:checked]))
    print(f"[verify] {checked} queries checked against Algorithm 1, "
          f"{bad} mismatches")
    if bad:
        raise RuntimeError(f"{bad} served results disagree with Algorithm 1")
    return {"qps": len(specs) / total, "qps_steady": steady,
            "rounds": rounds, "batch_s": batch_s,
            "checked": checked, "mismatches": bad, "results": results}


def serve_sweep(sx: StratifiedPECB, dix, u: int, k: int, windows) -> dict:
    """One vertex over many windows in one device batch, on the stratum
    ``k`` carved out of the fused mirror (``stratum_device``); every
    window is checked against Algorithm 1 (raises on a mismatch). Returns
    the batch's numbers and each window's vertex set (``answers``)."""
    sd = stratum_device(dix, sx, k)
    ts = [a for a, _ in windows]
    te = [b for _, b in windows]
    stats: dict = {}
    t0 = time.perf_counter()
    mask = ShardedExecutor(sd.device).run_sweep(sd, u, ts, te, len(windows),
                                                stats=stats)
    dt = time.perf_counter() - t0
    ix = sx.slice_k(k)
    bad = sum(frozenset(np.flatnonzero(mask[i]).tolist())
              != frozenset(ix._component_vertices(u, a, b))
              for i, (a, b) in enumerate(windows))
    sizes = mask.sum(axis=1)
    print(f"[sweep] u={u} k={k} {len(windows)} windows on {sd.num_nodes} "
          f"stratum nodes in {dt:.4f}s, rounds {stats.get('rounds')}, "
          f"component sizes {int(sizes.min())}..{int(sizes.max())}, "
          f"{bad} mismatches")
    if bad:
        raise RuntimeError(f"{bad} swept windows disagree with Algorithm 1")
    return {"seconds": dt, "rounds": stats.get("rounds"), "mismatches": bad,
            "largest": int(sizes.max()),
            "answers": [frozenset(np.flatnonzero(row).tolist())
                        for row in mask]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="cm_like",
                    choices=sorted(BENCH_WORKLOADS))
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--flush-ms", type=float, default=2.0)
    ap.add_argument("--cache", type=int, default=4096)
    ap.add_argument("--mode", default="vertices",
                    choices=[m.value for m in ResultMode])
    ap.add_argument("--verify", type=int, default=32)
    ap.add_argument("--trace-export", metavar="PATH", default=None,
                    help="write the run's query-lifecycle spans as Chrome "
                         "trace-event JSON (Perfetto / chrome://tracing)")
    ap.add_argument("--slow-query-ms", type=float, default=None,
                    help="log queries slower than this threshold with "
                         "their full span tree")
    ap.add_argument("--store-dir", metavar="DIR", default=None,
                    help="persistent index store root (DESIGN.md §13): "
                         "builds write through to it and a restart "
                         "promotes the stored index instead of rebuilding")
    ap.add_argument("--expect-warm", action="store_true",
                    help="fail unless the warmup index was promoted from "
                         "the store (needs --store-dir)")
    ap.add_argument("--device", default="cuda",
                    help="where the index is built and served (default "
                         "cuda; nothing falls back to the CPU)")
    args = ap.parse_args(argv)

    if args.expect_warm and not args.store_dir:
        ap.error("--expect-warm requires --store-dir")
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    g = bench_graph(args.workload)
    k = args.k or max(2, int(0.7 * k_max(
        g, kcore_device("auto", args.device))))
    cfg = EngineConfig(max_batch=args.batch, flush_ms=args.flush_ms,
                       cache_capacity=args.cache,
                       min_bucket=min(8, args.batch),
                       slow_query_ms=args.slow_query_ms,
                       store_dir=args.store_dir)
    print(f"[engine] workload={args.workload} n={g.n} m={g.m} "
          f"t_max={g.t_max} k={k} device={args.device} config={cfg}")

    with ServingEngine(cfg, device=args.device) as eng:
        t0 = time.perf_counter()
        # edge modes use the full-mode batch: run it once now, not inside
        # the timed replay (one warmup covers every k — the index is
        # k-stratified and k rides as the entry slot)
        handle = eng.warmup(args.workload,
                            full=args.mode in ("edges", "subgraph"))
        how = "promoted from store" if handle.source == "disk" else "built"
        print(f"[warmup] index {how} in {handle.build_seconds:.2f}s "
              f"(nodes={handle.pecb.num_nodes} size={handle.nbytes/1e6:.2f} "
              f"MB, stages { {s: round(t, 3) for s, t in handle.build_stages.items()} }); "
              f"buckets run in "
              f"{time.perf_counter() - t0 - handle.build_seconds:.2f}s")
        if args.store_dir:
            st = eng.store.stats()
            print(f"[store] root={st['root']} commits={st['commits']} "
                  f"(full={st['commits_full']} delta={st['commits_delta']} "
                  f"noop={st['commits_noop']}) loads={st['loads']} "
                  f"load_bytes={st['load_bytes']} "
                  f"recovered={st['recovered_commits']}")
        if args.expect_warm and handle.source != "disk":
            raise RuntimeError(
                f"--expect-warm: warmup fell back to a cold build "
                f"(source={handle.source!r}) — the store at "
                f"{args.store_dir!r} held no promotable epoch")

        queries = random_queries(g, args.queries, seed=0)
        specs = [TCCSQuery(u, ts, te, k, ResultMode(args.mode))
                 for (u, ts, te) in queries]
        t0 = time.perf_counter()
        futures = []
        for i in range(0, len(specs), args.batch):
            futures += eng.submit_specs(args.workload, specs[i:i + args.batch])
        eng.flush()
        results = [f.result(timeout=120) for f in futures]
        dt = time.perf_counter() - t0
        total = len(queries)
        print(f"[serve] {total} queries in {dt:.3f}s -> {total/dt:,.0f} q/s "
              f"({dt/total*1e6:.1f} us/query)")
        routes = {}
        for r in results:
            routes[r.provenance.route] = routes.get(r.provenance.route, 0) + 1
        print(f"[serve] result routes: {routes}")
        print(eng.format_stats())

        # sequential Algorithm 1 comparison (per-k stratum view)
        ref = handle.pecb.slice_k(k)
        n_seq = min(args.verify * 8, total)
        t0 = time.perf_counter()
        for (u, ts, te) in queries[:n_seq]:
            ref._component_vertices(u, ts, te)
        t_seq = (time.perf_counter() - t0) / n_seq
        print(f"[serve] sequential Alg 1: {t_seq*1e6:.1f} us/query "
              f"(engine speedup {t_seq/(dt/total):.1f}x)")

        # exactness spot check (COUNT mode carries sizes only)
        def matches(i):
            want = ref._component_vertices(*queries[i])
            if results[i].query.mode is ResultMode.COUNT:
                return results[i].num_vertices == len(want)
            return results[i].vertices == frozenset(want)
        bad = sum(not matches(i) for i in range(min(args.verify, total)))
        print(f"[verify] {min(args.verify, total)} queries checked against "
              f"Algorithm 1, {bad} mismatches")
        if bad:
            raise RuntimeError(f"{bad} served results disagree with the "
                               "host-side PECB reference")

        if args.slow_query_ms is not None:
            print(f"[slow-queries] threshold={args.slow_query_ms}ms "
                  f"logged={len(eng.slow_queries)}")
            print(eng.slow_queries.format())
        if args.trace_export:
            doc = eng.export_trace(args.trace_export,
                                   extra={"workload": args.workload, "k": k})
            print(f"[trace] {len(doc['traceEvents'])} events -> "
                  f"{args.trace_export} (dropped="
                  f"{doc['otherData']['dropped_spans']})")
        return total / dt


if __name__ == "__main__":
    main()
