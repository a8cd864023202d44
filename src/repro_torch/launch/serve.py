"""TCCS query serving from the command line, the port's counterpart of
``python -m repro.launch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --workload cm_like \\
        --queries 4096 --batch 256

It builds the k-stratified index (core times on ``--device``: the card's
sweep through the stratum-sweep kernel on CUDA, the host sweep with
``--device cpu``;
forests on the host), uploads it to the card,
replays a random stream of typed mixed-k ``TCCSQuery`` specs (one ``--k``
pins a single stratum) in batches of ``--batch``, and does what the
reference planner's device branch does (``repro/serving/planner.py``):
specs become entry slots ``k_index(k) * n + u``, each batch runs
``executor.run`` (or ``run_full_mixed`` when a spec wants edges) and the
masks become ``TCCSResult``s. It then verifies a sample against the
port's own Algorithm 1 and fails on any mismatch.

The serving engine — micro-batcher, result cache, index registry, host/
device planner, metrics and tracing — is not ported yet (ROADMAP A4):
here every batch goes to the device, in arrival order.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.batch_query import (mixed_slots, stratum_device,
                                          to_device)
from repro_torch.core.pecb_index import StratifiedPECB, build_stratified_index
from repro_torch.core.query_api import (Provenance, ResultMode, TCCSQuery,
                                        build_result)
from repro_torch.core.temporal_graph import (BENCH_WORKLOADS, TemporalGraph,
                                             bench_graph, random_queries)
from repro_torch.serving import executor

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
    bucket = executor.final_bucket(b, min(8, max_batch), max_batch)
    slots = mixed_slots(sx, [(q.u, q.k) for _, q in lanes])
    ts = [q.ts for _, q in lanes]
    te = [q.te for _, q in lanes]
    need_edges = any(q.mode in _EDGE_MODES for _, q in lanes)
    t0 = time.perf_counter()
    if need_edges:
        vmask, vermask = executor.run_full_mixed(
            dix, slots, ts, te, [q.k for _, q in lanes], bucket, stats=stats)
    else:
        vmask = executor.run(dix, slots, ts, te, bucket, stats=stats)
        vermask = None
    prov = Provenance(route="device",
                      backend="pecb-device" + ("-full" if need_edges else ""),
                      batch_size=b, bucket=bucket,
                      timings={"exec_s": time.perf_counter() - t0})
    store = sx.versions
    for j, (i, q) in enumerate(lanes):
        vertices = frozenset(np.flatnonzero(vmask[j]).tolist())
        edge_set = (store.select(np.flatnonzero(vermask[j]))
                    if vermask is not None and q.mode in _EDGE_MODES
                    else None)
        results[i] = build_result(q, vertices, store, prov,
                                  edge_set=edge_set)
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
    queries = random_queries(g, n_queries, seed=seed)
    if k is None:
        rng = np.random.default_rng(seed + 1)
        ks = rng.choice(np.asarray(sx.supported_ks), n_queries).tolist()
    else:
        ks = [k] * n_queries
    specs = [TCCSQuery(u, ts, te, kk, ResultMode(mode))
             for (u, ts, te), kk in zip(queries, ks)]

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
    window is checked against Algorithm 1 (raises on a mismatch)."""
    sd = stratum_device(dix, sx, k)
    ts = [a for a, _ in windows]
    te = [b for _, b in windows]
    stats: dict = {}
    t0 = time.perf_counter()
    mask = executor.run_sweep(sd, u, ts, te, len(windows), stats=stats)
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
            "largest": int(sizes.max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="cm_like",
                    choices=sorted(BENCH_WORKLOADS))
    ap.add_argument("--k", type=int, default=None,
                    help="serve one stratum (default: k drawn per query)")
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--mode", default="vertices",
                    choices=["vertices", "edges", "count"])
    ap.add_argument("--verify", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    g = bench_graph(args.workload)
    print(f"[serve] workload={args.workload} n={g.n} m={g.m} "
          f"t_max={g.t_max} device={args.device}")
    out = serve_graph(g, k=args.k, n_queries=args.queries, batch=args.batch,
                      mode=args.mode, verify=args.verify, device=args.device)
    return out["qps"]


if __name__ == "__main__":
    main()
