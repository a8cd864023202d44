"""End-to-end training driver with checkpoint/restart and fault tolerance:
the port's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
        --steps 50 --ckpt-dir /tmp/ckpt --resume auto

The same arguments as the reference's CLI, plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions). The LMs, dense and
MoE, train on the synthetic token stream (``data.lm_data``), the GNNs
(MeshGraphNet, GraphSAGE, NequIP, MACE) on neighbour samples of a
synthetic power-law graph (``data.graph_sampler``), MIND on synthetic
user histories (``data.recsys_data``). Every step goes
through ``configs.make_train_step`` (the kernels' forward and backward,
then AdamW in place); the :class:`RestartingRunner` saves a checkpoint
every ``--ckpt-every`` steps through the port's ``CheckpointManager``
(``save_async``) and, on an injected failure (``--inject-failure``), rolls
back to the latest one and replays. The weights are drawn from seed 0 on
the device (not the reference's bits). ``main`` returns the loss of every
step run, replays included.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.graph_sampler import (CSRGraph, random_powerlaw_graph,
                                            sample_subgraph_batch)
from repro_torch.data.lm_data import TokenStream
from repro_torch.data.recsys_data import InteractionStream
from repro_torch.models import gnn
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 HeartbeatMonitor,
                                                 RestartingRunner)


def make_batch_fn(spec, cfg, dims, device="cuda"):
    """``step -> batch`` dict of tensors on ``device`` (the host data
    pipeline), the reference's, array for array: an LM's tokens and labels
    from ``TokenStream(cfg.vocab, seed=0)``; for a GNN a power-law graph of
    ``dims["n"]`` nodes (average degree 6, seed 0) with normal features and
    uniform labels, and per step ``n // 8`` seeds drawn by
    ``default_rng(step + 1)``, sampled with fanout (5, 5) and padded to n
    nodes and the graph's edge count rounded up to a multiple of 512. From
    the same generator, after the sample: MeshGraphNet's normal
    ``edge_feat`` and ``target`` in place of ``labels`` and
    ``seed_mask``; NequIP's and MACE's normal ``pos`` (times 2), one graph
    (``graph_id`` 0) and zero targets. MIND's from
    ``InteractionStream(cfg.n_items, cfg.hist_len, seed=0).batch(step,
    dims["batch"])``."""
    if spec.family.startswith("lm"):
        stream = TokenStream(cfg.vocab, seed=0)

        def fn(step):
            toks, labels = stream.batch(step, dims["batch"], dims["seq"])
            return {"tokens": torch.as_tensor(toks, device=device),
                    "labels": torch.as_tensor(labels, device=device)}
        return fn
    if spec.family == "recsys":
        stream = InteractionStream(cfg.n_items, cfg.hist_len, seed=0)
        return lambda step: {
            k: torch.as_tensor(v, device=device)
            for k, v in stream.batch(step, dims["batch"]).items()}
    if type(cfg) not in gnn.MODELS:
        raise NotImplementedError(f"{spec.id}: the port's GNN family knows "
                                  f"no {type(cfg).__name__} (ROADMAP A8)")
    n = dims["n"]
    rng0 = np.random.default_rng(0)
    src, dst = random_powerlaw_graph(n, 6, seed=0)
    e2 = int(np.ceil(max(src.shape[0], 1) / 512)) * 512
    g = CSRGraph(n, src, dst)
    feats = rng0.normal(size=(n, dims["d_feat"])).astype(np.float32)
    labels = rng0.integers(0, getattr(cfg, "n_classes", 5), n).astype(np.int32)

    def fn(step):
        rng = np.random.default_rng(step + 1)
        seeds = rng.choice(n, size=max(n // 8, 2), replace=False)
        b = sample_subgraph_batch(g, feats, labels, seeds, (5, 5), rng,
                                  pad_nodes=n, pad_edges=e2)
        if not isinstance(cfg, gnn.SAGEConfig):
            del b["labels"], b["seed_mask"]
        if isinstance(cfg, gnn.MGNConfig):
            b["edge_feat"] = rng.normal(size=(e2, cfg.d_edge_in)).astype(
                np.float32)
            b["target"] = rng.normal(size=(n, cfg.d_out)).astype(np.float32)
        elif not isinstance(cfg, gnn.SAGEConfig):       # NequIP, MACE
            b["pos"] = rng.normal(size=(n, 3)).astype(np.float32) * 2
            b["graph_id"] = np.zeros(n, np.int32)
            b["energy_target"] = np.zeros(1, np.float32)
            b["force_target"] = np.zeros((n, 3), np.float32)
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}
    return fn


def _state(model, opt) -> dict:
    """The runner's state: the model's parameters (views, so the in-place
    updates show) and the optimizer state."""
    return {"params": {n: p.detach() for n, p in model.named_parameters()},
            "opt": opt}


def _load(model, tree) -> dict:
    """Copy a restored checkpoint's parameters into ``model``; returns the
    runner's state over them and the restored optimizer state."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(tree["params"][n])
    return _state(model, tree["opt"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + reduced dims (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", default=None, choices=[None, "auto"])
    ap.add_argument("--inject-failure", type=int, action="append", default=[])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    spec = C.get(args.arch)
    shape_name = args.shape if args.shape in spec.shapes else next(
        s for s, d in spec.shapes.items() if d["kind"] == "train")
    dims = (C.smoke_dims(spec, shape_name) if args.smoke
            else dict(spec.shapes[shape_name]))
    if args.batch:
        dims["batch"] = args.batch
    if args.seq:
        dims["seq"] = args.seq
    cfg = C.cell_model_cfg(spec, shape_name, smoke=args.smoke)

    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=max(args.steps, 10),
                                warmup_steps=max(args.steps // 20, 2))
    step_fn = C.make_train_step(spec, cfg, opt_cfg)
    batch_fn = make_batch_fn(spec, cfg, dims, device)

    gen = torch.Generator(device=device).manual_seed(0)
    model = C.init_params(spec, cfg, gen, device=device)
    state = _state(model, adamw.init_state(dict(model.named_parameters())))

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and args.resume == "auto" and mgr.latest_step() is not None:
        start, tree, _ = mgr.restore(device=device)
        state = _load(model, tree)
        print(f"[resume] from step {start}")
    if mgr and mgr.latest_step() is None:
        mgr.save(start, state, {"arch": args.arch})   # restart anchor

    monitor = HeartbeatMonitor(n_hosts=1, threshold=3.0)
    injector = FailureInjector({s: "cli-injected" for s in args.inject_failure})
    losses = []

    def one_step(state, step):
        batch = batch_fn(step)
        _, opt, metrics = step_fn(model, state["opt"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d} | loss {loss:.4f} | lr "
                  f"{float(metrics['lr']):.2e} | gnorm "
                  f"{float(metrics['grad_norm']):.3f}")
        return _state(model, opt)

    t0 = time.perf_counter()
    if mgr:
        def restore():
            mgr.wait()                 # the newest checkpoint is on disk
            step, tree, _ = mgr.restore(device=device)
            return step, _load(model, tree)

        runner = RestartingRunner(
            one_step,
            save_fn=lambda s, st: mgr.save_async(s, st, {"arch": args.arch}),
            restore_fn=restore, ckpt_every=args.ckpt_every,
            injector=injector, monitor=monitor)
        end, state = runner.run(state, start, args.steps)
        mgr.wait()
        dt = time.perf_counter() - t0
        print(f"[done] {args.steps} steps in {dt:.1f}s | restarts="
              f"{runner.restarts} steps_lost={runner.steps_lost} | final loss "
              f"{losses[-1]:.4f} (first {losses[0]:.4f})")
    else:
        for step in range(start, start + args.steps):
            state = one_step(state, step)
        dt = time.perf_counter() - t0
        print(f"[done] {args.steps} steps in {dt:.1f}s | final loss "
              f"{losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
