"""Dry run: trace every (architecture x input shape) cell and record its
roofline inputs. The port's ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod-only --device cpu --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_torch

The reference lowers and compiles each cell against the 256- and
512-device production meshes. The port has no SPMD partitioner and no
compiler between the model and the card, so each cell is traced once, on
``meta`` tensors (shapes and dtypes; nothing is allocated, computed or
launched: every kernel wrapper takes its plain version there), on the
card's own ``1x1`` mesh (``--device``: ``cuda``, the default, NCCL;
``cpu``, gloo). Its record holds, like the reference's:

* ``compile_s``: the trace's seconds (nothing is lowered or compiled;
  ``lower_s`` is 0);
* FLOPs, bytes accessed, collective bytes per kind and the three
  roofline terms of one device (``launch/roofline.analyze_trace``); every
  layer runs in the trace (the port's layers are a Python loop), so the
  counts need no probe extrapolation. The LM cells also trace ``probe2``
  and ``probe4`` (2 and 4 layers), kept as the reference keeps them, and
  the counts are affine in ``n_layer``;
* memory: per-device argument bytes (parameters, optimizer state, batch)
  from the placements, exact arithmetic; output bytes and the peak of
  live bytes from the trace;
* ``production``: per production mesh (16x16, and 2x16x16 unless
  ``--single-pod-only``), the exact per-device argument bytes under the
  family's specs with ceil-divided shards. Temporary bytes, FLOPs and
  collective bytes per device there would need a partitioner: they are
  ``None``, with the reason.

``--opt`` selects the reference's §Perf variants: config changes
(``groups=32``, ``pad_experts`` to the production model axis,
``bf16_state``) and the port's hooks on the card's mesh (layout checks;
the all-to-all MoE, ``runtime.moe_a2a``). The command exits 1 if a cell
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch import configs as C
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (hardware, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import P

OPTS = ("base", "actshard", "seqshard", "moegroup", "moeshard",
        "weightgather", "expertpad", "moea2a", "nodeshard", "nodeshard_bf16",
        "opt")

#: why the production meshes' traced quantities are None
NOT_TRACED = ("no SPMD partitioner in PyTorch: temporary bytes, FLOPs and "
              "collective bytes per device on this mesh are not computed; "
              "argument bytes are exact (placements, ceil-divided shards)")


def mesh_name(mesh) -> str:
    sizes = shd.axis_sizes(mesh)
    return ("x".join(str(v) for v in sizes.values()) + ":"
            + ",".join(sizes))


def _apply_opt(spec, cfg, prod_mesh, mesh, opt: str):
    """The variant's config (padding to ``prod_mesh``'s model axis) and
    hooks (on ``mesh``, the traced one)."""
    tfm.set_activation_sharding(None)
    tfm.set_moe_sharding(None)
    tfm.set_weight_use_sharding(None)
    tfm.set_moe_impl(None)
    gnn_mod.set_node_sharding(None)
    if opt == "base":
        return cfg
    dp = shd.dp_axes(mesh)
    if spec.family.startswith("lm"):
        if opt in ("actshard", "opt"):
            tfm.set_activation_sharding(shd.named(mesh, P(dp, None, None)))
        if opt == "seqshard":
            tfm.set_activation_sharding(shd.named(mesh, P(dp, "model", None)))
        if opt == "moegroup" and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, groups=32))
        if opt in ("expertpad", "moea2a", "opt") and cfg.moe is not None:
            ms = shd.axis_sizes(prod_mesh)["model"]
            if cfg.moe.e_total % ms != 0:
                pad = ms - (cfg.moe.n_experts % ms)
                cfg = dataclasses.replace(
                    cfg, moe=dataclasses.replace(cfg.moe, pad_experts=pad))
        if opt == "moea2a" and cfg.moe is not None:
            from repro_torch.runtime.moe_a2a import make_a2a_moe
            tfm.set_moe_impl(make_a2a_moe(mesh, dp))
        if opt == "moeshard" and cfg.moe is not None:
            tfm.set_moe_sharding((shd.named(mesh, P(None, dp, None)),
                                  shd.named(mesh, P(None, dp, "model"))))
        if opt == "weightgather":
            ms = shd.axis_sizes(prod_mesh)["model"]
            ep = cfg.moe is not None and cfg.moe.n_experts % ms == 0
            table = {
                "attn.wq": P(None, "model"), "attn.wk": P(None, "model"),
                "attn.wv": P(None, "model"), "attn.wo": P("model", None),
                "ffn.wi": P(None, "model"), "ffn.wg": P(None, "model"),
                "ffn.wo": P("model", None),
                "moe.wi": P("model", None, None) if ep else P(None, None, "model"),
                "moe.wg": P("model", None, None) if ep else P(None, None, "model"),
                "moe.wo": P("model", None, None) if ep else P(None, "model", None),
                "moe.shared_wi": P(None, None, "model"),
                "moe.shared_wg": P(None, None, "model"),
                "moe.shared_wo": P(None, "model", None),
            }
            tfm.set_weight_use_sharding(
                {k: shd.named(mesh, v) for k, v in table.items()})
    if spec.family == "gnn" and opt in ("nodeshard", "nodeshard_bf16", "opt"):
        gnn_mod.set_node_sharding(shd.named(mesh, P(shd.all_axes(mesh))))
        if opt in ("nodeshard_bf16", "opt") and hasattr(cfg, "bf16_state"):
            cfg = dataclasses.replace(cfg, bf16_state=True)
    return cfg


def argument_bytes(spec, shape_name: str, model, batch: dict, mesh) -> int:
    """Per-device bytes of a cell's arguments on ``mesh``: the parameters,
    to train AdamW's state (f32 moments under the parameters' specs, an
    int32 step), and the batch, each under its spec with ceil-divided
    shards."""
    params = dict(model.named_parameters())
    p_specs = C.param_specs(spec, params, mesh)
    total = sum(shd.shard_bytes(p.shape, p.element_size(), p_specs[n], mesh)
                for n, p in params.items())
    if spec.shapes[shape_name]["kind"] == "train":
        total += 2 * sum(shd.shard_bytes(p.shape, 4, p_specs[n], mesh)
                         for n, p in params.items()) + 4
    b_specs = C.batch_specs(spec, shape_name, batch, mesh)
    for name, t in batch.items():
        if isinstance(t, dict):                       # the decode cache
            total += sum(shd.shard_bytes(v.shape, v.element_size(),
                                         b_specs[name][k], mesh)
                         for k, v in t.items())
        else:
            total += shd.shard_bytes(t.shape, t.element_size(),
                                     b_specs[name], mesh)
    return total


def build_cell(arch_id: str, shape_name: str, mesh, prod_mesh=None, *,
               variant: str = "base", opt: str = "base"):
    """``(fn, args, meta)`` of one cell on ``meta`` tensors: the step, its
    arguments (the model, AdamW's state to train, the batch) and the
    record's metadata. ``variant`` ``probe<N>`` cuts an LM to N layers
    (``unroll`` changes nothing: the port's layers are always a loop)."""
    prod_mesh = prod_mesh or make_production_mesh()
    spec = C.get(arch_id)
    dims = spec.shapes[shape_name]
    kind = dims["kind"]
    cfg = C.cell_model_cfg(spec, shape_name)
    cfg = _apply_opt(spec, cfg, prod_mesh, mesh, opt)
    if variant.startswith("probe"):
        cfg = dataclasses.replace(cfg, n_layer=int(variant[5:]))
    batch = C.input_specs(spec, shape_name, model_cfg=cfg)
    model = C.abstract_params(spec, cfg)

    take_fn = cand_take_fn = None
    if spec.family == "recsys":
        dp = shd.dp_axes(mesh)
        if kind == "retrieval":
            take_fn = shd.make_vp_take(mesh, leading=None)
            cand_take_fn = shd.make_vp_take(mesh, leading=dp)
        else:
            take_fn = shd.make_vp_take(mesh, leading=dp)
            cand_take_fn = take_fn

    if kind == "train":
        state = adamw.init_state(dict(model.named_parameters()))
        fn = C.make_train_step(spec, cfg, take_fn=take_fn)
        args = (model, state, batch)
    else:
        fn = C.make_serve_step(spec, shape_name, cfg, take_fn=take_fn,
                               cand_take_fn=cand_take_fn)
        if kind == "decode":
            # the trace reads no value: attend over the whole cache
            batch = {**batch, "cache_len": dims["seq"] - 1}
        args = (model, batch)
    meta = {"arch": arch_id, "shape": shape_name, "kind": kind,
            "model_flops": C.model_flops(spec, shape_name, model_cfg=cfg),
            "family": spec.family, "n_layer": getattr(cfg, "n_layer", None)}
    return fn, args, meta


def _trace(arch_id, shape_name, mesh, prod_mesh, variant, opt):
    fn, args, meta = build_cell(arch_id, shape_name, mesh, prod_mesh,
                                variant=variant, opt=opt)
    t0 = time.perf_counter()
    rep = roofline.analyze_trace(fn, args,
                                 model_flops_global=meta["model_flops"],
                                 n_devices=shd.mesh_size(mesh))
    return rep, meta, args, time.perf_counter() - t0


def run_cell(arch_id: str, shape_name: str, *, mesh=None,
             multi_pod: bool | None = None, verbose: bool = True,
             probes: bool = True, opt: str = "base") -> dict:
    """Trace one cell on ``mesh`` (default: the card's, ``make_smoke_mesh
    ()``) and return its record; ``production`` holds the argument bytes
    on the single-pod mesh (``multi_pod`` False), the multi-pod one
    (True) or both (None)."""
    mesh = mesh if mesh is not None else make_smoke_mesh()
    prods = [make_production_mesh(multi_pod=mp) for mp in
             ((False, True) if multi_pod is None else (multi_pod,))]
    spec = C.get(arch_id)
    try:
        rep, meta, args, t_trace = _trace(arch_id, shape_name, mesh,
                                          prods[0], "base", opt)
        rep.update(meta)
        rep["memory"]["argument_size_in_bytes"] = argument_bytes(
            spec, shape_name, args[0], C.input_specs(
                spec, shape_name, model_cfg=args[0].cfg), mesh)
        if probes and spec.family.startswith("lm"):
            rep["probes"] = {}
            for pv in ("probe2", "probe4"):
                prep, _, _, pt = _trace(arch_id, shape_name, mesh, prods[0],
                                        pv, opt)
                rep["probes"][pv] = {
                    "flops_per_device": prep["flops_per_device"],
                    "bytes_per_device": prep["bytes_per_device"],
                    "collective_bytes": prep["collectives"]["total"],
                    "trace_s": round(pt, 2)}
        rep["production"] = {}
        for pm in prods:
            cfg = _apply_opt(spec, C.cell_model_cfg(spec, shape_name), pm,
                             mesh, opt)
            model = C.abstract_params(spec, cfg)
            batch = C.input_specs(spec, shape_name, model_cfg=cfg)
            rep["production"][mesh_name(pm)] = {
                "n_devices": pm.size,
                "argument_size_in_bytes": argument_bytes(
                    spec, shape_name, model, batch, pm),
                "output_size_in_bytes": None, "temp_size_in_bytes": None,
                "flops_per_device": None, "bytes_per_device": None,
                "collective_bytes": None, "why_none": NOT_TRACED}
    finally:
        _apply_opt(spec, None, prods[0], mesh, "base")
    rep["mesh"] = mesh_name(mesh)
    rep["n_devices"] = shd.mesh_size(mesh)
    rep["hw"] = hardware()            # the roofline's constants
    # nothing is lowered or compiled: the trace's seconds stand in
    rep["lower_s"] = 0.0
    rep["compile_s"] = round(t_trace, 2)
    if verbose:
        mem, r = rep["memory"], rep["roofline"]
        prod = " ".join(f"{k.split(':')[0]} {v['argument_size_in_bytes']:.3e}"
                        for k, v in rep["production"].items())
        print(f"[{rep['mesh']}] {arch_id} x {shape_name}: "
              f"trace {t_trace:.1f}s | "
              f"flops/dev {rep['flops_per_device']:.3e} | "
              f"bytes/dev {rep['bytes_per_device']:.3e} | "
              f"coll/dev {rep['collectives']['total']:.3e}B "
              f"{rep['collectives']['counts']} | "
              f"terms c={r['compute_s']*1e3:.2f}ms m={r['memory_s']*1e3:.2f}ms "
              f"x={r['collective_s']*1e3:.2f}ms -> {r['dominant']} | "
              f"useful {r['useful_flop_ratio']:.2f} | args "
              f"{mem['argument_size_in_bytes']:.3e} peak "
              f"{mem['peak_live_bytes']:.3e} | arg B/dev on {prod}",
              flush=True)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for per-cell JSON records")
    ap.add_argument("--opt", default="base", choices=OPTS,
                    help="the reference's §Perf variant")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the traced mesh's device (cuda: NCCL on the card)")
    args = ap.parse_args(argv)

    cells = (list(C.all_cells()) if args.all
             else [(args.arch, args.shape)])
    multi_pod = (False if args.single_pod_only else
                 True if args.multi_pod_only else None)
    mesh = make_smoke_mesh(args.device)
    failures = []
    for arch_id, shape_name in cells:
        tag = f"{arch_id}__{shape_name}"
        if args.opt != "base":
            tag += f"__{args.opt}"
        out_path = args.out and os.path.join(args.out, tag + ".json")
        if out_path and os.path.exists(out_path):
            print(f"[skip cached] {tag}")
            continue
        try:
            rep = run_cell(arch_id, shape_name, mesh=mesh,
                           multi_pod=multi_pod, opt=args.opt)
            if out_path:
                os.makedirs(args.out, exist_ok=True)
                with open(out_path, "w") as f:
                    json.dump(rep, f, indent=1, default=str)
        except Exception as e:        # every cell runs; failures exit 1
            failures.append((tag, repr(e)))
            print(f"[FAIL] {tag}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        return 1
    print("\nDRY-RUN: all requested cells traced.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
