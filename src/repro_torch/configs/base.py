"""Architecture/shape registry of the port: the dense-LM and GraphSAGE
parts of ``repro.configs.base``.

Every (arch x shape) cell resolves to a model config
(:func:`cell_model_cfg`), a serve step (:func:`make_serve_step`: an LM's
prefill and decode, GraphSAGE's forward) and its analytic model FLOPs
(:func:`model_flops`). The train step, the sharding specs, MoE LMs, the
other GNN families (MeshGraphNet, NequIP, MACE) and recsys are not ported
yet (ROADMAP A8) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..models import gnn as gnn_mod
from ..models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    id: str
    family: str                    # 'lm-dense' | 'lm-moe' | 'gnn' | 'recsys'
    model_cfg: Any
    smoke_cfg: Any
    shapes: dict
    skips: dict                    # shape name -> reason (cell not run)
    source: str = ""               # provenance note


REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    if not REGISTRY:
        from . import load_all  # circular-safe lazy load
        load_all()
    return REGISTRY[arch_id]


LM_SHAPES = {
    "train_4k":    dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k":  dict(kind="decode", seq=32768, batch=128),
    "long_500k":   dict(kind="decode", seq=524288, batch=1),
}
LM_SKIPS = {
    "long_500k": "pure full (quadratic) attention arch; 512k decode is out of "
                 "scope per the shape definition (skip noted in DESIGN.md §6)",
}

GNN_SHAPES = {
    # e = undirected edge count from the assignment; message passing uses the
    # doubled (directed) arrays, padded to a multiple of 512
    "full_graph_sm": dict(kind="train", n=2_708, e=10_556, d_feat=1_433, graphs=1),
    "minibatch_lg":  dict(kind="train", n=169_984, e=168_960, d_feat=602,
                          graphs=1, seeds=1_024, fanout=(15, 10),
                          pool_nodes=232_965, pool_edges=114_615_892),
    "ogb_products":  dict(kind="train", n=2_449_029, e=61_859_140, d_feat=100, graphs=1),
    "molecule":      dict(kind="train", n=30 * 128, e=64 * 128, d_feat=16, graphs=128),
}


def _ported(spec: ArchSpec) -> None:
    """Raise unless the arch is a dense LM or GraphSAGE."""
    if spec.family == "lm-moe":
        raise NotImplementedError(f"{spec.id}: MoE LMs are not ported yet "
                                  "(ROADMAP A8)")
    if spec.family == "gnn":
        if not isinstance(spec.model_cfg, gnn_mod.SAGEConfig):
            raise NotImplementedError(
                f"{spec.id}: of the GNN family only GraphSAGE is ported "
                "(ROADMAP A8: MeshGraphNet, NequIP and MACE come later)")
    elif not spec.family.startswith("lm"):
        raise NotImplementedError(
            f"{spec.id}: the {spec.family} family is not ported yet (ROADMAP "
            "A8)")


def cell_model_cfg(spec: ArchSpec, shape_name: str):
    """The cell's model config: an LM's own (no per-shape change);
    GraphSAGE's with ``d_in`` set to the shape's feature width."""
    _ported(spec)
    if shape_name not in spec.shapes:
        raise KeyError(f"{spec.id} has no shape {shape_name!r}")
    if spec.family == "gnn":
        return dataclasses.replace(spec.model_cfg,
                                   d_in=spec.shapes[shape_name]["d_feat"])
    return spec.model_cfg


def make_serve_step(spec: ArchSpec, shape_name: str, model_cfg=None
                    ) -> Callable:
    """``serve_step(model, batch)`` of an inference cell, as the
    reference's: prefill takes ``{"tokens": (B, S)}`` and returns the f32
    logits (B, S, vocab); decode takes ``{"tokens": (B, 1), "cache",
    "cache_len"}`` and returns ``(logits (B, vocab), cache)``, the cache
    updated in place (``models.transformer.decode_step``). GraphSAGE's,
    for any of its shapes, takes the unified graph batch (``node_feat``,
    ``src``, ``dst``, optionally ``edge_mask``) and returns the f32 logits
    (n, n_classes) (``models.gnn.sage_forward``)."""
    cfg = model_cfg or cell_model_cfg(spec, shape_name)
    _ported(spec)
    kind = spec.shapes[shape_name]["kind"]

    def _model_of(model):
        if model.cfg != cfg:
            raise ValueError(f"the model is {model.cfg.name}, the step was "
                             f"made for {cfg.name}")
        return model

    if spec.family == "gnn":
        def serve_step(model, batch):
            return gnn_mod.sage_forward(_model_of(model), batch)
        return serve_step
    if kind == "prefill":
        def serve_step(model, batch):
            logits, _ = tfm.forward(_model_of(model), batch["tokens"])
            return logits
        return serve_step
    if kind == "decode":
        def serve_step(model, batch):
            return tfm.decode_step(_model_of(model), batch["tokens"],
                                   batch["cache"], batch["cache_len"])
        return serve_step
    raise NotImplementedError(f"{spec.id} x {shape_name}: the {kind} step is "
                              "not ported yet (ROADMAP A8)")


def model_flops(spec: ArchSpec, shape_name: str, dims: dict | None = None
                ) -> float:
    """Analytic useful FLOPs for one step of a cell (global, all chips), as
    the reference counts them. Dense LM: 6·N·tokens (+ the quadratic
    attention term) to train, 2·N per token to infer, plus the attention
    over the cache at decode; N counts every parameter, the embedding
    included. GraphSAGE: the dense products over all ``n`` nodes of the
    shape (self and neighbour projections of every layer, the head), three
    times that to train; the aggregation's adds are not counted."""
    _ported(spec)
    dims = dims or spec.shapes[shape_name]
    cfg = cell_model_cfg(spec, shape_name)
    if spec.family == "gnn":
        n, h = dims["n"], cfg.d_hidden
        per_node = (2 * (2.0 * cfg.d_in * h)                 # self + neigh
                    + (cfg.n_layers - 1) * 2 * (2.0 * h * h)
                    + 2.0 * h * cfg.n_classes)               # head
        return (3.0 if dims["kind"] == "train" else 1.0) * per_node * n
    B, S = dims["batch"], dims["seq"]
    N = cfg.param_count
    L, Hq, dh = cfg.n_layer, cfg.n_head, cfg.d_head
    if dims["kind"] == "train":
        return 6.0 * N * B * S + 3 * (2.0 * L * B * S * S * Hq * dh)
    if dims["kind"] == "prefill":
        return 2.0 * N * B * S + 2.0 * L * B * S * S * Hq * dh
    return 2.0 * N * B + 4.0 * L * B * S * Hq * dh
