"""Architecture/shape registry of the port: ``repro.configs.base`` for
the LMs (dense and MoE), the GNNs and recsys (MIND).

Every (arch x shape) cell (:func:`all_cells`) resolves to a model config
(:func:`cell_model_cfg`), its inputs and parameters as shapes and dtypes
on the ``meta`` device (:func:`input_specs`, :func:`abstract_params`), a
serve step (:func:`make_serve_step`: an LM's prefill and decode, a
GNN's forward, MIND's scoring and retrieval), a train step
(:func:`make_train_step`: the loss of :func:`loss_for` differentiated
through the kernels' gradients, then one AdamW update in place) and its
analytic model FLOPs (:func:`model_flops`); :func:`init_params` draws a
model and :func:`smoke_dims` gives a cell's reduced dims. The partition
specs of a cell on a mesh (:func:`param_specs`, :func:`batch_specs`,
:func:`opt_specs`) are ``runtime.sharding``'s family policies, keyed by
the port's parameter and batch names; MIND's steps take the reference's
``take_fn``/``cand_take_fn`` (the vocab-parallel lookup,
``runtime.sharding.make_vp_take``) and, on a mesh, run it by default. A
GNN or recsys config type the port does not know raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..models import gnn as gnn_mod
from ..models import recsys as recsys_mod
from ..models import transformer as tfm
from ..optim import adamw
from ..runtime import sharding as shd


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


def all_cells(include_skipped: bool = False):
    """Yield ``(arch_id, shape_name)`` for every cell of the port's
    registry, the skipped ones too with ``include_skipped``."""
    if not REGISTRY:
        from . import load_all
        load_all()
    for aid, spec in REGISTRY.items():
        for shape in spec.shapes:
            if shape in spec.skips and not include_skipped:
                continue
            yield aid, shape


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

RECSYS_SHAPES = {
    "train_batch":    dict(kind="train", batch=65_536),
    "serve_p99":      dict(kind="serve", batch=512, cands=100),
    "serve_bulk":     dict(kind="serve", batch=262_144, cands=100),
    "retrieval_cand": dict(kind="retrieval", batch=1, cands=1_000_000),
}


def _ported(spec: ArchSpec) -> None:
    """Raise unless the arch is an LM (dense or MoE), one of the four GNNs
    (its config one of the port's GNN config types) or MIND (recsys, with
    the port's :class:`MINDConfig`)."""
    if spec.family == "recsys":
        if not isinstance(spec.model_cfg, recsys_mod.MINDConfig):
            raise NotImplementedError(
                f"{spec.id}: the port's recsys family is MIND and knows no "
                f"{type(spec.model_cfg).__name__}")
    elif spec.family == "gnn":
        if type(spec.model_cfg) not in gnn_mod.MODELS:
            raise NotImplementedError(
                f"{spec.id}: the port's GNN family is MeshGraphNet, "
                f"GraphSAGE, NequIP and MACE, and knows no "
                f"{type(spec.model_cfg).__name__} (ROADMAP A8)")
    elif not spec.family.startswith("lm"):
        raise NotImplementedError(
            f"{spec.id}: the {spec.family} family is not ported yet (ROADMAP "
            "A8)")


def cell_model_cfg(spec: ArchSpec, shape_name: str, smoke: bool = False):
    """The cell's model config (``spec.smoke_cfg`` with ``smoke``): an LM's
    own (no per-shape change); a GNN's with its input width set to the
    shape's feature width, or to 8 for a smoke config: MeshGraphNet's
    ``d_node_in``, GraphSAGE's ``d_in``, NequIP's and MACE's
    ``d_species``; MIND's own for every shape."""
    _ported(spec)
    if shape_name not in spec.shapes:
        raise KeyError(f"{spec.id} has no shape {shape_name!r}")
    cfg = spec.smoke_cfg if smoke else spec.model_cfg
    if spec.family == "gnn":
        d_feat = 8 if smoke else spec.shapes[shape_name]["d_feat"]
        field = {gnn_mod.MGNConfig: "d_node_in",
                 gnn_mod.SAGEConfig: "d_in"}.get(type(cfg), "d_species")
        return dataclasses.replace(cfg, **{field: d_feat})
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(n) for n in shape), dtype=dtype,
                       device="meta")


def input_specs(spec: ArchSpec, shape_name: str, dims: dict | None = None,
                model_cfg=None) -> dict:
    """The cell's step inputs as tensors on ``torch.device("meta")``
    (shapes and dtypes, nothing allocated), the reference's: an LM's
    int32 ``tokens`` (and ``labels`` to train), at decode ``tokens`` (B,
    1), the ``cache`` (:func:`models.transformer.abstract_cache`) and a
    0-dim int32 ``cache_len``; a GNN's unified graph batch, its edge
    arrays doubled and padded to a multiple of 512, with MeshGraphNet's
    ``edge_feat`` and ``target``, GraphSAGE's ``labels`` and
    ``seed_mask``, or NequIP's and MACE's ``pos``, ``graph_id``,
    ``energy_target`` and ``force_target``; MIND's int32 ``hist_ids`` (B,
    H) and f32 ``hist_mask``, with ``target_id`` (B,) to train,
    ``cand_ids`` (B, C) to serve, ``cand_ids`` (C,) for retrieval."""
    _ported(spec)
    dims = dims or spec.shapes[shape_name]
    cfg = model_cfg or cell_model_cfg(spec, shape_name)
    kind = dims["kind"]
    if spec.family.startswith("lm"):
        B, S = dims["batch"], dims["seq"]
        if kind == "train":
            return {"tokens": _meta((B, S), torch.int32),
                    "labels": _meta((B, S), torch.int32)}
        if kind == "prefill":
            return {"tokens": _meta((B, S), torch.int32)}
        return {"tokens": _meta((B, 1), torch.int32),
                "cache": tfm.abstract_cache(cfg, B, S),
                "cache_len": _meta((), torch.int32)}
    if spec.family == "recsys":
        B, H = dims["batch"], cfg.hist_len
        out = {"hist_ids": _meta((B, H), torch.int32),
               "hist_mask": _meta((B, H), torch.float32)}
        if kind == "train":
            out["target_id"] = _meta((B,), torch.int32)
        elif kind == "serve":
            out["cand_ids"] = _meta((B, dims["cands"]), torch.int32)
        else:                                         # retrieval
            out["cand_ids"] = _meta((dims["cands"],), torch.int32)
        return out
    n = dims["n"]
    e2 = math.ceil(2 * dims["e"] / 512) * 512
    out = {"node_feat": _meta((n, dims["d_feat"]), torch.float32),
           "src": _meta((e2,), torch.int32),
           "dst": _meta((e2,), torch.int32),
           "edge_mask": _meta((e2,), torch.float32)}
    if isinstance(cfg, gnn_mod.MGNConfig):
        out["edge_feat"] = _meta((e2, cfg.d_edge_in), torch.float32)
        out["target"] = _meta((n, cfg.d_out), torch.float32)
    elif isinstance(cfg, gnn_mod.SAGEConfig):
        out["labels"] = _meta((n,), torch.int32)
        out["seed_mask"] = _meta((n,), torch.bool)
    else:                                             # NequIP, MACE
        out["pos"] = _meta((n, 3), torch.float32)
        out["graph_id"] = _meta((n,), torch.int32)
        out["energy_target"] = _meta((dims["graphs"],), torch.float32)
        out["force_target"] = _meta((n, 3), torch.float32)
    return out


def abstract_params(spec: ArchSpec, model_cfg) -> torch.nn.Module:
    """A model of ``model_cfg`` on ``torch.device("meta")``: its
    parameters' names, shapes and dtypes, nothing allocated (the
    reference's ``jax.eval_shape`` of the family's init)."""
    _ported(spec)
    if spec.family == "gnn":
        return gnn_mod.model_of(model_cfg, device="meta")
    if spec.family == "recsys":
        return recsys_mod.MIND(model_cfg, device="meta")
    return tfm.abstract_params(model_cfg)


def _local_batch(model, batch: dict, specs: dict, mesh) -> dict:
    """This rank's rows of a global batch (``runtime.sharding.local_shard``
    under each input's spec), after checking that ``model`` is placed on
    ``mesh``."""
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("the model is not placed on the step's mesh "
                         "(runtime.sharding.shard_params / init_params(mesh=))")
    return {k: shd.local_shard(v, mesh, specs[k]).contiguous()
            for k, v in batch.items()}


def _local_even(model, batch: dict, specs: dict, mesh) -> dict:
    """:func:`_local_batch`, every split dimension first checked to divide
    over its axes (``runtime.sharding.check_divides``)."""
    for k, v in batch.items():
        shd.check_divides(v.shape, specs[k], mesh, k)
    return _local_batch(model, batch, specs, mesh)


def _local_edges(model, batch: dict, mesh) -> dict:
    """This rank's edges of a global graph batch (``gnn_batch_specs``),
    the node arrays whole; the edge count must divide over the mesh:
    padding edges point at node 0 with mask 0."""
    return _local_even(model, batch, shd.gnn_batch_specs(batch, mesh), mesh)


def _local_users(model, batch: dict, mesh, retrieval: bool = False) -> dict:
    """This rank's rows of a global MIND batch (``mind_batch_specs``: the
    users over the data axes; for retrieval the user whole and the
    candidate slab over them), which must divide over those axes."""
    return _local_even(model, batch, shd.mind_batch_specs(
        batch, mesh, retrieval=retrieval), mesh)


def make_serve_step(spec: ArchSpec, shape_name: str, model_cfg=None,
                    take_fn=None, cand_take_fn=None, mesh=None) -> Callable:
    """``serve_step(model, batch)`` of an inference cell, as the
    reference's: prefill takes ``{"tokens": (B, S)}`` and returns the f32
    logits (B, S, vocab); decode takes ``{"tokens": (B, 1), "cache",
    "cache_len"}`` and returns ``(logits (B, vocab), cache)``, the cache
    updated in place (``models.transformer.decode_step``). A GNN's, for
    any of its shapes, takes the unified graph batch under inference mode
    and returns the reference's outputs: MeshGraphNet's (n, d_out)
    (``models.gnn.mgn_forward``), GraphSAGE's f32 logits (n, n_classes)
    (``sage_forward``), NequIP's and MACE's ``(energy (graphs,), (s, V,
    T))`` (``geo_forward``). MIND's, under inference mode: a serve cell's
    scores (B, C) (``models.recsys.mind_serve``), a retrieval cell's (C,)
    (``mind_retrieval``), their lookups through ``take_fn`` and
    ``cand_take_fn`` where given.

    With ``mesh`` an LM's step runs on a model placed on it
    (``runtime.sharding.shard_params``): each rank takes its rows of the global
    ``tokens`` (``lm_batch_specs``) and returns its shard of the logits,
    (B / data, S, vocab / model) at prefill and (B / data, vocab / model)
    at decode, whose cache is this rank's shard under ``lm_cache_spec``
    (``models.transformer.init_cache(mesh=)``). A GNN's takes its edges of
    the global graph batch (``gnn_batch_specs``: the edge count must
    divide over the mesh) and returns the whole graph's outputs, the same
    on every rank; under the node-sharding hook
    (``models.gnn.set_node_sharding``) this rank's node rows of them.
    MIND's takes this rank's users (``mind_batch_specs``) and returns their
    scores, (B / data, C); retrieval takes the user whole and its slice of
    the candidate slab, and returns that slice's scores, (C / data,). Its
    lookups default to the vocab-parallel one (``models.recsys.
    Partition``); a ``take_fn`` or ``cand_take_fn`` given is called with
    this rank's shard of the table and this rank's ids. Without ``mesh``
    the step is as it always was."""
    cfg = model_cfg or cell_model_cfg(spec, shape_name)
    _ported(spec)
    kind = spec.shapes[shape_name]["kind"]

    def _tokens(model, batch):
        if mesh is None:
            return batch["tokens"]
        return _local_batch(model, {"tokens": batch["tokens"]},
                            shd.lm_batch_specs(mesh), mesh)["tokens"]

    def _model_of(model):
        if model.cfg != cfg:
            raise ValueError(f"the model is {model.cfg.name}, the step was "
                             f"made for {cfg.name}")
        return model

    if spec.family == "gnn":
        fwd = gnn_mod.FORWARDS[type(cfg)]

        def serve_step(model, batch):
            if mesh is not None:
                batch = _local_edges(model, batch, mesh)
            return fwd(_model_of(model), batch)
        return serve_step
    if spec.family == "recsys" and kind in ("serve", "retrieval"):
        fwd = (recsys_mod.mind_serve if kind == "serve"
               else recsys_mod.mind_retrieval)

        def serve_step(model, batch):
            if mesh is not None:
                batch = _local_users(model, batch, mesh,
                                     retrieval=(kind == "retrieval"))
            return fwd(_model_of(model), batch, take_fn=take_fn,
                       cand_take_fn=cand_take_fn)
        return serve_step
    if kind == "prefill":
        def serve_step(model, batch):
            logits, _ = tfm.forward(_model_of(model), _tokens(model, batch))
            return logits
        return serve_step
    if kind == "decode":
        def serve_step(model, batch):
            return tfm.decode_step(_model_of(model), _tokens(model, batch),
                                   batch["cache"], batch["cache_len"])
        return serve_step
    raise NotImplementedError(f"{spec.id} x {shape_name}: a {kind} cell has "
                              "no serve step (make_train_step trains it)")


def smoke_dims(spec: ArchSpec, shape_name: str) -> dict:
    """Reduced dims of the same kind, for CPU smoke runs (the
    reference's): an LM's batch 2 x 32 tokens; a GNN's 24 nodes and 48
    edges per graph (at most 4 graphs), 8 features, no seed count; MIND's
    4 users, 16 candidates each where the shape has candidates."""
    _ported(spec)
    dims = dict(spec.shapes[shape_name])
    if spec.family.startswith("lm"):
        dims.update(seq=32, batch=2)
    elif spec.family == "recsys":
        dims.update(batch=4)
        if "cands" in dims:
            dims.update(cands=16)
    else:
        graphs = min(dims.get("graphs", 1), 4)
        dims.update(n=24 * graphs, e=48 * graphs, d_feat=8, graphs=graphs)
        dims.pop("seeds", None)
    return dims


def init_params(spec: ArchSpec, model_cfg, generator: torch.Generator,
                device="cuda", mesh=None):
    """A model of ``model_cfg`` drawn from ``generator`` (which lives on
    ``device``) with the reference's initial distributions: the port's
    ``init_params`` of the family. With ``mesh`` it is placed on the mesh:
    an LM's as it is drawn, each rank keeping its shards of the same bits
    (``models.transformer.init_params``); a GNN's replicated, every rank
    holding the same bits from a generator seeded alike
    (``models.gnn.init_params``); MIND's drawn whole, each rank keeping its
    rows of ``item_embed`` and ``S`` whole (``mind_param_specs``), the
    bits of one device's model from the same seed."""
    _ported(spec)
    if spec.family == "gnn":
        return gnn_mod.init_params(model_cfg, generator, device=device,
                                   mesh=mesh)
    if spec.family == "recsys":
        model = recsys_mod.init_params(model_cfg, generator, device=device)
        if mesh is not None:
            shd.shard_params(model, shd.mind_param_specs(model), mesh)
        return model
    if mesh is not None:
        return tfm.init_params(model_cfg, generator, device=device,
                               mesh=mesh)
    return tfm.init_params(model_cfg, generator, device=device)


def loss_for(spec: ArchSpec, model_cfg, take_fn=None) -> Callable:
    """``loss(model, batch)``, the reference's: an LM's
    ``transformer.loss_fn`` over ``{"tokens", "labels"}``; a GNN's over
    the graph batch: ``gnn.mgn_loss`` (``target``), ``gnn.sage_loss``
    (``labels``, ``seed_mask``) or ``gnn.geo_loss`` (energies and forces,
    the forces with their graph, so that the train step differentiates
    them once more); MIND's ``recsys.mind_loss`` over ``{"hist_ids",
    "hist_mask", "target_id"}``, its lookup through ``take_fn`` where
    given."""
    _ported(spec)
    if spec.family == "gnn":
        return gnn_mod.LOSSES[type(model_cfg)]
    if spec.family == "recsys":
        return lambda model, batch: recsys_mod.mind_loss(model, batch,
                                                         take_fn=take_fn)
    return lambda model, batch: tfm.loss_fn(model, batch["tokens"],
                                            batch["labels"])


def make_train_step(spec: ArchSpec, model_cfg,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    take_fn=None, mesh=None) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    {"loss", "grad_norm", "lr"})``, the reference's: the loss and the
    gradient of every parameter (autograd through the kernels' backward
    kernels), then ``adamw.apply_updates``. Unlike the reference's, which
    returns new arrays, the step updates ``model``'s parameters and the
    moments of ``opt_state`` IN PLACE and returns the same objects; the
    metrics are 0-dim tensors on the model's device. ``take_fn`` is
    MIND's lookup (:func:`loss_for`).

    With ``mesh`` an LM's step runs on a model placed on it
    (``runtime.sharding.shard_params`` or ``init_params(mesh=)``) and on the
    moments of its shards: each rank takes its rows of the global batch
    (:func:`batch_specs`), the layers run under the partitioner, AdamW's
    norm spans the mesh (``adamw.global_norm``), and ``loss``,
    ``grad_norm`` and ``lr`` are the global values, the same on every
    rank. A GNN's takes its edges of the global graph batch
    (``gnn_batch_specs``), its parameters, gradients and moments whole and
    the same on every rank (the norm counts each once, with no
    exchange). MIND's takes this rank's users (``mind_batch_specs``), its
    table rows and their moments (``mind_param_specs``), ``S`` and its
    moments whole; the in-batch softmax still spans the whole batch
    (``models.recsys.Partition``); its lookup defaults to the
    vocab-parallel one, and a ``take_fn`` given is called with this
    rank's shard of the table and this rank's ids. Without it the step is
    as it always was."""
    _ported(spec)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    loss = loss_for(spec, model_cfg, take_fn=take_fn)
    p_specs = None
    if mesh is not None:
        p_specs = param_specs(spec, abstract_params(spec, model_cfg), mesh)

    def local(model, batch):
        if spec.family == "gnn":
            return _local_edges(model, batch, mesh)
        if spec.family == "recsys":
            return _local_users(model, batch, mesh)
        return _local_batch(model, batch, shd.lm_batch_specs(mesh), mesh)

    def train_step(model, opt_state, batch):
        if model.cfg != model_cfg:
            raise ValueError(f"the model is {model.cfg.name}, the step was "
                             f"made for {model_cfg.name}")
        if mesh is not None:
            batch = local(model, batch)
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        lval = loss(model, batch)
        # a parameter the loss does not reach (NequIP's last mix_v and
        # mix_t: the energy reads the last layer's scalars only) gets a
        # zero gradient, as jax.grad gives it
        grads = dict(zip(params, torch.autograd.grad(
            lval, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        _, opt_state, metrics = adamw.apply_updates(opt_cfg, params, grads,
                                                    opt_state, p_specs, mesh)
        return model, opt_state, {"loss": lval.detach(), **metrics}

    return train_step


# ----------------------------------------------------------------------
# partition specs per cell
# ----------------------------------------------------------------------

def param_specs(spec: ArchSpec, params, mesh) -> dict:
    """``{parameter name: P}`` of a model (or a name -> tensor dict) on
    ``mesh``: ``runtime.sharding``'s policy of the family."""
    if spec.family.startswith("lm"):
        return shd.lm_param_spec_tree(params, mesh)
    if spec.family == "gnn":
        return shd.gnn_param_specs(params)
    return shd.mind_param_specs(params)


def batch_specs(spec: ArchSpec, shape_name: str, batch: dict, mesh) -> dict:
    """``{input name: P}`` of a cell's batch (:func:`input_specs`) on
    ``mesh``; an LM's decode cache is ``{"k": P, "v": P}``."""
    dims = spec.shapes[shape_name]
    kind = dims["kind"]
    dp = shd.dp_axes(mesh)
    if spec.family.startswith("lm"):
        if kind in ("train", "prefill"):
            return {name: shd.P(dp, None) for name in batch}
        cfg = cell_model_cfg(spec, shape_name)
        return {"tokens": shd.P(dp, None),
                "cache": shd.lm_cache_spec(mesh, cfg.n_kv),
                "cache_len": shd.P()}
    if spec.family == "gnn":
        return shd.gnn_batch_specs(batch, mesh)
    return shd.mind_batch_specs(batch, mesh,
                                retrieval=(kind == "retrieval"))


def opt_specs(param_spec_tree: dict) -> dict:
    """AdamW's state: the moments under the parameters' specs, the step
    replicated."""
    return {"mu": param_spec_tree, "nu": param_spec_tree, "step": shd.P()}


def model_flops(spec: ArchSpec, shape_name: str, dims: dict | None = None,
                model_cfg=None) -> float:
    """Analytic useful FLOPs for one step of a cell (global, all chips), as
    the reference counts them. LM: 6·N·tokens (+ the quadratic attention
    term) to train, 2·N per token to infer, plus the attention over the
    cache at decode; N counts the active parameters (every one of a dense
    model; a MoE model's routed top-k and shared experts), the embedding
    included. A GNN: the reference's closed forms from the layer algebra,
    over all ``n`` nodes and ``2e`` directed edges of the shape (the
    aggregation's adds are not counted), three times that to train. MIND:
    the bilinear map, the routing's einsums and, to train, the in-batch
    logits (three times that), or to serve the candidates' scores (the
    lookups are not counted). ``model_cfg`` counts another config than the
    cell's (a smoke one)."""
    _ported(spec)
    dims = dims or spec.shapes[shape_name]
    cfg = model_cfg or cell_model_cfg(spec, shape_name)
    if spec.family == "gnn":
        fwd = _gnn_forward_flops(cfg, dims["n"], 2 * dims["e"])
        return 3.0 * fwd if dims["kind"] == "train" else fwd
    if spec.family == "recsys":
        B = dims["batch"]
        H, d = cfg.hist_len, cfg.embed_dim
        K, iters = cfg.n_interests, cfg.capsule_iters
        fwd = 2.0 * B * H * d * d                 # bilinear S map
        fwd += iters * (2 * 2.0 * B * K * H * d)  # routing einsums
        if dims["kind"] == "train":
            fwd += 2.0 * B * B * d                # in-batch softmax logits
            return 3.0 * fwd
        return fwd + 2.0 * B * K * dims.get("cands", 0) * d  # scoring
    B, S = dims["batch"], dims["seq"]
    N = cfg.active_param_count
    L, Hq, dh = cfg.n_layer, cfg.n_head, cfg.d_head
    if dims["kind"] == "train":
        return 6.0 * N * B * S + 3 * (2.0 * L * B * S * S * Hq * dh)
    if dims["kind"] == "prefill":
        return 2.0 * N * B * S + 2.0 * L * B * S * S * Hq * dh
    return 2.0 * N * B + 4.0 * L * B * S * Hq * dh


def _mlp_flops(dims: list, rows: float) -> float:
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:])) * rows


def _gnn_forward_flops(cfg, n: int, e2: int) -> float:
    """One forward's model FLOPs over ``n`` nodes and ``e2`` directed
    edges, the reference's terms in its order (``model_flops``)."""
    h = cfg.d_hidden
    fwd = 0.0
    if isinstance(cfg, gnn_mod.MGNConfig):
        hid = [h] * cfg.mlp_layers
        fwd += _mlp_flops([cfg.d_node_in] + hid + [h], n)
        fwd += _mlp_flops([cfg.d_edge_in] + hid + [h], e2)
        fwd += cfg.n_layers * (_mlp_flops([3 * h] + hid + [h], e2)
                               + _mlp_flops([2 * h] + hid + [h], n))
        fwd += _mlp_flops([h] + hid + [cfg.d_out], n)
    elif isinstance(cfg, gnn_mod.SAGEConfig):
        fwd += 2 * _mlp_flops([cfg.d_in, h], n)                # self+neigh
        fwd += (cfg.n_layers - 1) * 2 * _mlp_flops([h, h], n)
        fwd += _mlp_flops([h, cfg.n_classes], n)
    else:            # NequIP, MACE (Cartesian irreps: 1, 3, 9; 3 paths each)
        C = cfg.d_hidden
        irrep_sz = 1 + 3 + 9
        per_edge = (_mlp_flops([cfg.n_rbf, cfg.radial_hidden, 3 * C * 3], 1.0)
                    + 2.0 * 3 * C * irrep_sz)   # path products + weighting
        per_node = 2.0 * C * C * irrep_sz       # channel mixes
        fwd += cfg.n_layers * (per_edge * e2 + per_node * n)
        if isinstance(cfg, gnn_mod.MACEConfig):
            # correlation products + B-basis projections (orders 2, 3)
            fwd += cfg.n_layers * n * (2.0 * (3 * C) * C
                                       + 2 * 2.0 * (2 * C) * C * 3
                                       + 2 * 2.0 * (2 * C) * C * 9) * 2
        fwd += _mlp_flops([C, C, 1], n)
    return fwd
