"""Architecture/shape registry of the port: the LM part of
``repro.configs.base``.

Every (arch x shape) cell resolves to a model config
(:func:`cell_model_cfg`), a serve step (:func:`make_serve_step`: prefill
and decode) and its analytic model FLOPs (:func:`model_flops`). The train
step, the sharding specs and the GNN and recsys families are not ported
yet (ROADMAP A8) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

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


def _dense_lm_only(spec: ArchSpec) -> None:
    if spec.family == "lm-moe":
        raise NotImplementedError(f"{spec.id}: MoE LMs are not ported yet "
                                  "(ROADMAP A8)")
    if not spec.family.startswith("lm"):
        raise NotImplementedError(
            f"{spec.id}: the {spec.family} family is not ported yet (ROADMAP "
            "A8; the GNN cells wait for B4)")


def cell_model_cfg(spec: ArchSpec, shape_name: str):
    """The cell's model config: the LM's own (no per-shape change)."""
    _dense_lm_only(spec)
    if shape_name not in spec.shapes:
        raise KeyError(f"{spec.id} has no shape {shape_name!r}")
    return spec.model_cfg


def make_serve_step(spec: ArchSpec, shape_name: str, model_cfg=None
                    ) -> Callable:
    """``serve_step(model, batch)`` of an inference cell, as the
    reference's: prefill takes ``{"tokens": (B, S)}`` and returns the f32
    logits (B, S, vocab); decode takes ``{"tokens": (B, 1), "cache",
    "cache_len"}`` and returns ``(logits (B, vocab), cache)``, the cache
    updated in place (``models.transformer.decode_step``)."""
    cfg = model_cfg or cell_model_cfg(spec, shape_name)
    _dense_lm_only(spec)
    kind = spec.shapes[shape_name]["kind"]

    def _model_of(model):
        if model.cfg != cfg:
            raise ValueError(f"the model is {model.cfg.name}, the step was "
                             f"made for {cfg.name}")
        return model

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
    """Analytic useful FLOPs for one step of a dense LM cell (global, all
    chips), as the reference counts them: 6·N·tokens (+ the quadratic
    attention term) to train, 2·N per token to infer, plus the attention
    over the cache at decode; N counts every parameter, the embedding
    included."""
    _dense_lm_only(spec)
    dims = dims or spec.shapes[shape_name]
    cfg = cell_model_cfg(spec, shape_name)
    B, S = dims["batch"], dims["seq"]
    N = cfg.param_count
    L, Hq, dh = cfg.n_layer, cfg.n_head, cfg.d_head
    if dims["kind"] == "train":
        return 6.0 * N * B * S + 3 * (2.0 * L * B * S * S * Hq * dh)
    if dims["kind"] == "prefill":
        return 2.0 * N * B * S + 2.0 * L * B * S * S * Hq * dh
    return 2.0 * N * B + 4.0 * L * B * S * Hq * dh
