"""Config registry of the port: one module per ported architecture (the
dense LMs and GraphSAGE; the reference's other architectures wait for
ROADMAP A8)."""

from .base import (GNN_SHAPES, LM_SHAPES, LM_SKIPS, REGISTRY, ArchSpec,
                   cell_model_cfg, get, init_params, loss_for,
                   make_serve_step, make_train_step, model_flops, register,
                   smoke_dims)

__all__ = ["GNN_SHAPES", "LM_SHAPES", "LM_SKIPS", "REGISTRY", "ArchSpec",
           "cell_model_cfg", "get", "init_params", "load_all", "loss_for",
           "make_serve_step", "make_train_step", "model_flops", "register",
           "smoke_dims"]

_ARCH_MODULES = ("glm4_9b", "codeqwen1_5_7b", "graphsage_reddit")


def load_all():
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{m}")
    return dict(REGISTRY)


load_all()
