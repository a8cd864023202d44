"""Config registry of the port: one module per ported architecture (the
dense LMs; the reference's other architectures wait for ROADMAP A8)."""

from .base import (LM_SHAPES, LM_SKIPS, REGISTRY, ArchSpec, cell_model_cfg,
                   get, make_serve_step, model_flops, register)

__all__ = ["LM_SHAPES", "LM_SKIPS", "REGISTRY", "ArchSpec", "cell_model_cfg",
           "get", "load_all", "make_serve_step", "model_flops", "register"]

_ARCH_MODULES = ("glm4_9b", "codeqwen1_5_7b")


def load_all():
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{m}")
    return dict(REGISTRY)


load_all()
