"""Config registry of the port: one module per architecture of the
reference, all ten (the five LMs, dense and MoE, the four GNNs and the
recsys architecture, mind)."""

from .base import (GNN_SHAPES, LM_SHAPES, LM_SKIPS, RECSYS_SHAPES, REGISTRY,
                   ArchSpec, abstract_params, all_cells, batch_specs,
                   cell_model_cfg, get, init_params, input_specs, loss_for,
                   make_serve_step, make_train_step, model_flops, opt_specs,
                   param_specs, register, smoke_dims)

__all__ = ["GNN_SHAPES", "LM_SHAPES", "LM_SKIPS", "RECSYS_SHAPES", "REGISTRY",
           "ArchSpec", "abstract_params", "all_cells", "batch_specs",
           "cell_model_cfg", "get", "init_params", "input_specs", "load_all",
           "loss_for", "make_serve_step", "make_train_step", "model_flops",
           "opt_specs", "param_specs", "register", "smoke_dims"]

_ARCH_MODULES = ("dbrx_132b", "qwen2_moe_a2_7b", "glm4_9b", "codeqwen1_5_7b",
                 "qwen1_5_110b", "meshgraphnet", "nequip", "graphsage_reddit",
                 "mace", "mind")


def load_all():
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{m}")
    return dict(REGISTRY)


load_all()
