"""meshgraphnet [gnn]: 15 layers d_hidden=128 sum aggregator, 2-layer MLPs.
[arXiv:2010.03409; unverified]"""
from ..models.gnn import MGNConfig
from .base import GNN_SHAPES, ArchSpec, register

SPEC = register(ArchSpec(
    id="meshgraphnet",
    family="gnn",
    model_cfg=MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2),
    smoke_cfg=MGNConfig(n_layers=2, d_hidden=16, mlp_layers=2),
    shapes=GNN_SHAPES, skips={},
    source="arXiv:2010.03409; unverified",
))
