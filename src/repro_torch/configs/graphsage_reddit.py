"""graphsage-reddit [gnn]: 2 layers d_hidden=128 mean aggregator,
sample sizes 25-10.  [arXiv:1706.02216; paper]"""
from ..models.gnn import SAGEConfig
from .base import GNN_SHAPES, ArchSpec, register

SPEC = register(ArchSpec(
    id="graphsage-reddit",
    family="gnn",
    model_cfg=SAGEConfig(n_layers=2, d_hidden=128, n_classes=41),
    smoke_cfg=SAGEConfig(n_layers=2, d_hidden=16, n_classes=5),
    shapes=GNN_SHAPES, skips={},
    source="arXiv:1706.02216; paper",
))
