"""mace [gnn]: 2 layers d_hidden=128 l_max=2 correlation_order=3 n_rbf=8,
E(3)-ACE higher-order message passing (Cartesian-irrep adaptation).
[arXiv:2206.07697; paper]"""
from ..models.gnn import MACEConfig
from .base import GNN_SHAPES, ArchSpec, register

SPEC = register(ArchSpec(
    id="mace",
    family="gnn",
    model_cfg=MACEConfig(n_layers=2, d_hidden=128, l_max=2,
                         correlation_order=3, n_rbf=8, cutoff=5.0),
    smoke_cfg=MACEConfig(n_layers=1, d_hidden=8, l_max=2,
                         correlation_order=3, n_rbf=4, cutoff=5.0),
    shapes=GNN_SHAPES, skips={},
    source="arXiv:2206.07697; paper",
))
