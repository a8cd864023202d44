"""nequip [gnn]: 5 layers d_hidden=32 l_max=2 n_rbf=8 cutoff=5, E(3)
tensor-product (Cartesian-irrep adaptation, DESIGN.md §3).
[arXiv:2101.03164; paper]"""
from ..models.gnn import NequIPConfig
from .base import GNN_SHAPES, ArchSpec, register

SPEC = register(ArchSpec(
    id="nequip",
    family="gnn",
    model_cfg=NequIPConfig(n_layers=5, d_hidden=32, l_max=2, n_rbf=8,
                           cutoff=5.0),
    smoke_cfg=NequIPConfig(n_layers=2, d_hidden=8, l_max=2, n_rbf=4,
                           cutoff=5.0),
    shapes=GNN_SHAPES, skips={},
    source="arXiv:2101.03164; paper",
))
