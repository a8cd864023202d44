"""mind [recsys]: embed_dim=64 n_interests=4 capsule_iters=3 multi-interest
dynamic routing over a sparse item table.  [arXiv:1904.08030; unverified]"""
from ..models.recsys import MINDConfig
from .base import RECSYS_SHAPES, ArchSpec, register

SPEC = register(ArchSpec(
    id="mind",
    family="recsys",
    model_cfg=MINDConfig(n_items=8_388_608, embed_dim=64, n_interests=4,
                         capsule_iters=3, hist_len=50),
    smoke_cfg=MINDConfig(n_items=1024, embed_dim=16, n_interests=4,
                         capsule_iters=3, hist_len=8),
    shapes=RECSYS_SHAPES, skips={},
    source="arXiv:1904.08030; unverified",
))
