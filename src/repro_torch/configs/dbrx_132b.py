"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base; unverified]"""
from ..models.transformer import LMConfig, MoEConfig
from .base import LM_SHAPES, LM_SKIPS, ArchSpec, register

SPEC = register(ArchSpec(
    id="dbrx-132b",
    family="lm-moe",
    model_cfg=LMConfig(
        name="dbrx-132b", n_layer=40, d_model=6144, n_head=48, n_kv=8,
        d_ff=10752, vocab=100352, d_head=128, rope_theta=500_000.0,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    ),
    smoke_cfg=LMConfig(
        name="dbrx-132b-smoke", n_layer=2, d_model=64, n_head=8, n_kv=2,
        d_ff=128, vocab=256, d_head=8, remat=False,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
    ),
    shapes=LM_SHAPES, skips=LM_SKIPS,
    source="hf:databricks/dbrx-base; unverified",
))
