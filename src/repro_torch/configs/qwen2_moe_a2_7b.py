"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared.  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from ..models.transformer import LMConfig, MoEConfig
from .base import LM_SHAPES, LM_SKIPS, ArchSpec, register

SPEC = register(ArchSpec(
    id="qwen2-moe-a2.7b",
    family="lm-moe",
    model_cfg=LMConfig(
        name="qwen2-moe-a2.7b", n_layer=24, d_model=2048, n_head=16, n_kv=16,
        d_ff=1408, vocab=151936, d_head=128, qkv_bias=True,
        moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408, n_shared=4),
    ),
    smoke_cfg=LMConfig(
        name="qwen2-moe-smoke", n_layer=2, d_model=64, n_head=4, n_kv=4,
        d_ff=64, vocab=256, d_head=16, qkv_bias=True, remat=False,
        moe=MoEConfig(n_experts=6, top_k=2, d_ff_expert=32, n_shared=1),
    ),
    shapes=LM_SHAPES, skips=LM_SKIPS,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
))
