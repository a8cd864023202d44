"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B config family; unverified]"""
from ..models.transformer import LMConfig
from .base import LM_SHAPES, LM_SKIPS, ArchSpec, register

SPEC = register(ArchSpec(
    id="qwen1.5-110b",
    family="lm-dense",
    model_cfg=LMConfig(
        name="qwen1.5-110b", n_layer=80, d_model=8192, n_head=64, n_kv=8,
        d_ff=49152, vocab=152064, d_head=128, qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    smoke_cfg=LMConfig(
        name="qwen110b-smoke", n_layer=2, d_model=64, n_head=8, n_kv=2,
        d_ff=128, vocab=256, d_head=8, qkv_bias=True, remat=False,
    ),
    shapes=LM_SHAPES, skips=LM_SKIPS,
    source="hf:Qwen/Qwen1.5-110B; unverified",
))
