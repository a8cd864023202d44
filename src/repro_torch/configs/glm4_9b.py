"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552,
RoPE, GQA.  [hf:THUDM/glm-4-9b; hf]"""
from ..models.transformer import LMConfig
from .base import LM_SHAPES, LM_SKIPS, ArchSpec, register

SPEC = register(ArchSpec(
    id="glm4-9b",
    family="lm-dense",
    model_cfg=LMConfig(
        name="glm4-9b", n_layer=40, d_model=4096, n_head=32, n_kv=2,
        d_ff=13696, vocab=151552, d_head=128, qkv_bias=True,
        rope_theta=10_000.0,
    ),
    smoke_cfg=LMConfig(
        name="glm4-smoke", n_layer=2, d_model=64, n_head=4, n_kv=2,
        d_ff=128, vocab=256, d_head=16, qkv_bias=True, remat=False,
    ),
    shapes=LM_SHAPES, skips=LM_SKIPS,
    source="hf:THUDM/glm-4-9b; hf",
))
