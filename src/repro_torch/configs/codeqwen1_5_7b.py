"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (MHA kv=32) d_ff=13440
vocab=92416, qwen1.5-arch (QKV bias).  [hf:Qwen/CodeQwen1.5-7B; hf]"""
from ..models.transformer import LMConfig
from .base import LM_SHAPES, LM_SKIPS, ArchSpec, register

SPEC = register(ArchSpec(
    id="codeqwen1.5-7b",
    family="lm-dense",
    model_cfg=LMConfig(
        name="codeqwen1.5-7b", n_layer=32, d_model=4096, n_head=32, n_kv=32,
        d_ff=13440, vocab=92416, d_head=128, qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    smoke_cfg=LMConfig(
        name="codeqwen-smoke", n_layer=2, d_model=64, n_head=4, n_kv=4,
        d_ff=128, vocab=256, d_head=16, qkv_bias=True, remat=False,
    ),
    shapes=LM_SHAPES, skips=LM_SKIPS,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
))
