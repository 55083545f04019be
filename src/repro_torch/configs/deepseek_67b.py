"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch. [arXiv:2401.02954]"""
from ..models.common import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=22016,
        vocab_size=102400,
        rope_theta=1e4,
        block_pattern=(LayerSpec("attn", 0, "dense"),),
        n_blocks=95,
        act="silu",
        supports_long_context=False,
    )
