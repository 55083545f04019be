"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-arch. [arXiv:2401.14196]"""
from ..models.common import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=19200,
        vocab_size=32256,
        rope_theta=1e5,
        block_pattern=(LayerSpec("attn", 0, "dense"),),
        n_blocks=62,
        act="silu",
        supports_long_context=False,
    )
