"""qwen1.5-32b [dense]: 64L d_model=5120 40H (MHA kv=40) d_ff=27392
vocab=152064 — QKV bias. [hf:Qwen/Qwen1.5-32B]"""
from ..models.common import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        d_head=128,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        block_pattern=(LayerSpec("attn", 0, "dense"),),
        n_blocks=64,
        act="silu",
        supports_long_context=False,  # pure full attention -> long_500k skipped
    )
