"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — Yi-34B-style LM backbone; the anyres vision tower is a STUB:
input_specs() provides precomputed patch embeddings concatenated with text
embeddings (input_mode="embeddings"). [hf:llava-hf/llava-v1.6-34b]"""
from ..models.common import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5e6,
        block_pattern=(LayerSpec("attn", 0, "dense"),),
        n_blocks=60,
        act="silu",
        input_mode="embeddings",
        supports_long_context=False,
    )
