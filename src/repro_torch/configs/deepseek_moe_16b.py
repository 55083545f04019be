"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) vocab=102400 —
fine-grained MoE: layer 0 dense (d_ff=10944), layers 1..27 with 64 routed
experts (d_ff=1408) top-6 + 2 shared experts. [arXiv:2401.06066]"""
from ..models.common import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=10944,          # dense prologue FFN width
        vocab_size=102400,
        rope_theta=1e4,
        prologue=(LayerSpec("attn", 0, "dense"),),
        block_pattern=(LayerSpec("attn", 0, "moe"),),
        n_blocks=27,
        n_experts=64,
        n_shared_experts=2,
        top_k_experts=6,
        d_ff_expert=1408,
        act="silu",
        supports_long_context=False,
    )
