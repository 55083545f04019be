"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) vocab=32768 —
8 experts top-2 (d_ff=16384), sliding-window attention (per assignment).
[arXiv:2401.04088]"""
from ..models.common import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        vocab_size=32768,
        rope_theta=1e6,
        block_pattern=(LayerSpec("attn", 4096, "moe"),),
        n_blocks=56,
        n_experts=8,
        top_k_experts=2,
        d_ff_expert=16384,
        act="silu",
        # SWA everywhere -> KV cache bounded by the window; long_500k runs.
        supports_long_context=True,
    )
