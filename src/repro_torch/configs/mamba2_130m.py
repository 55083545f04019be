"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality), d_inner=1536, headdim=64,
tied embeddings. [arXiv:2405.21060]"""
from ..models.common import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        d_model=768,
        vocab_size=50280,
        block_pattern=(LayerSpec("mamba", 0, "none"),),
        n_blocks=24,
        d_state=128,
        mamba_d_inner=1536,
        mamba_headdim=64,
        mamba_ngroups=1,
        mamba_chunk=256,
        tie_embeddings=True,
        supports_long_context=True,  # recurrent state: O(1) per decoded token
    )
