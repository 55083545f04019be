"""musicgen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens. The EnCodec frontend is a
STUB: input_specs() feeds token ids over the 2048-codeword codebook
(one stream; the 4-codebook interleave is a data-pipeline detail).
[arXiv:2306.05284]"""
from ..models.common import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_head=64,
        d_ff=6144,
        vocab_size=2048,
        rope_theta=1e4,
        block_pattern=(LayerSpec("attn", 0, "dense"),),
        n_blocks=48,
        act="gelu",  # plain (non-gated) FFN
        supports_long_context=False,
    )
