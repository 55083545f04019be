"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
— 5:1 local(sliding 1024):global interleave, 128k context, tied embeddings.
[hf:google/gemma-3-4b-pt]"""
from ..models.common import LayerSpec, ModelConfig

_LOCAL = LayerSpec("attn", 1024, "dense")
_GLOBAL = LayerSpec("attn", 0, "dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=10240,
        vocab_size=262144,
        rope_theta=1e6,
        block_pattern=(_LOCAL,) * 5 + (_GLOBAL,),
        n_blocks=5,
        epilogue=(_LOCAL,) * 4,  # 34 = 5*6 + 4
        act="silu",
        tie_embeddings=True,
        # 5/6 of layers have a bounded (1024) cache; long_500k runs (DESIGN §6)
        supports_long_context=True,
    )
