"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 — Jamba period-8 block:
1 attention (32H GQA kv=8) : 7 mamba, MoE (16 experts top-2, d_ff=14336) on
odd layers, dense FFN (14336) on even layers. Mamba sublayers: d_inner=8192,
d_state=16. [arXiv:2403.19887]

NOTE (docs/DESIGN.md §7): Jamba uses Mamba-1 sublayers; we realise them with the
Mamba2/SSD block at matching (d_inner, d_state) — same interface and
asymptotics, documented simplification.
"""
from ..models.common import LayerSpec, ModelConfig


def _block():
    out = []
    for i in range(8):
        kind = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        out.append(LayerSpec(kind, 0, ffn))
    return tuple(out)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=65536,
        rope_theta=1e4,
        block_pattern=_block(),
        n_blocks=4,
        n_experts=16,
        top_k_experts=2,
        d_ff_expert=14336,
        d_state=16,
        mamba_d_inner=8192,
        mamba_headdim=64,
        mamba_ngroups=1,
        mamba_chunk=256,
        act="silu",
        supports_long_context=True,  # 28/32 layers recurrent; 4 attn layers
    )
