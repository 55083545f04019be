"""Assigned-architecture registry (port of repro/configs): --arch <id>
resolves here. The per-arch modules are pure data, copied from the JAX
package; ``preset_config`` comes from repro/launch/train.py."""
from __future__ import annotations

import dataclasses

from ..models.common import LayerSpec, ModelConfig
from . import (
    deepseek_67b,
    deepseek_coder_33b,
    deepseek_moe_16b,
    gemma3_4b,
    jamba_v0_1_52b,
    llava_next_34b,
    mamba2_130m,
    mixtral_8x22b,
    musicgen_medium,
    qwen1_5_32b,
)

_MODULES = {
    "qwen1.5-32b": qwen1_5_32b,
    "deepseek-67b": deepseek_67b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "gemma3-4b": gemma3_4b,
    "musicgen-medium": musicgen_medium,
    "deepseek-moe-16b": deepseek_moe_16b,
    "mixtral-8x22b": mixtral_8x22b,
    "llava-next-34b": llava_next_34b,
    "mamba2-130m": mamba2_130m,
    "jamba-v0.1-52b": jamba_v0_1_52b,
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list(ARCHS)}")
    return _MODULES[name].config()


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Structurally-identical tiny config for CPU smoke tests."""

    def small_spec(s: LayerSpec) -> LayerSpec:
        return dataclasses.replace(s, window=min(s.window, 8) if s.window else 0)

    kw = dict(
        d_model=64,
        vocab_size=512,
        n_blocks=min(cfg.n_blocks, 2),
        prologue=tuple(small_spec(s) for s in cfg.prologue),
        epilogue=tuple(small_spec(s) for s in cfg.epilogue[:1]),
        block_pattern=tuple(small_spec(s) for s in cfg.block_pattern),
        attn_kv_block=16,
        vocab_pad_multiple=16,
        remat="none",
        dtype="float32",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4, d_head=16)
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.n_experts:
        kw.update(
            n_experts=min(cfg.n_experts, 8),
            top_k_experts=min(cfg.top_k_experts, 2),
            d_ff_expert=32,
            n_shared_experts=min(cfg.n_shared_experts, 1),
        )
    if cfg.mamba_d_inner:
        kw.update(mamba_d_inner=128, mamba_headdim=32, d_state=16, mamba_chunk=8)
    return cfg.replace(**kw)


def preset_config(arch: str, preset: str) -> ModelConfig:
    """``arch``'s config at a preset scale: "full" is the published config,
    "tiny" ``reduce_for_smoke``, "small" a ~100M-class model of the same
    family. Its JAX home is repro/launch/train.py::preset_config; the
    port's training CLI (launch/train.py) and serving CLI both take it
    from here."""
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    if preset == "tiny":
        return reduce_for_smoke(cfg)
    if preset != "small":
        raise ValueError(f"unknown preset {preset!r}; have tiny, small, full")
    kw = dict(d_model=512, vocab_size=8192, n_blocks=min(cfg.n_blocks, 8),
              vocab_pad_multiple=64, remat="none", dtype="float32")
    if cfg.n_heads:
        kw.update(n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4), d_head=64)
    if cfg.d_ff:
        kw.update(d_ff=2048)
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 8), d_ff_expert=512)
    if cfg.mamba_d_inner:
        kw.update(mamba_d_inner=1024, d_state=64)
    return cfg.replace(**kw)
