"""Model configuration (port of repro/models/common.py): a layer-pattern spec
covering every assigned arch.

A model is  prologue + block_pattern * n_blocks + epilogue  of LayerSpecs.
The repeated block's weights are stacked on a leading "layers" axis, as in
the JAX package, so the two parameter trees compare leaf by leaf; the port
runs the blocks in a Python loop where the JAX package scans them.
``compute_dtype`` / ``params_dtype`` are torch dtypes here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name as a torch.dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {list(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: Literal["attn", "mamba"] = "attn"
    window: int = 0                      # 0 = global attention, else SWA size
    ffn: Literal["dense", "moe", "none"] = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab_size: int
    # layer layout
    block_pattern: tuple[LayerSpec, ...]
    n_blocks: int
    prologue: tuple[LayerSpec, ...] = ()
    epilogue: tuple[LayerSpec, ...] = ()
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # dense ffn
    d_ff: int = 0
    act: Literal["silu", "gelu"] = "silu"   # silu => gated (SwiGLU); gelu => plain
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # mamba (SSD)
    d_state: int = 0
    d_conv: int = 4
    mamba_d_inner: int = 0
    mamba_headdim: int = 64
    mamba_ngroups: int = 1
    mamba_chunk: int = 256
    # perf knob (docs/EXPERIMENTS.md §Perf H-a): split the fused in_proj into
    # separate z/x/BC/dt projections so the big z/x output dims are
    # TP-divisible (the fused width 2*di+2gN+nh generally is not) — pure
    # layout change, functionally identical.
    mamba_split_proj: bool = False
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    input_mode: Literal["tokens", "embeddings"] = "tokens"
    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"
    remat: Literal["none", "block"] = "block"
    # Cost-calibration mode (launch/dryrun.py --calibrate): python-loop over
    # blocks + fully-unrolled inner scans, so the compiled HLO has NO while
    # loops and cost_analysis()/collective parsing are exact. Used at reduced
    # n_blocks (1, 2) and affine-extrapolated to full depth.
    force_unroll: bool = False
    attn_kv_block: int = 1024            # flash-style kv chunk for train/prefill
    attn_impl: Literal["blocked", "flash"] = "blocked"  # flash = Pallas kernel
    # perf knob (docs/EXPERIMENTS.md §Perf): materialise GQA as MHA activations
    # (repeat kv heads to n_heads right after projection). Bit-identical
    # outputs; makes the kv activation head-dim TP-divisible when
    # n_kv_heads < model-axis size (kv=8 on a 16-way axis otherwise forces
    # GSPMD rematerialisation all-gathers every layer).
    gqa_repeat_kv: bool = False
    vocab_pad_multiple: int = 256
    # which shapes this arch supports (docs/DESIGN.md §6)
    supports_long_context: bool = False  # sub-quadratic (SSM/hybrid/SWA)

    # ------------------------------------------------------------- derived
    @property
    def layers(self) -> tuple[LayerSpec, ...]:
        return self.prologue + self.block_pattern * self.n_blocks + self.epilogue

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def mamba_heads(self) -> int:
        return self.mamba_d_inner // self.mamba_headdim if self.mamba_d_inner else 0

    @property
    def mamba_conv_dim(self) -> int:
        # conv runs over (x, B, C) as in Mamba2
        return self.mamba_d_inner + 2 * self.mamba_ngroups * self.d_state

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Total parameter count, from the port's own ``param_defs``."""
        from . import transformer  # lazy: avoid import cycle

        return sum(math.prod(leaf.shape)
                   for leaf in transformer.def_leaves(transformer.param_defs(self)))

    def n_params_active(self) -> int:
        """Active (per-token) parameters: MoE counts shared + top_k routed."""
        if self.n_experts == 0:
            return self.n_params()
        total = self.n_params()
        # subtract the non-activated routed experts' weights
        per_expert = 3 * self.d_model * self.d_ff_expert
        n_moe_layers = sum(1 for l in self.layers if l.ffn == "moe")
        inactive = n_moe_layers * (self.n_experts - self.top_k_experts) * per_expert
        return total - inactive
