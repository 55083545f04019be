"""Primitive layers (port of repro/models/layers.py): norms, rope, MLPs,
embeddings, with the JAX package's casts (float32 norm and rope, weights
cast to the activations' dtype in ``dense``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import sharding as shard_lib


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, dh); positions: broadcastable (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Gated SwiGLU (act='silu') or plain GeLU MLP (act='gelu', tanh form as
    jax.nn.gelu's default)."""
    if act == "silu":
        h = F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    else:
        h = F.gelu(dense(x, p["w_up"]), approximate="tanh")
    return dense(h, p["w_down"])


def placed_mlp(x: torch.Tensor, p: dict, act: str, d_ff: int) -> torch.Tensor:
    """``mlp``, column-parallel up / gate and row-parallel down where the
    installed placement splits ``ff`` over ``model`` (``w_up``'s width is
    not ``d_ff``): each rank computes its columns, and one sum over
    ``model`` follows ``w_down``."""
    if p["w_up"].shape[-1] == d_ff:
        return mlp(x, p, act)
    return shard_lib.reduce_from(mlp(shard_lib.copy_to(x), p, act))


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """The table's rows at ``tokens``. ``F.embedding`` gathers what
    ``table[tokens]`` does; its backward on the CPU sums each row's
    contributions in a fixed order, where an index's backward does not."""
    return F.embedding(tokens.long(), table).to(compute_dtype)
