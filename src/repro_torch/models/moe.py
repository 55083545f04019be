"""FFN residual block (port of repro/models/moe.py): the dense branch.

The routed Mixture-of-Experts FFN is not ported yet (ROADMAP A.11, MoE):
``moe_ffn`` raises NotImplementedError.
"""
from __future__ import annotations

import torch

from . import layers


def not_ported(cfg) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: the MoE FFN is not ported to repro_torch yet (ROADMAP A.11, MoE)")


def moe_ffn(x, p, cfg):
    raise not_ported(cfg)


def ffn_layer(x, p, cfg, spec):
    """Pre-norm FFN residual block; dispatches dense vs MoE. -> (y, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "none":
        return x, aux
    b, s, d = x.shape
    xn = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    if spec.ffn == "dense":
        return x + layers.mlp(xn, p, cfg.act), aux
    y, aux = moe_ffn(xn.reshape(b * s, d), p, cfg)
    return x + y.reshape(b, s, d), aux
