"""Non-uniform adaptive sparsification (Wangni et al. 2018), "Rand-k(Wangni)";
port of repro/core/estimators/wangni.py.

Coordinate j is kept with probability p_j and rescaled to x_j / p_j, with
p_j = min(1, |x_j| / tau) and tau the water level that solves
sum_j min(1, |x_j| / tau) = k, found by 12 saturation iterations.

Bernoulli selection has a variable size; the payload has a fixed capacity
of ceil(capacity * k) slots and keeps the largest |x_j / p_j| of the kept
coordinates (a rare overflow drops the smallest: a small, documented bias).
The Bernoulli draw is ``uniform < p`` from the chunk key
(core.random.uniform); ``draws={"uniform": (C, d)}`` replaces the uniforms.
The chosen indices travel in the payload, so the decode is free of chunk
position.
"""
from __future__ import annotations

import torch

from .. import random as prand
from . import base, top_k

_ITERS = 12


def probabilities(x: torch.Tensor, k: int) -> torch.Tensor:
    """Optimal inclusion probabilities, chunk by chunk: x (..., d) -> (..., d)."""
    a = x.abs() + 1e-30
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    sat = torch.zeros_like(a, dtype=torch.bool)
    for _ in range(_ITERS):
        denom = torch.where(sat, zero, a).sum(-1, keepdim=True)
        budget = k - sat.sum(-1, keepdim=True).to(a.dtype)
        tau = denom / torch.clamp(budget, min=1e-30)
        sat = sat | (a >= tau)
    denom = torch.where(sat, zero, a).sum(-1, keepdim=True)
    budget = torch.clamp(k - sat.sum(-1, keepdim=True).to(a.dtype), min=0.0)
    p = torch.where(sat, 1.0, a * budget / torch.clamp(denom, min=1e-30))
    return torch.clamp(p, 0.0, 1.0)


def encode(spec, key, client_id, x_cd, draws=None):
    c, d = x_cd.shape
    if draws is None:
        u = prand.uniform(base.draw_keys(key, client_id, c, x_cd.device), (d,))
    else:
        u = draws["uniform"]
        if tuple(u.shape) != (c, d):
            raise ValueError(f"wangni draws are {{'uniform': {(c, d)}}}, got {tuple(u.shape)}")
    p = probabilities(x_cd, spec.k)
    keep = u < p
    scaled = torch.where(keep, x_cd / torch.clamp(p, min=1e-30), 0.0)
    # fixed-capacity packing: the largest |scaled| of the kept coordinates
    score = torch.where(keep, scaled.abs(), -1.0)
    idx = top_k.top_indices(score, spec.capacity_slots)
    vals = torch.where(torch.gather(keep, -1, idx), torch.gather(scaled, -1, idx), 0.0)
    return {"vals": vals, "idx": idx.to(torch.int32)}


def decode(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None):
    return top_k.scatter_mean(payloads["vals"], payloads["idx"], n, spec.d_block)


def self_decode(spec, key, client_id, payload, draws=None):
    return top_k.scatter_mean(payload["vals"][None], payload["idx"][None], 1, spec.d_block)


base.register("wangni", base.Codec(encode=encode, decode=decode, self_decode=self_decode))
