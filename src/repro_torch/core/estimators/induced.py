"""Induced compressor (Horvath & Richtarik 2021) with Top-k1 + Rand-k2; port
of repro/core/estimators/induced.py.

C(x) = Top_k1(x) + (d/k2) RandK_k2(x - Top_k1(x)): unbiased, because the
Rand-k part is an unbiased estimator of the Top-k residual. k1 =
round(topk_frac * k), k2 = k - k1 (``Induced.split``). The random part is
``subset`` of the chunk key (core.random; ``draws={"rows": (C, k2)}``
replaces it). Both index sets
travel in the payload, so the decode is free of chunk position.
"""
from __future__ import annotations

import torch

from .. import random as prand
from . import base, top_k


def encode(spec, key, client_id, x_cd, draws=None):
    k1, k2 = spec.split()
    c, d = x_cd.shape
    tidx = top_k.top_indices(x_cd.abs(), max(k1, 1))
    tvals = torch.gather(x_cd, -1, tidx)
    if k1 == 0:
        tvals = torch.zeros((c, 1), dtype=x_cd.dtype, device=x_cd.device)
        tidx = torch.zeros((c, 1), dtype=torch.int64, device=x_cd.device)
    resid = x_cd.scatter_add(-1, tidx, -tvals) if k1 > 0 else x_cd
    if draws is None:
        ridx = prand.subset(base.draw_keys(key, client_id, c, x_cd.device), d, k2)
    else:
        ridx = draws["rows"].long()
        if tuple(ridx.shape) != (c, k2):
            raise ValueError(f"induced draws are {{'rows': {(c, k2)}}}, got {tuple(ridx.shape)}")
    return {
        "top_vals": tvals,
        "top_idx": tidx.to(torch.int32),
        "rand_vals": torch.gather(resid, -1, ridx),
        "rand_idx": ridx.to(torch.int32),
    }


def decode(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None):
    _, k2 = spec.split()
    d = spec.d_block
    top = top_k.scatter_mean(payloads["top_vals"], payloads["top_idx"], n, d)
    rand = top_k.scatter_mean(payloads["rand_vals"], payloads["rand_idx"], n, d)
    return top + (d / k2) * rand


def self_decode(spec, key, client_id, payload, draws=None):
    """Unbiased per-client reconstruction: the Top part exact, the Rand part
    the (d/k2)-scaled scatter."""
    return decode(spec, key, {name: v[None] for name, v in payload.items()}, 1, draws=draws)


base.register("induced", base.Codec(encode=encode, decode=decode, self_decode=self_decode))
