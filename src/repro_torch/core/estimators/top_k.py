"""Top-k sparsification (Shi et al. 2019): the largest-|x| coordinates; port
of repro/core/estimators/top_k.py.

Biased; it pairs with error feedback in training. Its indices depend on the
data, so they travel in the payload (int32 per coordinate), and its decode
is free of chunk position: ``chunk_offset`` is accepted and ignored.
"""
from __future__ import annotations

import torch

from . import base, rand_k


def top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores of each row, largest first, ties to
    the lower index (as ``jax.lax.top_k``), the same on every device."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def encode(spec, key, client_id, x_cd, draws=None):
    base.no_draws(spec, draws)
    idx = top_indices(x_cd.abs(), spec.k)
    return {"vals": torch.gather(x_cd, -1, idx), "idx": idx.to(torch.int32)}


def scatter_mean(vals, idx, n, d):
    """(1/n) sum_i scatter(vals_i at idx_i), summed in client order:
    vals, idx (n, C, m), each row of idx distinct. -> (C, d)"""
    return rand_k.scatter_sum(vals, idx.long(), d) / n


def decode(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None):
    return scatter_mean(payloads["vals"], payloads["idx"], n, spec.d_block)


def self_decode(spec, key, client_id, payload, draws=None):
    return scatter_mean(payload["vals"][None], payload["idx"][None], 1, spec.d_block)


base.register("top_k", base.Codec(encode=encode, decode=decode, self_decode=self_decode))
