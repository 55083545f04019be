"""Rand-k-Spatial family (Jhunjhunwala et al. 2021), paper Eq. 2/3; port of
repro/core/estimators/rand_k_spatial.py.

Encoding is Rand-k's. The server scales coordinate j by beta / T(M_j), where
M_j is the number of clients that sent coordinate j and T(m) = 1 + rho (m-1)
interpolates with the degree of correlation. beta is exact (the binomial
expectation of core/beta.py). ``r_mode="est"`` estimates R in the decode
from the payloads and each client's ||x_i||^2, one rho for the whole vector.
"""
from __future__ import annotations

import torch

from .. import beta as beta_lib
from .. import transforms
from . import base, rand_k


def encode(spec, key, client_id, x_cd: torch.Tensor, draws: dict | None = None) -> dict:
    payload = rand_k.encode(spec, key, client_id, x_cd, draws=draws)
    if spec.r_mode == "est":
        payload["norm_sq"] = (x_cd.float() ** 2).sum(-1)
    return payload


def _rho(spec, n, payloads, s) -> torch.Tensor:
    if spec.r_mode != "est":
        return torch.tensor(transforms.rho_for(spec.transform, n, spec.r_value),
                            dtype=torch.float32, device=s.device)
    # online R-hat from unbiased per-client decodes (docs/DESIGN.md §5):
    #   sum_{i != l} <xh_i, xh_l> = ||sum_i xh_i||^2 - sum_i ||xh_i||^2,
    # with xh_i = (d/k) scatter(vals_i) and exact ||x_i||^2 side information
    scale = spec.d_block / spec.k
    sum_dec_sq = ((scale * s) ** 2).sum()
    per_client_sq = scale**2 * (payloads["vals"].float() ** 2).sum()
    r_hat = (sum_dec_sq - per_client_sq) / (payloads["norm_sq"].sum() + 1e-12)
    return transforms.clip_rho(r_hat / (n - 1.0), n)


def decode(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None):
    s, m = rand_k.scatter_sum_and_counts(spec, key, payloads["vals"], n, client_ids,
                                         chunk_offset, draws)
    rho = _rho(spec, n, payloads, s)
    b = beta_lib.rand_k_spatial_beta(n, spec.k, spec.d_block, rho)
    t = transforms.t_apply(m, rho)
    scaled = torch.where(m > 0, s / torch.where(m > 0, t, 1.0), 0.0)
    return (b / n) * scaled


# Encoding is Rand-k's, so the unbiased per-client reconstruction is too.
CODEC = base.Codec(encode=encode, decode=decode, self_decode=rand_k.self_decode,
                   draws=rand_k.round_draws)
base.register("rand_k_spatial", CODEC)
