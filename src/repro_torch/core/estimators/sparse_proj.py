"""SparseProj: very-sparse random projection with the correlation-aware
Gram-resolvent decode, the cheap-encode member of the Rand-Proj-Spatial
family (Achlioptas 2003, Li et al. 2006); port of
repro/core/estimators/sparse_proj.py.

Encode (client i):   z_i = G_i x_i; each of G_i's k rows holds ``nnz``
drawn columns with Rademacher signs and magnitude 1/sqrt(nnz): unit-norm
rows, E[G^T G] = (k/d) I, the family's convention, at O(k nnz) encode work.

Decode (server):     x_hat = (beta_eps / n) (T(S) + eps I)^-1 sum_i G_i^T z_i,
T(lambda) = 1 - rho + rho lambda, solved matrix-free by the batched CG with
converged chunks frozen (``rand_proj_spatial.cg_resolvent_solve_plain``,
plain PyTorch: no kernel stands behind these ops in either package). beta
comes from a simulated eigenvalue bank of the sparse ensemble
(``beta.sparse_eig_bank``, keyed by nnz).

``r_mode="est"``: sparse rows overlap across clients (G_i G_i^T != I_k), so
the online R-hat reads the exact per-client adjoints and pools every chunk
into one scalar rho; that decode is not shardable by chunk.

Draws come from the round key (core.random.sparse_draw of the client key,
or of the chunk key by GLOBAL chunk position without shared randomness), so
only the k values a chunk cross the wire. Every function takes
``draws={"signs", "cols"}``: stacked (n, 1|C, k, nnz) for the decode, one
client's (1|C, k, nnz) for the encode and ``self_decode``, so the JAX
package's draws can be carried across (repro_torch.interop).
"""
from __future__ import annotations

import torch

from ... import obs, resolve_device
from ...kernels import ops as kops
from ...kernels import ref as kref
from .. import beta as beta_lib
from .. import random as prand
from .. import transforms
from . import base
from .rand_proj_spatial import _scaled, cg_resolvent_solve_plain


def _checked(spec, draws: dict, *leads: tuple) -> dict:
    """``draws`` if both leaves are led by one of ``leads``, else ValueError."""
    got = {name: tuple(v.shape) for name, v in draws.items()}
    tail = (spec.k, spec.nnz)
    wants = [{"cols": lead + tail, "signs": lead + tail} for lead in leads]
    if got not in wants:
        raise ValueError(f"sparse_proj draws must be one of {wants}, got {got}")
    return draws


def _own_draw(spec, key, client_id, c: int, draws, device) -> dict:
    """One client's draws, leaves (1|C, k, nnz): ``draws`` checked, or derived."""
    if draws is not None:
        return _checked(spec, draws, (1,) if spec.shared_randomness else (c,))
    keys = base.draw_keys(key, client_id, c, device, spec.shared_randomness)
    return prand.sparse_draw(keys, spec.d_block, spec.k, spec.nnz)


def _draws(spec, key, n, c, client_ids=None, chunk_offset=0, draws=None, device=None) -> dict:
    """All (client x chunk) draws, stacked: leaves (n, 1, k, nnz) with shared
    randomness, (n, C, k, nnz) otherwise, keyed by GLOBAL chunk position, or
    the given ``draws`` checked (either lead in either mode)."""
    if draws is not None:
        return _checked(spec, draws, (n, 1), (n, c))
    device = resolve_device(device)
    ids = range(n) if client_ids is None else [int(i) for i in client_ids]
    per = [prand.sparse_draw(base.draw_keys(key, cid, c, device, spec.shared_randomness,
                                            chunk_offset), spec.d_block, spec.k, spec.nnz)
           for cid in ids]
    return {name: torch.stack([p[name] for p in per]) for name in ("signs", "cols")}


def encode(spec, key, client_id, x_cd: torch.Tensor, draws: dict | None = None) -> dict:
    """One client's (C, d) chunks -> {"vals": (C, k)[, "norm_sq": (C,)]}."""
    draw = _own_draw(spec, key, client_id, x_cd.shape[0], draws, x_cd.device)
    out = {"vals": kops.sparse_proj_encode(x_cd, draw["signs"], draw["cols"])}
    if spec.r_mode == "est":
        out["norm_sq"] = (x_cd.float() ** 2).sum(-1)
    return out


def _beta(spec, n, rho, eps, bank=None):
    if bank is None:
        bank = beta_lib.sparse_eig_bank(n, spec.k, spec.d_block, spec.nnz, spec.beta_trials,
                                        device=rho.device)
    return beta_lib.beta_fn_from_bank(bank, n, spec.d_block, eps=eps)(rho)


def decode(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None, bank=None):
    """Gram-resolvent decode, matrix-free over the sparse maps. -> (C, d)"""
    obs.record_decode_route("sparse_proj", "resolvent")
    d, k = spec.d_block, spec.k
    vals = payloads["vals"].float()  # (n, C, k)
    draws = _draws(spec, key, n, vals.shape[1], client_ids, chunk_offset, draws, vals.device)
    signs, cols = draws["signs"], draws["cols"]
    adj = kops.sparse_proj_adjoint(vals, signs, cols, d)  # (n, C, d)
    y = kref.client_sum(adj)
    if spec.r_mode == "est":
        # the pooled online R-hat from the exact per-client adjoints (sparse
        # rows overlap, so ||G_i^T z_i||^2 != ||z_i||^2): one scalar rho
        sc = (d / k) ** 2
        r_hat = (sc * (y * y).sum() - sc * (adj * adj).sum()) / (
            payloads["norm_sq"].float().sum() + 1e-12)
        rho = transforms.clip_rho(r_hat / (n - 1.0), n)
    else:
        rho = torch.tensor(transforms.rho_for(spec.transform, n, spec.r_value),
                           dtype=torch.float32, device=vals.device)
    del adj
    xh, _ = cg_resolvent_solve_plain(
        y, rho, spec.ridge, lambda v: kops.sparse_proj_gram_apply(v, signs, cols), spec.cg_iters)
    return _scaled(_beta(spec, n, rho, spec.ridge, bank), n, xh)


def self_decode(spec, key, client_id, payload, draws=None):
    """Unbiased per-client reconstruction (d/k) G_i^T z_i: E[G^T G] = (k/d) I
    for the unit-row-norm sparse ensemble. ``draws``: this client's."""
    vals = payload["vals"].float()  # (C, k)
    draw = _own_draw(spec, key, client_id, vals.shape[0], draws, vals.device)
    return (spec.d_block / spec.k) * kops.sparse_proj_adjoint(vals, draw["signs"], draw["cols"],
                                                              spec.d_block)


CODEC = base.Codec(encode=encode, decode=decode, self_decode=self_decode, draws=_draws)
base.register("sparse_proj", CODEC)
