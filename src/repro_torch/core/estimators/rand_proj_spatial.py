"""Rand-Proj-Spatial estimator (paper Eq. 5), the paper's contribution; port
of repro/core/estimators/rand_proj_spatial.py, fused decode route.

Encode (client i):   z_i = G_i x_i,  G_i = (1/sqrt(d)) E_i H D_i   (SRHT, Eq. 6)
Decode (server):     x_hat = (beta_eps / n) x,
                     ((1 - rho + eps) I + rho S) x = y,  y = sum_i G_i^T z_i

T is affine, so applying (T(S) + eps)^-1 to y is a linear resolvent solve:
conjugate gradients, batched over chunks; each iteration (the Gram apply
S p and every update) is one launch of the CG step kernel. y is one launch
of the decode-sum kernel.

``shared_randomness=True`` uses one map per client for every chunk of a
round; ``False`` draws one per (client, chunk), keyed by the global chunk
position. Only ``projection="srht"`` and the fused decode are ported; the
gram and direct decodes, ``self_decode`` and the subsample and gauss
projections are still to port (ROADMAP).

Every ``encode``, ``_fused_draws`` and ``decode`` accepts explicit
``draws=`` (and the decode a ``bank=``), so the JAX package's draws and
eigenvalue bank can be carried across (repro_torch.interop).
"""
from __future__ import annotations

import torch

from ... import resolve_device
from ...kernels import ops as kops
from ...kernels import ref as kref
from .. import beta as beta_lib
from .. import random as prand
from .. import transforms
from . import base

_CG_TOL = 1e-4      # relative residual target of the resolvent solve
_CHECK_EVERY = 8    # CG iterations between host checks of "all chunks done"


def _client_draw(spec, keys: torch.Tensor) -> dict:
    """SRHT draws for a tensor of keys: signs keys.shape+(d,), rows +(k,)."""
    return prand.srht_draw(keys, spec.d_block, spec.k)


def encode(spec, key, client_id, x_cd: torch.Tensor, draws: dict | None = None) -> dict:
    """One client's (C, d) chunks -> {"vals": (C, k)[, "norm_sq": (C,)]}.

    ``draws``: this client's {"signs": (1|C, d), "rows": (1|C, k)}, as one
    client's slice of ``_fused_draws``; derived from ``key`` when None."""
    c = x_cd.shape[0]
    if draws is None:
        ckey = base.client_key(prand.as_key(key, x_cd.device), client_id)
        if not spec.shared_randomness:
            ckey = base.chunk_key(ckey, torch.arange(c, device=x_cd.device))
        draws = _client_draw(spec, ckey)
        signs, rows = draws["signs"], draws["rows"]
    else:
        want = 1 if spec.shared_randomness else c
        signs, rows = draws["signs"], draws["rows"]
        if signs.shape != (want, spec.d_block) or rows.shape != (want, spec.k):
            raise ValueError(
                f"draws for one client must be ({want}, d) signs and ({want}, k) rows, "
                f"got {tuple(signs.shape)} and {tuple(rows.shape)}"
            )
        if spec.shared_randomness:
            signs, rows = signs[0], rows[0]
    if spec.shared_randomness:
        vals = kops.srht_encode(x_cd, signs, rows, use_kernel=spec.use_kernel)
    else:
        vals = kops.srht_encode_batch(x_cd, signs, rows, use_kernel=spec.use_kernel)
    out = {"vals": vals}
    if spec.r_mode == "est":
        out["norm_sq"] = (x_cd.float() ** 2).sum(-1)
    return out


def _fused_draws(spec, key, n, c, client_ids=None, chunk_offset=0, device=None) -> dict:
    """All (client x chunk) draws, stacked for the batched kernels: leaves of
    shape (n, 1, ...) with shared randomness, (n, C, ...) otherwise. Chunk
    draws are keyed by GLOBAL chunk position (chunk_offset + local index)."""
    device = resolve_device(device)
    ids = torch.arange(n) if client_ids is None else torch.as_tensor(client_ids)
    ckeys = base.client_key(prand.as_key(key, device), ids.to(device=device, dtype=torch.int64))
    if spec.shared_randomness:
        return _client_draw(spec, ckeys[:, None])
    d, k = spec.d_block, spec.k
    signs = torch.empty((n, c, d), dtype=torch.float32, device=device)
    rows = torch.empty((n, c, k), dtype=torch.int64, device=device)
    chunk_ids = chunk_offset + torch.arange(c, device=device)
    for i in range(n):  # one client at a time bounds the hash temporaries
        draw = _client_draw(spec, base.chunk_key(ckeys[i], chunk_ids))
        signs[i], rows[i] = draw["signs"], draw["rows"]
    return {"signs": signs, "rows": rows}


def _cg_resolvent_solve(y, rho, eps, signs, rows, iters, use_kernel="auto"):
    """Batched CG for ((1 - rho + eps) I + rho S) x = y, one system per chunk,
    S v = sum_i G_i^T G_i v with the draws ``signs`` (n, C|1, d) and ``rows``
    (n, C|1, k). Each iteration is one ``srht_cg_step`` (one kernel launch
    on the card), which updates x, r, p, rs and done in place.

    Converged chunks are FROZEN (every update is a ``where(done, old, new)``),
    so running more iterations than a chunk needs changes none of its bits.
    That lets the loop test "all chunks done" on the host only every
    ``_CHECK_EVERY`` iterations, with the same result as the JAX loop's test
    on every iteration. y = 0 chunks are done at iteration 0 and return
    exactly 0; the denominators are guarded so they cannot NaN. The row dot
    products sum in ``row_dot_ref``'s fixed order, on both routes.

    y: (C, d); rho: 0-dim or (C,). -> (x, iterations), the count as the JAX
    loop reports it (iterations begun while some chunk was not done)."""
    c0 = 1.0 - rho + eps
    c1 = rho
    ys = kref.row_dot_ref(y, y)
    tol2 = (_CG_TOL * _CG_TOL) * ys
    x = torch.zeros_like(y)
    r, p, rs = y.clone(), y.clone(), ys
    done = ys <= tol2
    it = torch.zeros((), dtype=torch.int32, device=y.device)
    for step in range(iters):
        if step % _CHECK_EVERY == 0 and bool(done.all()):
            break
        it = it + (~done.all()).to(torch.int32)
        kops.srht_cg_step(x, r, p, rs, done, c0, c1, tol2, signs, rows, use_kernel=use_kernel)
    return x, it


def _beta(spec, n, rho, eps=0.0, bank=None):
    if bank is None:
        bank = beta_lib.srht_eig_bank(n, spec.k, spec.d_block, spec.beta_trials,
                                      device=rho.device)
    return beta_lib.beta_fn_from_bank(bank, n, spec.d_block, eps=eps)(rho)


def _decode_fused(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None,
                  bank=None):
    """Kernel fast-path decode, batched over (clients x chunks), no eigh.

    payloads: {"vals": (n, C, k)[, "norm_sq": (n, C)]}. -> (C, d)"""
    d, k = spec.d_block, spec.k
    vals = payloads["vals"].float()
    device = vals.device
    c = vals.shape[1]
    if draws is None:
        draws = _fused_draws(spec, key, n, c, client_ids, chunk_offset, device=device)
    signs, rows = draws["signs"], draws["rows"]

    y = kops.srht_decode_sum(vals, signs, rows, d, use_kernel=spec.use_kernel)

    if spec.r_mode == "est":
        # matrix-free R-hat: ||A^T z||^2 = ||y||^2 and z_i^T G_i G_i^T z_i =
        # ||z_i||^2, since G_i G_i^T = I_k for distinct rows
        sc = (d / k) ** 2
        tot = sc * (y * y).sum(-1)
        per = sc * (vals * vals).sum(dim=(0, 2))
        r_hat = (tot - per) / (payloads["norm_sq"].float().sum(0) + 1e-12)
        rho = transforms.clip_rho(r_hat / (n - 1.0), n)
    else:
        rho = torch.tensor(transforms.rho_for(spec.transform, n, spec.r_value),
                           dtype=torch.float32, device=device)

    xh, _ = _cg_resolvent_solve(y, rho, spec.ridge, signs, rows, spec.cg_iters,
                                spec.use_kernel)
    b = _beta(spec, n, rho, eps=spec.ridge, bank=bank)
    scale = (b / n) if b.dim() == 0 else (b / n)[:, None]
    return scale * xh


def decode(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None, bank=None):
    method = spec.decode_method or "auto"
    if method not in ("auto", "fused"):
        raise NotImplementedError(
            f"decode_method={method!r} is not ported yet (ROADMAP A.3)"
        )
    return _decode_fused(spec, key, payloads, n, client_ids, chunk_offset, draws=draws,
                         bank=bank)


CODEC = base.Codec(encode=encode, decode=decode)
base.register("rand_proj_spatial", CODEC)
