"""Rand-Proj-Spatial family estimator (paper Eq. 5), the paper's
contribution; port of repro/core/estimators/rand_proj_spatial.py.

Encode (client i):   z_i = G_i x_i
Decode (server):     x_hat = (beta/n) (T(S))^dagger sum_i G_i^T G_i x_i,
                     S = sum_i G_i^T G_i,  T applied to S's eigenvalues.

Projections: "srht" (G_i = (1/sqrt(d)) E_i H D_i, Eq. 6, the paper's
choice), "subsample" (G_i = E_i: Rand-k-Spatial exactly, Lemma 4.1; its rows
are Rand-k's draw of the same key) and "gauss" (N(0, 1/d) entries).

Three decodes, which agree to float tolerance:

- ``fused`` (the default for srht and subsample): T is affine, so applying
  (T(S) + eps)^-1 to y = sum_i G_i^T z_i is the linear resolvent solve
  ((1 - rho + eps) I + rho S) x = y, x_hat = (beta_eps / n) x, by conjugate
  gradients batched over chunks; each iteration (the Gram apply S p and
  every update) is one launch of the CG step kernel, and y one launch of
  the decode-sum kernel. With the subsample projection S is diagonal (the
  hit counts) and the solve is closed-form with eps = 0, with no kernel;
- ``gram`` (the default for gauss): with A = [G_1; ...; G_n] (nk x d) and
  A A^T = U diag(l) U^T, x_hat = (beta/n) A^T U diag(1_{l>0} / T(l)) U^T z,
  an (nk x nk) eigendecomposition;
- ``direct``: the paper-literal eigendecomposition of S (d x d), the oracle.

``shared_randomness=True`` uses one map per client for every chunk of a
round (one eigendecomposition serves every chunk); ``False`` draws one per
(client, chunk), keyed by the global chunk position, and the gram and
direct decodes batch their eigendecompositions over the chunks.

Every ``encode``, ``_fused_draws``, ``decode`` and ``self_decode`` accepts
explicit ``draws=`` (and the decode a ``bank=``), so the JAX package's draws
and eigenvalue bank can be carried across (repro_torch.interop): srht
{"signs", "rows"}, subsample {"rows"}, gauss {"g"}, leaves (n, 1|C, ...)
stacked or (1|C, ...) for one client.
"""
from __future__ import annotations

import torch

from ... import obs, resolve_device
from ...kernels import ops as kops
from ...kernels import ref as kref
from .. import beta as beta_lib
from .. import random as prand
from .. import transforms
from . import base, rand_k

_EPS = 1e-4         # spectral floor of the gram and direct decodes, relative to max
_CG_TOL = 1e-4      # relative residual target of the resolvent solve
_CHECK_EVERY = 8    # CG iterations between host checks of "all chunks done"


def _client_draw(spec, keys: torch.Tensor) -> dict:
    """One draw per key, in the JAX package's call sequence: srht {"signs":
    +(d,), "rows": +(k,)}, subsample {"rows": +(k,)} (Rand-k's draw of the
    key itself, so Lemma 4.1 holds bit for bit), gauss {"g": +(k, d)}."""
    d, k = spec.d_block, spec.k
    if spec.projection == "srht":
        return prand.srht_draw(keys, d, k)
    if spec.projection == "subsample":
        return {"rows": prand.subset(keys, d, k)}
    return {"g": prand.gauss_map(keys, k, d)}


def _checked(spec, draws: dict, *leads: tuple) -> dict:
    """``draws`` if its leaves are led by one of ``leads``, else ValueError."""
    d, k = spec.d_block, spec.k
    shapes = {"srht": {"signs": (d,), "rows": (k,)}, "subsample": {"rows": (k,)},
              "gauss": {"g": (k, d)}}[spec.projection]
    got = {name: tuple(v.shape) for name, v in draws.items()}
    wants = [{name: lead + shape for name, shape in shapes.items()} for lead in leads]
    if got not in wants:
        raise ValueError(f"{spec.projection} draws must be one of {wants}, got {got}")
    return draws


def _own_draw(spec, key, client_id, c: int, draws, device) -> dict:
    """One client's draws, leaves (1|C, ...): ``draws`` checked, or derived."""
    lead = (1,) if spec.shared_randomness else (c,)
    if draws is not None:
        return _checked(spec, draws, lead)
    return _client_draw(spec, base.draw_keys(key, client_id, c, device, spec.shared_randomness))


def _apply_g(spec, draw: dict, x_cd: torch.Tensor) -> torch.Tensor:
    """G x for one client's chunk batch: (C, d) -> (C, k)."""
    shared = spec.shared_randomness
    if "signs" in draw:
        if shared:
            return kops.srht_encode(x_cd, draw["signs"][0], draw["rows"][0],
                                    use_kernel=spec.use_kernel)
        return kops.srht_encode_batch(x_cd, draw["signs"], draw["rows"],
                                      use_kernel=spec.use_kernel)
    if "g" in draw:
        return x_cd @ draw["g"][0].T if shared else torch.einsum("ckd,cd->ck", draw["g"], x_cd)
    return x_cd[:, draw["rows"][0]] if shared else torch.gather(x_cd, -1, draw["rows"])


def _g_matrix(spec, draw: dict) -> torch.Tensor:
    """G as (..., k, d) matrices, for the gram and direct decodes."""
    d = spec.d_block
    if "signs" in draw:
        return kops.srht_rows_matrix(draw["signs"], draw["rows"], d)
    if "g" in draw:
        return draw["g"]
    return torch.nn.functional.one_hot(draw["rows"], d).to(torch.float32)


def encode(spec, key, client_id, x_cd: torch.Tensor, draws: dict | None = None) -> dict:
    """One client's (C, d) chunks -> {"vals": (C, k)[, "norm_sq": (C,)]}.

    ``draws``: this client's draws, leaves (1|C, ...), as one client's slice
    of ``_fused_draws``; derived from ``key`` when None."""
    draw = _own_draw(spec, key, client_id, x_cd.shape[0], draws, x_cd.device)
    out = {"vals": _apply_g(spec, draw, x_cd)}
    if spec.r_mode == "est":
        out["norm_sq"] = (x_cd.float() ** 2).sum(-1)
    return out


def _fused_draws(spec, key, n, c, client_ids=None, chunk_offset=0, device=None) -> dict:
    """All (client x chunk) draws, stacked: leaves of shape (n, 1, ...) with
    shared randomness, (n, C, ...) otherwise. Chunk draws are keyed by GLOBAL
    chunk position (chunk_offset + local index)."""
    device = resolve_device(device)
    ids = torch.arange(n) if client_ids is None else torch.as_tensor(client_ids)
    ckeys = base.client_key(prand.as_key(key, device), ids.to(device=device, dtype=torch.int64))
    if spec.shared_randomness:
        return _client_draw(spec, ckeys[:, None])
    chunk_ids = chunk_offset + torch.arange(c, device=device)
    out = {}
    for i in range(n):  # one client at a time bounds the hash temporaries
        draw = _client_draw(spec, base.chunk_key(ckeys[i], chunk_ids))
        for name, v in draw.items():
            if name not in out:
                out[name] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device=device)
            out[name][i] = v
    return out


def _stacked_draws(spec, key, n, c, client_ids, chunk_offset, draws, device) -> dict:
    if draws is None:
        return _fused_draws(spec, key, n, c, client_ids, chunk_offset, device)
    # either lead in either mode: a per-chunk decode of draws repeated over
    # the chunks gives the shared decode's bits
    return _checked(spec, draws, (n, 1), (n, c))


def _cg_solve(y, rho, eps, iters, step, dot):
    """Batched CG for ((1 - rho + eps) I + rho S) x = y, one system per chunk.
    ``step(x, r, p, rs, done, c0, c1, tol2)`` runs one iteration IN PLACE and
    ``dot`` gives the row dot products (keepdim).

    Converged chunks are FROZEN (every update is a ``where(done, old, new)``),
    so running more iterations than a chunk needs changes none of its bits.
    That lets the loop test "all chunks done" on the host only every
    ``_CHECK_EVERY`` iterations, with the same result as the JAX loop's test
    on every iteration. y = 0 chunks are done at iteration 0 and return
    exactly 0; the denominators are guarded so they cannot NaN.

    y: (C, d); rho: 0-dim or (C,). -> (x, iterations), the count as the JAX
    loop reports it (iterations begun while some chunk was not done).

    While the metrics registry records, the count is one ``kernels/cg_iters``
    sample a solve. The check that ends the loop reads it in the same
    transfer as "all done", so no read is added; only a solve that runs out
    of iterations reads it once more at its end."""
    c0 = 1.0 - rho + eps
    c1 = rho
    ys = dot(y, y)
    tol2 = (_CG_TOL * _CG_TOL) * ys
    x = torch.zeros_like(y)
    r, p, rs = y.clone(), y.clone(), ys
    done = ys <= tol2
    it = torch.zeros((), dtype=torch.int32, device=y.device)
    recording = obs.enabled()
    for n_step in range(iters):
        if n_step % _CHECK_EVERY == 0:
            if not recording:
                if bool(done.all()):
                    break
            else:
                all_done, count = torch.stack((done.all().to(torch.int32), it)).tolist()
                if all_done:
                    obs.record_cg_iters(count)
                    break
        it = it + (~done.all()).to(torch.int32)
        step(x, r, p, rs, done, c0, c1, tol2)
    else:
        if recording:
            obs.record_cg_iters(int(it))
    return x, it


def _cg_resolvent_solve(y, rho, eps, signs, rows, iters, use_kernel="auto"):
    """The SRHT solve, S v = sum_i G_i^T G_i v with the draws ``signs``
    (n, C|1, d) and ``rows`` (n, C|1, k): each iteration is one
    ``srht_cg_step`` (one kernel launch on the card), its row dot products in
    ``row_dot_ref``'s fixed order on both routes."""
    def step(*state):
        kops.srht_cg_step(*state, signs, rows, use_kernel=use_kernel)

    return _cg_solve(y, rho, eps, iters, step, kref.row_dot_ref)


def _row_sum_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=True)


def cg_resolvent_solve_plain(y, rho, eps, apply_s, iters):
    """The solve for any S given as ``apply_s(v)`` (C, d) -> (C, d), in plain
    PyTorch (the JAX package's ``_cg_resolvent_solve``): SparseProj's decode."""
    def step(x, r, p, rs, done, c0, c1, tol2):
        new = kref.srht_cg_step_ref(x, r, p, rs, done, c0, c1, tol2, None, None,
                                    gram_apply=lambda v, _s, _m: apply_s(v), dot=_row_sum_dot)
        for dst, src in zip((x, r, p, rs, done), new):
            dst.copy_(src)

    return _cg_solve(y, rho, eps, iters, step, _row_sum_dot)


def _bmv(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row c of x (C, p) times matrix m[c] (B, p, q), B in {1, C}. -> (C, q)"""
    if m.shape[0] == 1:
        return x @ m[0]
    return (x[:, None, :] @ m)[:, 0]


def _stack_a(spec, draws: dict) -> torch.Tensor:
    """A = [G_1; ...; G_n] per draw: stacked draws (n, B, ...) -> (B, nk, d)."""
    g = _g_matrix(spec, draws)  # (n, B, k, d)
    n, b = g.shape[:2]
    return g.transpose(0, 1).reshape(b, n * spec.k, spec.d_block)


def _rho_hat(spec, n, z, gram, norm_sq) -> torch.Tensor:
    """Per-chunk online R-hat (docs/DESIGN.md §5). z: (C, n, k); gram:
    (B, nk, nk); norm_sq: (n, C). -> (C,)"""
    scale = spec.d_block / spec.k
    zf = z.reshape(z.shape[0], n * spec.k)
    total_sq = scale**2 * (_bmv(zf, gram) * zf).sum(-1)
    g4 = gram.reshape(gram.shape[0], n, spec.k, n, spec.k)
    per = sum((_bmv(z[:, i], g4[:, i, :, i, :]) * z[:, i]).sum(-1) for i in range(n))
    r_hat = (total_sq - scale**2 * per) / (norm_sq.sum(0) + 1e-12)
    return transforms.clip_rho(r_hat / (n - 1.0), n)


def _spectral_weights(lam: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """1_{l > eps max l} / T(l) per eigenvalue: lam (B, m), rho 0-dim or (C,).
    -> (B or C, m)"""
    mask = lam > _EPS * lam.amax(-1, keepdim=True)
    t = transforms.t_apply(lam, rho if rho.dim() == 0 else rho[:, None])
    return torch.where(mask, 1.0 / t, 0.0)


def _rho(spec, n, z, gram, norm_sq, device) -> torch.Tensor:
    if spec.r_mode == "est":
        return _rho_hat(spec, n, z, gram, norm_sq)
    return torch.tensor(transforms.rho_for(spec.transform, n, spec.r_value),
                        dtype=torch.float32, device=device)


def _beta(spec, n, rho, eps=0.0, bank=None):
    if spec.projection == "subsample":
        # the eigenvalues of S are the binomial hit counts M_j: beta is exact
        # (Lemma 4.1: the estimator IS Rand-k-Spatial), and no ridge is used
        return beta_lib.rand_k_spatial_beta(n, spec.k, spec.d_block, rho)
    if bank is None:
        bank = beta_lib.srht_eig_bank(n, spec.k, spec.d_block, spec.beta_trials,
                                      device=rho.device, projection=spec.projection)
    return beta_lib.beta_fn_from_bank(bank, n, spec.d_block, eps=eps)(rho)


def _scaled(b: torch.Tensor, n: int, xh: torch.Tensor) -> torch.Tensor:
    return ((b / n) if b.dim() == 0 else (b / n)[:, None]) * xh


def _decode_one_gram(spec, n, a, z, norm_sq, bank=None):
    """Gram-trick decode. a: (B, nk, d); z: (C, n, k) -> (C, d)."""
    gram = a @ a.mT
    lam, u = torch.linalg.eigh(gram)
    rho = _rho(spec, n, z, gram, norm_sq, z.device)
    w = _spectral_weights(lam, rho)
    zf = z.reshape(z.shape[0], n * spec.k)
    y = _bmv(_bmv(zf, u) * w, u.mT)
    return _scaled(_beta(spec, n, rho, bank=bank), n, _bmv(y, a))


def _decode_one_direct(spec, n, a, z, norm_sq, bank=None):
    """Paper-literal decode: eigh of S = A^T A (d x d). The oracle."""
    lam, v = torch.linalg.eigh(a.mT @ a)
    rho = _rho(spec, n, z, a @ a.mT, norm_sq, z.device)
    w = _spectral_weights(lam, rho)
    y = _bmv(z.reshape(z.shape[0], n * spec.k), a)  # y_c = A^T z_c
    return _scaled(_beta(spec, n, rho, bank=bank), n, _bmv(_bmv(y, v) * w, v.mT))


def _decode_fused(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None,
                  bank=None):
    """Batched over (clients x chunks), no eigh: srht solves by CG on the
    kernels, subsample in closed form.

    payloads: {"vals": (n, C, k)[, "norm_sq": (n, C)]}. -> (C, d)"""
    d, k = spec.d_block, spec.k
    vals = payloads["vals"].float()
    c = vals.shape[1]
    draws = _stacked_draws(spec, key, n, c, client_ids, chunk_offset, draws, vals.device)
    rows = draws["rows"]
    if "signs" in draws:
        y = kops.srht_decode_sum(vals, draws["signs"], rows, d, use_kernel=spec.use_kernel)
    else:
        y = rand_k.scatter_sum(vals, rows, d)

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
                           dtype=torch.float32, device=vals.device)

    if spec.projection == "subsample":
        # S = diag(hit counts): (T(S))^dagger is an elementwise reciprocal,
        # then a multiply, as in the JAX package (eps = 0)
        hits = rand_k.hit_counts(rows, rows.shape[1], d)
        t = transforms.t_apply(hits, rho if rho.dim() == 0 else rho[:, None])
        return _scaled(_beta(spec, n, rho), n, y * torch.where(hits > 0, 1.0 / t, 0.0))
    xh, _ = _cg_resolvent_solve(y, rho, spec.ridge, draws["signs"], rows, spec.cg_iters,
                                spec.use_kernel)
    return _scaled(_beta(spec, n, rho, eps=spec.ridge, bank=bank), n, xh)


def _resolve_decode_method(spec) -> str:
    method = spec.decode_method or "auto"
    if method == "auto":
        return "fused" if spec.projection in ("srht", "subsample") else "gram"
    return method


def decode(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None, bank=None):
    method = _resolve_decode_method(spec)
    obs.record_decode_route("rand_proj_spatial", method)
    if method == "fused":
        if spec.projection == "gauss":
            raise ValueError('decode_method="fused" needs an SRHT or subsample projection '
                             "(gauss maps have no FWHT structure); use gram, direct or auto")
        return _decode_fused(spec, key, payloads, n, client_ids, chunk_offset, draws=draws,
                             bank=bank)
    vals = payloads["vals"]
    draws = _stacked_draws(spec, key, n, vals.shape[1], client_ids, chunk_offset, draws,
                           vals.device)
    z = vals.movedim(0, 1).float()  # (C, n, k)
    dec = _decode_one_gram if method == "gram" else _decode_one_direct
    return dec(spec, n, _stack_a(spec, draws), z, payloads.get("norm_sq"), bank)


def self_decode(spec, key, client_id, payload, draws=None):
    """Unbiased per-client reconstruction (d/k) G_i^T z_i: E[G^T G] = (k/d) I
    for all three projections. With the subsample projection G^T z is the
    scatter, so it equals Rand-k's self_decode bit for bit (Lemma 4.1).
    ``draws``: this client's, leaves (1|C, ...)."""
    vals = payload["vals"].float()
    draw = _own_draw(spec, key, client_id, vals.shape[0], draws, vals.device)
    scale = spec.d_block / spec.k
    if spec.projection == "subsample":
        return scale * kref.srht_scatter_ref(vals, draw["rows"], spec.d_block)
    g = _g_matrix(spec, draw)  # (1|C, k, d)
    if spec.shared_randomness:
        return scale * (vals @ g[0])
    return scale * torch.einsum("ck,ckd->cd", vals, g)


CODEC = base.Codec(encode=encode, decode=decode, self_decode=self_decode, draws=_fused_draws)
base.register("rand_proj_spatial", CODEC)
