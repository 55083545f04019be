"""Normalisation constant beta (port of repro/core/beta.py).

Unbiasedness of x_hat = (beta/n) (T(S) + eps)^-1 sum_i G_i^T G_i x_i needs

    beta = n d / E[ sum_j lambda_j / (T(lambda_j) + eps) ]

over the eigenvalues lambda_j of the nk x nk Gram matrix A A^T. As in the JAX
package, an *eigenvalue bank* (trials, nk) is simulated once per (n, k, d)
and beta(rho) is a reduction over it for any rho. The port draws the JAX
package's maps in its call sequence (``split(key(seed), trials)``, then
``split(trial_key, n)``, then each client's draw) on core.random's
threefry, so the bank samples the same maps as JAX's. It simulates on the device it is asked
for, batched to bound memory, and caches the bank in memory and on disk
under ``.cache/beta_torch/`` at the checkout root (or
``$REPRO_TORCH_BETA_CACHE``), never in the JAX package's ``.cache/beta``.
A bank's file name carries its generator and its projection, so a bank of
the port's earlier counter hash (cached under a name without a generator)
is never read for a threefry run. ``projection=`` picks the maps:
"srht" (rows by permutation, as the JAX bank draws them), "gauss" (N(0,
1/d) entries, core.random.gauss_map) or "sparse<nnz>" (SparseProj's
very-sparse maps, core.random.sparse_draw, by ``sparse_eig_bank``).

Closed forms, the fast paths and test oracles of the JAX package:
rho = 0 (T == 1) gives tr(S) = nk exactly, so beta = d/k (``srht_beta``).

JAX evaluates beta at trace time; the port evaluates it eagerly at the first
decode. For Rand-k-Spatial beta is exact from the binomial pmf.
"""
from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from .. import resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from . import random as prand
from . import transforms

_CACHE_DIR = os.environ.get(
    "REPRO_TORCH_BETA_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", ".cache",
                 "beta_torch"),
)
_BANKS: dict = {}


def default_trials(n: int, k: int) -> int:
    nk = n * k
    return int(max(64, min(512, (1 << 18) // max(nk, 1))))


PROJECTIONS = ("srht", "gauss", "sparse<nnz>")


def _sparse_nnz(projection: str) -> int | None:
    """nnz of a "sparse<nnz>" projection name, else None."""
    tail = projection[len("sparse"):]
    return int(tail) if projection.startswith("sparse") and tail.isdigit() else None


def _bank_path(n: int, k: int, d: int, trials: int, seed: int, projection: str) -> str:
    return os.path.join(_CACHE_DIR,
                        f"threefry_{projection}_eigs_n{n}_k{k}_d{d}_t{trials}_s{seed}.npy")


def _maps(ck: torch.Tensor, k: int, d: int, projection: str) -> torch.Tensor:
    """ck.shape + (k, d) random maps, one per key."""
    if projection == "srht":
        draw = prand.srht_draw(ck, d, k, rows_by="permutation")
        return kops.srht_rows_matrix(draw["signs"], draw["rows"], d)
    nnz = _sparse_nnz(projection)
    if nnz is not None:
        # G = (1/sqrt(nnz)) scatter-add of the signs at the columns (repeats merge)
        draw = prand.sparse_draw(ck, d, k, nnz)
        g = torch.zeros(draw["cols"].shape[:-2] + (k, d), device=ck.device)
        return g.scatter_add_(-1, draw["cols"], draw["signs"]) * (1.0 / math.sqrt(nnz))
    return prand.gauss_map(ck, k, d)


def simulate_bank(n: int, k: int, d: int, trials: int, seed: int = 0,
                  device=None, projection: str = "srht") -> np.ndarray:
    """(trials, nk) float32 eigenvalues of A A^T, A the stack of n random maps."""
    if projection not in ("srht", "gauss") and _sparse_nnz(projection) is None:
        raise ValueError(f"no eigenvalue bank for projection {projection!r}; have {PROJECTIONS}")
    device = resolve_device(device)
    tkeys = prand.split(prand.key(seed, device), trials)
    bs = max(1, min(trials, (1 << 24) // (n * k * d)))
    out = []
    for i in range(0, trials, bs):
        ck = prand.split(tkeys[i:i + bs], n)                          # b x n keys
        a = _maps(ck, k, d, projection).reshape(-1, n * k, d)
        gram = a @ a.transpose(-1, -2)
        out.append(torch.linalg.eigvalsh(gram).cpu())
    return torch.cat(out).numpy().astype(np.float32)


def srht_eig_bank(n: int, k: int, d: int, trials: int | None = None, seed: int = 0,
                  device=None, projection: str = "srht") -> np.ndarray:
    """(trials, nk) eigenvalue bank for S with n random-map clients; cached in
    memory and on disk. ``device`` is where a missing bank is simulated."""
    trials = trials or default_trials(n, k)
    ck = (n, k, d, trials, seed, projection)
    if ck in _BANKS:
        return _BANKS[ck]
    path = _bank_path(*ck)
    if os.path.exists(path):
        eigs = np.load(path)
    else:
        eigs = simulate_bank(*ck[:5], device, projection)
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        np.save(tmp, eigs)
        os.replace(tmp, path)
    _BANKS[ck] = eigs
    return eigs


def sparse_eig_bank(n: int, k: int, d: int, nnz: int, trials: int | None = None,
                    seed: int = 0, device=None) -> np.ndarray:
    """Eigenvalue bank of SparseProj's S: the srht bank's machinery over the
    very-sparse maps, keyed (and cached) by the row density ``nnz`` too,
    since the spectrum of S depends on it."""
    if not 1 <= nnz <= d:
        raise ValueError(f"nnz must be in [1, d={d}], got {nnz}")
    return srht_eig_bank(n, k, d, trials, seed, device, projection=f"sparse{nnz}")


def beta_fn_from_bank(bank, n: int, d: int, eps: float = 0.0):
    """-> callable rho -> beta; rho a float32 tensor, 0-dim or (C,).

    With eps > 0 beta calibrates the ridge-filtered estimator of the fused
    CG decode, T_eps = T + eps, so unbiasedness stays exact; near-zero bank
    eigenvalues then suppress themselves and no spectral floor is used."""
    bank_t = torch.as_tensor(np.asarray(bank, dtype=np.float32))

    def one(b: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
        t = transforms.t_apply(b, rho) + eps
        if eps > 0.0:
            contrib = torch.clamp(b, min=0.0) / t
        else:
            contrib = torch.where(b > 1e-4, b / t, torch.zeros_like(b))
        c = contrib.sum(-1).mean(-1) / (n * d)
        return 1.0 / c

    def beta(rho: torch.Tensor) -> torch.Tensor:
        b = bank_t.to(rho.device)
        if rho.dim() == 0:
            return one(b, rho)
        # per-chunk rho: batched so that a batch holds at most 2**24 floats
        bs = max(1, (1 << 24) // b.numel())
        return torch.cat([one(b, r[:, None, None]) for r in torch.split(rho, bs)])

    return beta


def srht_beta(n: int, k: int, d: int, rho: float, trials: int | None = None, seed: int = 0,
              device=None) -> float:
    """Scalar beta for Rand-Proj-Spatial (SRHT) with T_rho; rho = 0 is exact."""
    if rho == 0.0:
        return d / k  # tr(S) = nk: SRHT rows are unit norm
    bank = srht_eig_bank(n, k, d, trials, seed, device)
    return float(beta_fn_from_bank(bank, n, d)(torch.tensor(rho, dtype=torch.float32)))


@functools.lru_cache(maxsize=256)
def rand_k_spatial_beta_weights(n: int, k: int, d: int) -> tuple[float, np.ndarray]:
    """(p, pmf of B ~ Bin(n-1, p)) with p = k/d, in float64."""
    from scipy.stats import binom  # imported here: scipy.stats takes seconds to import

    p = k / d
    return p, binom.pmf(np.arange(n), n - 1, p)


def rand_k_spatial_beta(n: int, k: int, d: int, rho: torch.Tensor) -> torch.Tensor:
    """Exact beta = 1 / (p E[1/T(1+B)]); rho a float32 tensor, 0-dim or (C,).
    The expectation sums its n terms in order, so the card and the CPU give
    the same bits."""
    p, pmf = rand_k_spatial_beta_weights(n, k, d)
    m = 1.0 + torch.arange(n, dtype=torch.float32, device=rho.device)
    inv_t = 1.0 / transforms.t_apply(m, rho[..., None])
    w = torch.as_tensor(pmf, dtype=torch.float32, device=rho.device)
    return 1.0 / (p * kref.client_sum((w * inv_t).movedim(-1, 0)))
