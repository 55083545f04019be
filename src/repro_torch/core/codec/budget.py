"""Budget auto-picker: the Johnson-Lindenstrauss bound as a k-from-(n, eps)
rule (Konecny & Richtarik's budget-selection problem, sklearn's
``johnson_lindenstrauss_min_dim`` closed form); port of
repro/core/codec/budget.py, host arithmetic.

A random projection to k dimensions preserves pairwise distances among n
points to within a (1 ± eps) factor w.h.p. once

    k >= 4 ln(n) / (eps^2 / 2 - eps^3 / 3)

so for distributed mean estimation over ``n_clients`` vectors, requesting
distortion ``eps`` pins the per-chunk budget (``fl.run --budget auto`` in
the JAX package).
``adaptive_chunk_budgets`` is the other budget rule in this module: given a
fixed TOTAL budget ``C * k``, reallocate it across the C chunks proportional
to per-chunk norm mass (largest-remainder rounding, every chunk in
[1, d_block]), the per-chunk budgets ``RandK(chunk_budgets=...)`` takes.
Conservation ``sum(k_c) == C * k`` makes it a pure reallocation: wire bytes
are unchanged, only where they are spent moves.
"""
from __future__ import annotations

import math

import numpy as np


class BudgetExceedsDimension(ValueError):
    """The JL bound asks for more coordinates than the chunk has — the
    requested distortion is unattainable by projecting down; loosen ``eps``,
    shrink the cohort, or send the chunk uncompressed."""


def jl_min_k(n_clients: int, eps: float) -> int:
    """Closed-form JL lower bound on the projection dimension (no clamping)."""
    if not 0.0 < eps < 1.0:
        raise ValueError(f"eps must be in (0, 1), got {eps}")
    if n_clients < 2:
        raise ValueError(f"need n_clients >= 2 for a pairwise bound, got {n_clients}")
    denom = eps**2 / 2.0 - eps**3 / 3.0
    return int(math.ceil(4.0 * math.log(n_clients) / denom))


def suggest_budget(n_clients: int, eps: float, d: int) -> int:
    """Per-chunk budget k for ``n_clients`` vectors at JL distortion ``eps``.

    Monotone: non-decreasing in ``n_clients``, non-increasing in ``eps``.
    Raises :class:`BudgetExceedsDimension` when the bound exceeds ``d`` —
    silently clamping to d would report a distortion guarantee the budget
    cannot deliver.
    """
    if d < 1:
        raise ValueError(f"d must be >= 1, got {d}")
    k = jl_min_k(n_clients, eps)
    if k > d:
        prefix = (
            f"JL bound needs k={k} coordinates for n_clients={n_clients} at "
            f"eps={eps}, but the chunk only has d={d}; "
        )
        feasible = _min_feasible_eps(n_clients, d)
        if feasible is None:
            # even eps -> 1 does not fit: no amount of loosening helps, so do
            # not hint a fake threshold (the old message said ">= 0.999
            # suffices", which was false)
            raise BudgetExceedsDimension(
                prefix + "no eps in (0, 1) fits this (n_clients, d) — shrink "
                "the cohort or send uncompressed"
            )
        raise BudgetExceedsDimension(
            prefix + f"loosen eps (>= {feasible:.3f} suffices) or send "
            "uncompressed"
        )
    return k


def _min_feasible_eps(n_clients: int, d: int, tol: float = 1e-3) -> float | None:
    """Smallest eps (to ``tol``) whose JL bound fits in d — for the error
    message's actionable hint; bisection on the monotone bound. Returns None
    when NO eps in (0, 1) fits (``jl_min_k(n, 1 - tol) > d``) so the caller
    does not hint an eps that cannot work."""
    lo, hi = tol, 1.0 - tol
    if jl_min_k(n_clients, hi) > d:
        return None
    while hi - lo > tol:
        mid = (lo + hi) / 2.0
        if jl_min_k(n_clients, mid) > d:
            lo = mid
        else:
            hi = mid
    return hi


def adaptive_chunk_budgets(norm_mass, k: int, d_block: int) -> tuple:
    """Per-chunk budgets ``(k_0, ..., k_{C-1})`` proportional to norm mass.

    Splits the fixed total ``C * k`` across chunks with quota
    ``total * mass_c / sum(mass)``, rounded by largest remainder so the
    total is conserved EXACTLY, with every chunk clamped into
    ``[1, d_block]`` (a chunk never goes dark, never exceeds its dimension).
    Zero/degenerate mass falls back to the uniform allocation. Deterministic
    pure-host arithmetic: both sides of the wire derive the identical tuple
    from the shared previous-round mean.
    """
    mass = np.asarray(norm_mass, dtype=np.float64).ravel()
    c = int(mass.size)
    if c == 0:
        raise ValueError("need at least one chunk to allocate budgets over")
    if not 1 <= k <= d_block:
        raise ValueError(f"need 1 <= k <= d_block, got k={k}, d_block={d_block}")
    total = c * k
    if not np.all(np.isfinite(mass)) or np.any(mass < 0) or mass.sum() <= 0:
        return (k,) * c
    quota = np.clip(total * mass / mass.sum(), 1.0, float(d_block))
    base = np.clip(np.floor(quota).astype(np.int64), 1, d_block)
    rem = total - int(base.sum())
    frac = quota - np.floor(quota)
    if rem > 0:
        for j in np.argsort(-frac, kind="stable").tolist() * total:
            if rem == 0:
                break
            if base[j] < d_block:
                base[j] += 1
                rem -= 1
    elif rem < 0:
        for j in np.argsort(frac, kind="stable").tolist() * total:
            if rem == 0:
                break
            if base[j] > 1:
                base[j] -= 1
                rem += 1
    return tuple(int(b) for b in base)
