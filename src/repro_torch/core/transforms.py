"""Eigenvalue transformation functions T (paper Eq. 11 and §4.1/4.2);
port of repro/core/transforms.py.

    T(m) = 1 + rho * (m - 1),      rho = R / (n - 1)

rho = 0 is the no-correlation optimum (Thm 4.4), rho = 1 "Max" (Thm 4.3),
rho = (n/2)/(n-1) the practical "Avg", rho = R/(n-1) "Opt" for a known R.
"""
from __future__ import annotations

import torch

VARIANTS = ("one", "max", "avg", "opt")


def rho_for(transform: str, n: int, r_value=None) -> float:
    """Interpolation weight rho = R/(n-1) for a transform variant."""
    if transform == "one":
        return 0.0
    if transform == "max":
        return 1.0
    if transform == "avg":
        return (n / 2.0) / (n - 1.0)
    if transform == "opt":
        if r_value is None:
            raise ValueError("transform='opt' needs r_value (known or estimated R)")
        return r_value / (n - 1.0)
    if transform == "wavg":
        raise ValueError(
            "transform='wavg' is a round-level policy of the FL server, which "
            "resolves it into opt/avg before decode; it cannot be used directly"
        )
    raise ValueError(f"unknown transform {transform!r}; pick from {VARIANTS}")


def clip_rho(rho: torch.Tensor, n: int) -> torch.Tensor:
    """Keep T positive on its support: rho in (-1/(n-1), 1]."""
    lo = -1.0 / (n - 1.0) * 0.999
    return torch.clamp(rho, lo, 1.0)


def t_apply(m, rho):
    """T(m) = 1 + rho (m - 1), elementwise; rho broadcasts against m."""
    return 1.0 + rho * (m - 1.0)
