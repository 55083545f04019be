"""Cross-client correlation measure R (paper Eq. 7) and the squared error;
port of repro/core/correlation.py."""
from __future__ import annotations

import torch


def r_exact(xs: torch.Tensor) -> torch.Tensor:
    """R = sum_{i != l} <x_i, x_l> / sum_i ||x_i||^2 for xs (n, ..., d).

    Chunk axes are flattened into the inner product (R of the full vectors)."""
    n = xs.shape[0]
    flat = xs.reshape(n, -1).float()
    total = flat.sum(0)
    sq = (flat * flat).sum()
    return (torch.dot(total, total) - sq) / (sq + 1e-12)


def mse(x_hat: torch.Tensor, x_bar: torch.Tensor) -> torch.Tensor:
    return ((x_hat.float() - x_bar.float()) ** 2).sum()
