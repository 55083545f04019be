"""Carry the JAX package's state into the port, through numpy.

The system has no model weights: its state is the per-client SRHT maps of a
round and the eigenvalue bank behind beta. The port draws its maps with its
own generator (core.random), so a comparison with the JAX package carries
the JAX draws and bank across, as numpy arrays:

- ``draws_from_numpy`` takes the ``_fused_draws`` layout of
  repro.core.estimators.rand_proj_spatial: signs (n, 1|C, d) and rows
  (n, 1|C, k), int32 rows becoming int64;
- ``bank_from_numpy`` takes the (trials, nk) bank of repro.core.beta;
- ``tree_from_numpy`` takes a tree (dicts, lists, tuples) of arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def draws_from_numpy(draws: dict, device=None) -> dict:
    """{"signs", "rows"} arrays -> float32 signs and int64 rows on ``device``."""
    dev = resolve_device(device)
    signs = np.array(draws["signs"], dtype=np.float32)
    rows = np.array(draws["rows"], dtype=np.int64)
    if signs.ndim != 3 or rows.ndim != 3 or signs.shape[:2] != rows.shape[:2]:
        raise ValueError(
            f"draws must be (n, 1|C, d) signs and (n, 1|C, k) rows, got "
            f"{signs.shape} and {rows.shape}"
        )
    return {"signs": torch.from_numpy(signs).to(dev), "rows": torch.from_numpy(rows).to(dev)}


def bank_from_numpy(eigs) -> torch.Tensor:
    """(trials, nk) eigenvalue bank -> float32 CPU tensor (beta moves it)."""
    eigs = np.array(eigs, dtype=np.float32)
    if eigs.ndim != 2:
        raise ValueError(f"an eigenvalue bank is (trials, nk), got {eigs.shape}")
    return torch.from_numpy(eigs)


def tree_from_numpy(tree, device=None):
    """A tree of arrays -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, dev) for v in tree)
    return torch.from_numpy(np.array(tree)).to(dev)
