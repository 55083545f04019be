"""Counter-based random draws of the port.

The server re-derives every client's SRHT map from the round's randomness,
so nothing but payload values crosses the wire (docs/DESIGN.md §3.6). The
JAX package derives it with threefry ``fold_in`` / ``split`` and draws with
``rademacher`` and ``top_k(bits)`` (core/estimators/base.py,
rand_proj_spatial.py::_client_draw). This module keeps the same structure
with its own generator, not bitwise equal to threefry:

- a key is an int64 tensor holding a 31-bit word;
- ``fold_in(key, data)`` hashes a key with a non-negative integer (a client
  id, a chunk id, a coordinate) into a new key;
- every hash step works on 31-bit words, so every intermediate product stays
  below 2**62 and nothing relies on signed overflow. The bits are therefore
  the same on the CPU and on the card, and the kernel path on the card sees
  the maps that the plain path on the CPU sees.

Draws have the laws of the JAX package's: signs are Rademacher, and rows are
a uniform k-subset of distinct coordinates, the top-k of per-coordinate hash
scores (each score times d plus the coordinate, so no two tie and the
selection is the same on every device).
"""
from __future__ import annotations

import torch

M31 = 0x7FFFFFFF
_MUL_MIX = 0x45D9F3B      # < 2**27: a 31-bit word times it stays below 2**58
_MUL_FOLD = 0x01000193    # < 2**25: a 31-bit word times it stays below 2**56
_SIGNS, _ROWS = 0, 1      # sub-streams of a draw key


def _mix(h: torch.Tensor) -> torch.Tensor:
    """Bijective avalanche of 31-bit words held in int64."""
    h = ((h >> 16) ^ h) * _MUL_MIX & M31
    h = ((h >> 16) ^ h) * _MUL_MIX & M31
    return (h >> 16) ^ h


def key(seed: int, device=None) -> torch.Tensor:
    """Round key (0-dim int64 tensor) from a Python integer seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    lo = torch.tensor(seed & M31, dtype=torch.int64, device=device)
    return fold_in(_mix(lo), (seed >> 31) & M31)


def as_key(k, device) -> torch.Tensor:
    """A Python int seed or a key tensor, as a key on ``device``."""
    if isinstance(k, torch.Tensor):
        if k.dtype != torch.int64:
            raise ValueError(f"a key tensor must be int64, got {k.dtype}")
        return k.to(device)
    return key(k, device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """New key(s) from key(s) ``k`` and non-negative integer(s) ``data``
    below 2**31; k and data broadcast."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device)
    return _mix((k * _MUL_FOLD + data) & M31)


def srht_draw(keys: torch.Tensor, d: int, k: int) -> dict:
    """One SRHT draw per key: {"signs": keys.shape + (d,) float32 +-1,
    "rows": keys.shape + (k,) int64, distinct, in descending score order}."""
    if not 1 <= k <= d:
        raise ValueError(f"need 1 <= k <= d, got k={k}, d={d}")
    j = torch.arange(d, dtype=torch.int64, device=keys.device)
    sbits = fold_in(fold_in(keys, _SIGNS)[..., None], j)
    signs = (1 - 2 * ((sbits >> 15) & 1)).to(torch.float32)
    del sbits
    score = fold_in(fold_in(keys, _ROWS)[..., None], j) * d + j
    rows = torch.topk(score, k, dim=-1, sorted=True).indices
    return {"signs": signs, "rows": rows}
