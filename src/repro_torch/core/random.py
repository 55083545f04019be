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

Draws have the laws of the JAX package's. Each comes from its own stream of
a key, a 31-bit word hashed per element with ``fold_in``:

- ``subset``: a uniform k-subset of distinct coordinates, the top-k of
  ``fold_in(key, j) * d + j`` over the coordinates j, from the key itself
  (no stream fold; the score's ``+ j`` breaks ties, so the selection is the
  same on every device), in descending score order. With k = d it is a
  uniform order of all d coordinates, and its prefixes are uniform subsets.
  Rand-k's indices, the subsample projection's rows and induced's random
  part are this draw;
- ``srht_draw``: the SRHT map. Its signs are Rademacher, bit 15 of stream 0
  (``fold_in(fold_in(key, 0), j)``); its rows are ``subset`` of stream 1
  (``fold_in(key, 1)``);
- ``normal``: standard normals by Box-Muller from streams 2 and 3;
- ``uniform``: uniforms on [0, 1) from stream 4 (wangni's Bernoulli draws;
  the int8 quantizers' rounding dither, from ``fold_in(qkey, salt)``);
- ``randint``: integers uniform on [0, hi), drawn with replacement, from
  stream 5: ``(word * hi) >> 31`` of each 31-bit word, exactly uniform
  when hi is a power of two (within hi / 2**31 otherwise);
- ``rademacher``: float32 +-1, bit 15 of each word of stream 6;
- ``sparse_draw``: the very-sparse projection's map, its columns
  ``randint`` and its signs ``rademacher`` of the key, (k, nnz) each.

A uniform takes the top 24 bits of its 31-bit word, times 2**-24: exact in
float32 and strictly below 1, so ``uniform < p`` holds whenever p = 1.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M31 = 0x7FFFFFFF
_MUL_MIX = 0x45D9F3B      # < 2**27: a 31-bit word times it stays below 2**58
_MUL_FOLD = 0x01000193    # < 2**25: a 31-bit word times it stays below 2**56
_SIGNS, _ROWS, _NORMAL_R, _NORMAL_THETA, _UNIFORM, _RANDINT, _RADEMACHER = range(7)  # streams


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


def _words(keys: torch.Tensor, m: int) -> torch.Tensor:
    """keys.shape + (m,) words: element j is ``fold_in(key, j)``."""
    return fold_in(keys[..., None], torch.arange(m, dtype=torch.int64, device=keys.device))


def subset(keys: torch.Tensor, d: int, k: int) -> torch.Tensor:
    """One uniform k-subset of range(d) per key: keys.shape + (k,) int64,
    distinct, in descending score order."""
    if not 1 <= k <= d:
        raise ValueError(f"need 1 <= k <= d, got k={k}, d={d}")
    score = _words(keys, d) * d + torch.arange(d, dtype=torch.int64, device=keys.device)
    return torch.topk(score, k, dim=-1, sorted=True).indices


def srht_draw(keys: torch.Tensor, d: int, k: int) -> dict:
    """One SRHT draw per key: {"signs": keys.shape + (d,) float32 +-1,
    "rows": keys.shape + (k,) int64, distinct, in descending score order}."""
    rows = subset(fold_in(keys, _ROWS), d, k)
    sbits = _words(fold_in(keys, _SIGNS), d)
    signs = (1 - 2 * ((sbits >> 15) & 1)).to(torch.float32)
    return {"signs": signs, "rows": rows}


def _unit(words: torch.Tensor) -> torch.Tensor:
    """31-bit words -> float64 uniforms on [0, 1), multiples of 2**-24."""
    return (words >> 7).to(torch.float64) * 2.0**-24


def uniform(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """keys.shape + shape float32 uniforms on [0, 1), from stream 4."""
    m = int(np.prod(shape, dtype=np.int64))
    u = _unit(_words(fold_in(keys, _UNIFORM), m))
    return u.to(torch.float32).reshape(keys.shape + tuple(shape))


def randint(keys: torch.Tensor, shape: tuple, hi: int) -> torch.Tensor:
    """keys.shape + shape int64 integers uniform on [0, hi), with
    replacement, from stream 5; 1 <= hi <= 2**31."""
    if not 1 <= hi <= 1 << 31:
        raise ValueError(f"need 1 <= hi <= 2**31, got {hi}")
    m = int(np.prod(shape, dtype=np.int64))
    words = _words(fold_in(keys, _RANDINT), m)
    return ((words * hi) >> 31).reshape(keys.shape + tuple(shape))


def rademacher(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """keys.shape + shape float32 +-1 with equal odds, bit 15 of stream 6."""
    m = int(np.prod(shape, dtype=np.int64))
    bits = (_words(fold_in(keys, _RADEMACHER), m) >> 15) & 1
    return (1 - 2 * bits).to(torch.float32).reshape(keys.shape + tuple(shape))


def sparse_draw(keys: torch.Tensor, d: int, k: int, nnz: int) -> dict:
    """One very-sparse projection map per key: {"signs": keys.shape + (k,
    nnz) float32 +-1, "cols": keys.shape + (k, nnz) int64 columns in
    [0, d), drawn with replacement, so they may repeat within a row}."""
    return {"signs": rademacher(keys, (k, nnz)), "cols": randint(keys, (k, nnz), d)}


def normal(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """keys.shape + shape float32 standard normals: Box-Muller
    sqrt(-2 ln u1) cos(2 pi u2) in float64, u1 = 1 - uniform of stream 2
    (in (0, 1]), u2 a uniform of stream 3."""
    m = int(np.prod(shape, dtype=np.int64))
    radius = torch.sqrt(-2.0 * torch.log1p(-_unit(_words(fold_in(keys, _NORMAL_R), m))))
    theta = (2.0 * math.pi) * _unit(_words(fold_in(keys, _NORMAL_THETA), m))
    return (radius * torch.cos(theta)).to(torch.float32).reshape(keys.shape + tuple(shape))
