"""Random draws of the port: jax 0.9.0's threefry, bit for bit.

The server re-derives every client's map from the round's randomness, so
nothing but payload values crosses the wire (docs/DESIGN.md §3.6). The
generator is jax 0.9.0's threefry2x32 with
``jax_threefry_partitionable=True`` (jax/_src/prng.py, jax/_src/random.py),
on int64 tensors holding uint32 words, so every draw equals jax.random's
bit for bit on the CPU and on the card:

- a key is a (..., 2) int64 tensor, JAX's ``key_data``; ``key(seed)`` is
  ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``fold_in(key, i)`` is ``threefry2x32(key, (0, i))``, so it equals
  ``split(key, n)[i]``; ``bits(key, shape)`` hashes each flat index i of
  the shape as ``(i >> 32, i & 0xFFFFFFFF)`` and xors the two output words;
- ``uniform`` puts a word's top 23 bits under the exponent of 1.0 and
  subtracts 1; ``bernoulli`` is ``uniform < p``; ``rademacher`` is
  ``2 bernoulli(0.5) - 1``; ``randint`` is JAX's two-draw arithmetic in
  uint32; ``permutation`` is JAX's ``_shuffle``, rounds of stable sorts by
  ``bits`` keys; ``top_k_bits`` is ``lax.top_k`` over ``bits``, lower
  index first on ties;
- ``normal`` is ``sqrt(2) erfinv(u)`` over ``uniform(nextafter(-1, 0),
  1)``, with XLA's float32 erfinv polynomial written in torch ops. It is
  the one draw that is not bitwise: torch's ``log1p`` is not XLA's, and the
  gap stays within a few float32 ulp (tests/test_torch_threefry.py);
- the estimator draws follow the JAX package's call sequences
  (core/estimators/*.py there): ``srht_draw`` splits the key in two, its
  signs ``rademacher(k1, (d,))``, its rows ``top_k_bits(k2, d, k)`` (the
  eigenvalue bank's: ``permutation(k2, d)[:k]``); ``subset`` is
  ``permutation(key, d)[:k]``; ``sparse_draw`` is ``randint(k2)`` columns
  and ``rademacher(k1)`` signs; ``gauss_map`` is ``normal(k1, (k, d)) /
  sqrt(d)``.

Every word is drawn in tiles (``_TILE`` words on the card, ``_CPU_TILE`` on
the CPU), so the hash's int64 temporaries stay small however large the
draw.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# words a tile of a draw: on the card each int64 temporary <= 128 MiB; on the
# CPU 256 KiB, so that the hash's live temporaries (three a tile) stay in a
# core's L2 through its 160 passes (on one thread 13 % faster than 2**14,
# within 4 % of 2**16). The CPU tile is also torch's parallel grain, so each
# op of a draw runs on one thread: with 2**16 the port's draw-heavy test
# files took 99 s against 68 s under six pytest workers on 8 cores, their
# threads oversubscribing the cores
_TILE = 1 << 24
_CPU_TILE = 1 << 15


def threefry2x32(k0, k1, x0, x1) -> tuple:
    """Threefry-2x32, 20 rounds, of counts (x0, x1) under key (k0, k1): int64
    tensors of uint32 words that broadcast together. -> (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    # numpy's rule: torch.broadcast_shapes imports sympy (seconds a process)
    shape = np.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    a = ((x0 + ks[0]) & M32).expand(shape).contiguous()
    b = ((x1 + ks[1]) & M32).expand(shape).contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(M32)
            t = b >> (32 - r)
            b.bitwise_left_shift_(r).bitwise_and_(M32).bitwise_or_(t).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        b.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(M32)
    return a, b


def _tf_key(seed: int, device) -> torch.Tensor:
    seed = int(seed)
    if not -(1 << 31) <= seed < 1 << 63:
        raise ValueError(f"seed must be in [-2**31, 2**63), got {seed}")
    hi = seed >> 32 if seed >= 0 else 0  # a negative seed is JAX's int32 one
    return torch.tensor([hi, seed & M32], dtype=torch.int64, device=device)


def _tf_fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack((y0, y1), -1)


def _tf_block(keys: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(b, hi - lo) words of keys (b, 2) at flat indices lo..hi-1."""
    idx = torch.arange(lo, hi, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], idx >> 32, idx & M32)
    return y0.bitwise_xor_(y1)


def _tf_map(keys: torch.Tensor, shape: tuple, fn, dtype, width: int | None = None):
    """keys.shape[:-1] + shape (or + (width,)) of ``fn(words)``, computed a
    tile of at most ``_TILE`` (on the CPU ``_CPU_TILE``) words at a time.
    With ``width``, fn maps whole rows of ``shape``'s words (b, m) to (b,
    width)."""
    m = _size(shape)
    flat = keys.reshape(-1, 2)
    n = flat.shape[0]
    out = torch.empty((n, m if width is None else width), dtype=dtype, device=keys.device)
    tile = _TILE if keys.is_cuda else _CPU_TILE
    rows = max(1, tile // max(m, 1))
    cols = m if width is not None else min(m, tile)
    for r in range(0, n, rows):
        for c in range(0, max(m, 1), max(cols, 1)):
            hi = min(m, c + cols)
            words = _tf_block(flat[r:r + rows], c, hi)
            if width is None:
                out[r:r + rows, c:hi] = fn(words)
            else:
                out[r:r + rows] = fn(words)
    tail = tuple(shape) if width is None else (width,)
    return out.reshape(keys.shape[:-1] + tail)


def _unit_f32(words: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform on [0, 1): the top 23 bits under 1.0's exponent, minus 1."""
    return ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


# XLA's float32 erfinv (Giles, "Approximating the erfinv function"): degree-9
# polynomials in w = -log1p(-x^2) - 2.5 (w < 5) or sqrt(w) - 3 (w >= 5)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))  # rounds to 2.0, as in JAX
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv polynomial. XLA contracts each Horner step
    ``c + p * w`` into a fused multiply-add; the step runs in float64 here
    (p * w exact there) and rounds once to float32, as the FMA does."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, np.float32(cs).item(), np.float32(cl).item())
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_f32(words: torch.Tensor) -> torch.Tensor:
    u = torch.clamp_min(_unit_f32(words) * _NORMAL_SPAN + _NORMAL_LO, _NORMAL_LO)
    return _erfinv_f32(u) * _SQRT2_F32


def bits(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """keys.shape[:-1] + shape uint32 words (int64), ``jax.random.bits``."""
    return _tf_map(keys, shape, lambda w: w, torch.int64)


def _score_rows(words: torch.Tensor) -> torch.Tensor:
    """Distinct int64 scores of rows of words: word * m + position, so that
    sorting them ascending is the stable sort by word."""
    m = words.shape[-1]
    return words * m + torch.arange(m, device=words.device)


def top_k_bits(keys: torch.Tensor, d: int, k: int) -> torch.Tensor:
    """keys.shape[:-1] + (k,) int64: ``lax.top_k(bits(key, (d,)), k)``'s
    indices, largest word first, the lower index first among equal words."""
    if not 1 <= k <= d:
        raise ValueError(f"need 1 <= k <= d, got k={k}, d={d}")

    def rows(words):  # larger word first; among equal words the lower index
        return torch.topk(words * d + (d - 1 - torch.arange(d, device=words.device)), k,
                          dim=-1, sorted=True).indices
    return _tf_map(keys, (d,), rows, torch.int64, width=k)


def _shuffle_rounds(n: int) -> int:
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(keys: torch.Tensor, n: int, prefix: int | None = None) -> torch.Tensor:
    """keys.shape[:-1] + (n,) int64, ``jax.random.permutation(key, n)``:
    rounds of stable sorts of arange(n) by fresh ``bits``; ``prefix`` keeps
    its first entries (the last round then takes a top-k, not a sort)."""
    width = n if prefix is None else prefix
    rounds = _shuffle_rounds(n)
    x = torch.arange(n, device=keys.device).expand(keys.shape[:-1] + (n,))
    for i in range(rounds):
        pair = split(keys)
        keys, sub = pair[..., 0, :], pair[..., 1, :]
        last = i == rounds - 1
        k = width if last else n
        order = _tf_map(sub, (n,), lambda w: torch.topk(_score_rows(w), k, dim=-1,
                                                         largest=False, sorted=True).indices,
                        torch.int64, width=k)
        x = torch.gather(x, -1, order)
    return x[..., :width]


def _tf_randint(keys: torch.Tensor, shape: tuple, lo: int, hi: int) -> torch.Tensor:
    """JAX's randint in int32: two words a value, reduced mod the span in uint32."""
    if not (-(1 << 31) <= lo and hi <= (1 << 31) - 1):
        raise ValueError(f"randint's range must lie in int32, got [{lo}, {hi})")
    pair = split(keys)
    higher = bits(pair[..., 0, :], shape)
    lower = bits(pair[..., 1, :], shape)
    span = hi - lo if hi > lo else 1
    mult = (1 << 16) % span
    mult = (mult * mult) % span
    off = (((higher % span) * mult & M32) + lower % span) & M32
    return lo + off % span


def key(seed: int, device=None) -> torch.Tensor:
    """Round key (2,) from a Python integer seed."""
    return _tf_key(seed, device)


def as_key(k, device) -> torch.Tensor:
    """A Python int seed or a key tensor, as a key on ``device``."""
    if isinstance(k, torch.Tensor):
        if k.dtype != torch.int64 or k.dim() == 0 or k.shape[-1] != 2:
            raise ValueError(f"a key is an int64 tensor of shape (..., 2), got "
                             f"{k.dtype} {tuple(k.shape)}")
        return k.to(device)
    return key(k, device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """New key(s) from key(s) ``k`` and non-negative integer(s) ``data``
    below 2**32; the keys' batch shape and data broadcast."""
    return _tf_fold_in(k, data)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys of each key: batch shape + (num,), then the key."""
    return _tf_fold_in(k[..., None, :], torch.arange(num, device=k.device))


def uniform(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Batch shape + shape float32 uniforms on [0, 1)."""
    return _tf_map(keys, shape, _unit_f32, torch.float32)


def bernoulli(keys: torch.Tensor, p, shape: tuple) -> torch.Tensor:
    """Batch shape + shape bool, True with probability p (float32)."""
    return uniform(keys, shape) < p


def rademacher(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Batch shape + shape float32 +-1 with equal odds."""
    # uniform < 0.5 exactly when the word's top bit is clear
    return _tf_map(keys, shape, lambda w: torch.where(w < 1 << 31, 1.0, -1.0), torch.float32)


def randint(keys: torch.Tensor, shape: tuple, lo: int, hi: int) -> torch.Tensor:
    """Batch shape + shape int64 integers uniform on [lo, hi), with
    replacement."""
    return _tf_randint(keys, shape, lo, hi)


def normal(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Batch shape + shape float32 standard normals."""
    return _tf_map(keys, shape, _normal_f32, torch.float32)


def subset(keys: torch.Tensor, d: int, k: int) -> torch.Tensor:
    """One uniform k-subset of range(d) per key: batch shape + (k,) int64,
    distinct; with k = d a uniform order of all d, whose prefixes are
    uniform subsets. Rand-k's indices, the subsample projection's rows and
    induced's random part."""
    if not 1 <= k <= d:
        raise ValueError(f"need 1 <= k <= d, got k={k}, d={d}")
    return permutation(keys, d, prefix=k)


def srht_draw(keys: torch.Tensor, d: int, k: int, rows_by: str = "top_k") -> dict:
    """One SRHT draw per key: {"signs": batch + (d,) float32 +-1, "rows":
    batch + (k,) int64, distinct}: rows by ``top_k_bits`` (the estimator's)
    or, with ``rows_by="permutation"``, the permutation's prefix (the
    eigenvalue bank's)."""
    pair = split(keys)
    k1, k2 = pair[..., 0, :], pair[..., 1, :]
    rows = top_k_bits(k2, d, k) if rows_by == "top_k" else permutation(k2, d, prefix=k)
    return {"signs": rademacher(k1, (d,)), "rows": rows}


def sparse_draw(keys: torch.Tensor, d: int, k: int, nnz: int) -> dict:
    """One very-sparse projection map per key: {"signs": batch + (k, nnz)
    float32 +-1, "cols": batch + (k, nnz) int64 columns in [0, d), drawn
    with replacement, so they may repeat within a row}."""
    pair = split(keys)
    return {"signs": rademacher(pair[..., 0, :], (k, nnz)),
            "cols": randint(pair[..., 1, :], (k, nnz), 0, d)}


def gauss_map(keys: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """One dense Gaussian map per key: batch + (k, d) float32, entries N(0, 1/d)."""
    return normal(split(keys)[..., 0, :], (k, d)) / math.sqrt(d)
