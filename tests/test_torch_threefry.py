"""The port's threefry draws (src/repro_torch/core/random.py) against
jax.random (jax 0.9.0, ``jax_threefry_partitionable=True``) on the CPU.

Bitwise: ``key``, ``split``, ``fold_in``, ``bits``, ``uniform``,
``bernoulli``, ``rademacher``, ``randint`` (spans 2, 17 and 50,280),
``permutation`` (n = 1, 16, 1024 and 2000, the last two sort rounds) and
``top_k_bits`` (with keys whose top 65 words hold a tie), over seeds below
2**31 and shapes that include ragged ones; batched keys against ``vmap``,
and draws cut into tiles against whole ones.

``normal`` is within NORMAL_ATOL: the port runs XLA's float32 erfinv
polynomial, but its ``log1p`` is torch's, not XLA's. Measured over 10**6
draws of each of two keys: at most 3 float32 ulp apart (4.77e-7 absolute),
99.0 % of them bitwise equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import random as prand

SEEDS = (0, 1, 42, 2**31 - 1)
SHAPES = ((3, 5), (1000,), (7,), (2, 3, 4))
NORMAL_ATOL = 1e-6
# keys fold_in(key(0), i) whose 1024 words hold a tie among their top 65
TIE_KEYS = (28283, 71317)


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    k, t = jax.random.key(seed), prand.key(seed)
    _eq(t, _data(k))
    _eq(prand.split(t), _data(jax.random.split(k)))
    _eq(prand.split(t, 5), _data(jax.random.split(k, 5)))
    for data in (0, 7, 2**31 - 1):
        _eq(prand.fold_in(t, data), _data(jax.random.fold_in(k, data)))
    # fold_in over a tensor of data is one fold_in each
    _eq(prand.fold_in(t, torch.arange(5)), _data(jax.vmap(
        lambda i: jax.random.fold_in(k, i))(jnp.arange(5))))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_rademacher_bitwise(seed):
    k, t = jax.random.key(seed), prand.key(seed)
    for shape in SHAPES:
        _eq(prand.bits(t, shape), np.asarray(jax.random.bits(k, shape)).astype(np.int64))
        _eq(prand.uniform(t, shape), jax.random.uniform(k, shape))
        _eq(prand.bernoulli(t, 0.15, shape), jax.random.bernoulli(k, 0.15, shape))
        _eq(prand.rademacher(t, shape), jax.random.rademacher(k, shape, jnp.float32))


@pytest.mark.parametrize("span", (2, 17, 50280))
def test_randint_bitwise(span):
    for seed in SEEDS:
        k, t = jax.random.key(seed), prand.key(seed)
        for lo in (0, 1):
            _eq(prand.randint(t, (4, 33), lo, lo + span),
                jax.random.randint(k, (4, 33), lo, lo + span))


@pytest.mark.parametrize("n", (1, 16, 1024, 2000))
def test_permutation_bitwise(n):
    for seed in SEEDS:
        k, t = jax.random.key(seed), prand.key(seed)
        want = np.asarray(jax.random.permutation(k, n))
        _eq(prand.permutation(t, n), want)
        _eq(prand.permutation(t, n, prefix=min(n, 8)), want[:8])


def test_top_k_bits_bitwise_with_ties():
    base, tbase = jax.random.key(0), prand.key(0)
    for i in TIE_KEYS + (0, 1):
        k, t = jax.random.fold_in(base, i), prand.fold_in(tbase, i)
        words = prand.bits(t, (1024,))
        top = torch.sort(words, descending=True).values[:65]
        assert (i not in TIE_KEYS) or bool((top[:-1] == top[1:]).any())
        for kk in (1, 64, 1024):
            _eq(prand.top_k_bits(t, 1024, kk),
                jax.lax.top_k(jax.random.bits(k, (1024,)), kk)[1])


def test_normal_within_tolerance():
    for seed in (3, 11):
        want = np.asarray(jax.random.normal(jax.random.key(seed), (200_000,)))
        got = prand.normal(prand.key(seed), (200_000,)).numpy()
        assert np.abs(got - want).max() <= NORMAL_ATOL
        ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        assert ulp.max() <= 3 and (got == want).mean() > 0.98


def test_batched_keys_and_tiles_bitwise(monkeypatch):
    ks, ts = jax.random.split(jax.random.key(9), 6), prand.split(prand.key(9), 6)
    want = {
        "bits": np.asarray(jax.vmap(lambda k: jax.random.bits(k, (4, 9)))(ks)).astype(np.int64),
        "uniform": jax.vmap(lambda k: jax.random.uniform(k, (4, 9)))(ks),
        "permutation": jax.vmap(lambda k: jax.random.permutation(k, 50))(ks),
        "top_k": jax.vmap(lambda k: jax.lax.top_k(jax.random.bits(k, (50,)), 5)[1])(ks),
        "randint": jax.vmap(lambda k: jax.random.randint(k, (4, 9), 0, 17))(ks),
    }

    def got():
        return {"bits": prand.bits(ts, (4, 9)), "uniform": prand.uniform(ts, (4, 9)),
                "permutation": prand.permutation(ts, 50), "top_k": prand.top_k_bits(ts, 50, 5),
                "randint": prand.randint(ts, (4, 9), 0, 17)}

    whole = got()
    monkeypatch.setattr(prand, "_CPU_TILE", 7)  # rows cut across tiles, and tiles of rows
    for name, tiled in got().items():
        _eq(whole[name], want[name])
        _eq(tiled, want[name])
    with pytest.raises(ValueError, match="need 1 <= k <= d"):
        prand.top_k_bits(ts, 50, 51)


def test_estimator_draws_follow_jax_call_sequences():
    """srht_draw, subset, sparse_draw and gauss_map are the JAX package's
    draws of a client key (core/estimators/rand_proj_spatial.py,
    rand_k.py, sparse_proj.py there)."""
    k, t = jax.random.key(5), prand.key(5)
    k1, k2 = jax.random.split(k)
    draw = prand.srht_draw(t, 64, 8)
    _eq(draw["signs"], jax.random.rademacher(k1, (64,), jnp.float32))
    _eq(draw["rows"], jax.lax.top_k(jax.random.bits(k2, (64,), jnp.uint32), 8)[1])
    _eq(prand.srht_draw(t, 64, 8, rows_by="permutation")["rows"],
        jax.random.permutation(k2, 64)[:8])
    _eq(prand.subset(t, 64, 8), jax.random.permutation(k, 64)[:8])
    sparse = prand.sparse_draw(t, 64, 8, 4)
    _eq(sparse["cols"], jax.random.randint(k2, (8, 4), 0, 64))
    _eq(sparse["signs"], jax.random.rademacher(k1, (8, 4), jnp.float32))
    g = prand.gauss_map(t, 8, 64).numpy()
    np.testing.assert_allclose(g, np.asarray(jax.random.normal(k1, (8, 64)) / jnp.sqrt(64)),
                               rtol=0, atol=NORMAL_ATOL)


def test_keys_are_checked():
    assert prand.key(3).shape == (2,) and prand.key(3).dtype == torch.int64
    assert torch.equal(prand.as_key(5, "cpu"), prand.key(5))
    key = prand.key(3)
    assert prand.as_key(key, "cpu") is key
    for bad in (torch.tensor(3), torch.zeros(3, dtype=torch.int64), key.int()):
        with pytest.raises(ValueError, match=r"shape \(\.\.\., 2\)"):
            prand.as_key(bad, "cpu")
    for seed in (-(2**31) - 1, 2**63):
        with pytest.raises(ValueError, match="seed must be in"):
            prand.key(seed)
