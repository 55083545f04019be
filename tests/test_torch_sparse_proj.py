"""The port's SparseProj estimator and very-sparse oracles against the JAX
package's.

The three sparse oracles (encode, scatter-add adjoint, Gram apply) and the
SRHT adjoint oracle equal JAX's bit for bit on a golden grid of small
integers (every sum exact), columns repeating within rows included; the
ops equal the oracles times their scales. With JAX's draws and eigenvalue
bank carried across (repro_torch.interop), the encode, ``self_decode`` and
decode agree within relative 1e-5, in both r_modes and both draw modes.
On the port's own draws SparseProj never loses to Rand-k at rho -> 1.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beta as jbeta
from repro.core import codec as jcodec
from repro.core.estimators import sparse_proj as jsp
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import codec as tcodec
from repro_torch.core import random as prand
from repro_torch.core.estimators import sparse_proj as tsp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

N, C, D, K, S, TRIALS = 4, 3, 64, 8, 8.0, 64
NNZ = 8
MODES = [(shared, r_mode) for shared in (True, False) for r_mode in ("fixed", "est")]
MODE_IDS = [f"{'shared' if s else 'per_chunk'}-{r}" for s, r in MODES]
# (d, k, nnz, C, draw lead) of the golden grid; nnz > d forces repeats in a row
GRID = [(8, 4, 12, 3, 1), (8, 4, 12, 3, 3), (64, 8, 8, 2, 1), (64, 8, 8, 2, 2)]


@contextlib.contextmanager
def _cheap_compiles():
    """Compile the JAX reference without XLA's costly optimisation passes
    (it runs once; they change no float semantics)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


def _specs(shared, r_mode):
    kw = dict(k=K, d_block=D, s=S, shared_randomness=shared, r_mode=r_mode,
              beta_trials=TRIALS)
    return jcodec.SparseProj(**kw), tcodec.SparseProj(**kw)


def _golden(case: int):
    """Small-integer inputs of one grid cell: v (C, d), x (n, C, d), z (n, C,
    k), signs +-1 and cols (n, lead, k, nnz)."""
    d, k, nnz, c, lead = GRID[case]
    rng = np.random.default_rng(10 + case)
    return {
        "v": rng.integers(-4, 5, (c, d)).astype(np.float32),
        "x": rng.integers(-8, 9, (3, c, d)).astype(np.float32),
        "z": rng.integers(-8, 9, (3, c, k)).astype(np.float32),
        "signs": (rng.integers(0, 2, (3, lead, k, nnz)) * 2 - 1).astype(np.float32),
        "cols": rng.integers(0, d, (3, lead, k, nnz)).astype(np.int32),
        "srht_signs": (rng.integers(0, 2, d) * 2 - 1).astype(np.float32),
        "srht_rows": rng.permutation(d)[:k].astype(np.int32),
    }


@pytest.fixture(scope="module")
def jax_side():
    """The golden grid's JAX oracles, and per (draw mode, r_mode) JAX's
    draws, payloads, self_decodes and decode, from ONE compiled program."""
    rng = np.random.default_rng(0)
    common = rng.standard_normal((C, D))
    xs = (common[None] + 0.5 * rng.standard_normal((N, C, D))).astype(np.float32)
    key = jax.random.key(11)
    grid = [_golden(i) for i in range(len(GRID))]

    def everything(x, grid):
        oracles = []
        for g in grid:
            d = g["v"].shape[-1]
            oracles.append({
                "encode": jref.sparse_encode_ref(g["x"], g["signs"], g["cols"]),
                "adjoint": jref.sparse_scatter_add_ref(g["z"], g["signs"], g["cols"], d),
                "gram": jref.sparse_gram_apply_ref(g["v"], g["signs"], g["cols"]),
                "srht_decode": jref.srht_decode_ref(g["z"], g["srht_signs"], g["srht_rows"], d),
            })
        out = {}
        for shared, r_mode in MODES:
            js, _ = _specs(shared, r_mode)
            pays = [jsp.encode(js, key, i, x[i]) for i in range(N)]
            pay = {name: jnp.stack([p[name] for p in pays]) for name in pays[0]}
            out[shared, r_mode] = {
                "draws": jsp._draws(js, key, N, C, None, 0), "payload": pay,
                "self": jnp.stack([jsp.self_decode(js, key, i, {"vals": pay["vals"][i]})
                                   for i in range(N)]),
                "decode": jsp.decode(js, key, pay, N),
            }
        return oracles, out

    with _cheap_compiles():
        bank = np.asarray(jbeta.sparse_eig_bank(N, K, D, NNZ, TRIALS))
        oracles, out = jax.tree.map(np.asarray, jax.jit(everything)(jnp.asarray(xs), grid))
    return {"xs": xs, "bank": bank, "grid": grid, "oracles": oracles, "modes": out}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", range(len(GRID)))
def test_sparse_oracles_match_jax_bitwise(jax_side, case):
    g = jax_side["grid"][case]
    want = jax_side["oracles"][case]
    d = g["v"].shape[-1]
    signs, cols = _t(g["signs"]), _t(g["cols"]).long()
    got = {
        "encode": kref.sparse_encode_ref(_t(g["x"]), signs, cols),
        "adjoint": kref.sparse_scatter_add_ref(_t(g["z"]), signs, cols, d),
        "gram": kref.sparse_gram_apply_ref(_t(g["v"]), signs, cols),
        "srht_decode": kref.srht_decode_ref(_t(g["z"]), _t(g["srht_signs"]),
                                            _t(g["srht_rows"]), d),
    }
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    if case < 2:  # nnz > d: the grid does hold within-row repeats
        assert any(len(set(row)) < len(row) for row in g["cols"].reshape(-1, g["cols"].shape[-1]))


@pytest.mark.parametrize("case", range(len(GRID)))
def test_sparse_ops_are_the_oracles_scaled(jax_side, case):
    """Each op (a client at a time, its columns indexed once with shared
    draws) equals its oracle times its scale, bit for bit on the grid."""
    g = jax_side["grid"][case]
    d = g["v"].shape[-1]
    nnz = g["cols"].shape[-1]
    signs, cols = _t(g["signs"]), _t(g["cols"])
    x, z, v = _t(g["x"]), _t(g["z"]), _t(g["v"])
    inv = 1.0 / np.sqrt(nnz)
    for i in range(x.shape[0]):
        assert torch.equal(kops.sparse_proj_encode(x[i], signs[i], cols[i]),
                           kref.sparse_encode_ref(x[i], signs[i], cols[i]) * inv)
        assert torch.equal(kops.sparse_proj_adjoint(z[i], signs[i], cols[i], d),
                           kref.sparse_scatter_add_ref(z[i], signs[i], cols[i], d) * inv)
    assert torch.equal(kops.sparse_proj_adjoint(z, signs, cols, d),
                       kref.sparse_scatter_add_ref(z, signs, cols, d) * inv)
    assert torch.equal(kops.sparse_proj_gram_apply(v, signs, cols),
                       kref.sparse_gram_apply_ref(v, signs, cols) * (1.0 / nnz))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shared,r_mode", MODES, ids=MODE_IDS)
def test_sparse_proj_matches_jax(jax_side, shared, r_mode):
    """On JAX's draws and bank: encode, self_decode and decode within 1e-5."""
    side = jax_side["modes"][shared, r_mode]
    _, ts = _specs(shared, r_mode)
    draws = interop.draws_from_numpy(side["draws"], "cpu")
    xs = torch.from_numpy(jax_side["xs"])
    pipe = tcodec.Pipeline([ts])
    pay, _ = pipe.encode_all(0, xs, draws=draws)
    assert sorted(pay.arrays) == sorted(side["payload"])
    for name, want in side["payload"].items():
        np.testing.assert_allclose(pay.arrays[name].numpy(), want, rtol=1e-5, atol=1e-6)
    one = tcodec.Payload({k: v[0] for k, v in pay.arrays.items()}, pay.meta)
    assert tcodec.check_against_schema(one) == []
    payload = {name: _t(v) for name, v in side["payload"].items()}
    for i in range(N):
        got = tsp.self_decode(ts, 0, i, {"vals": payload["vals"][i]},
                              draws={name: v[i] for name, v in draws.items()})
        assert _rel(got, side["self"][i]) <= 1e-5
    got = pipe.decode(0, tcodec.Payload(payload, pay.meta), N, draws=draws,
                      bank=interop.bank_from_numpy(jax_side["bank"]))
    assert got.shape == (C, D) and _rel(got, side["decode"]) <= 1e-5


def test_norm_inflation_matches_jax():
    for k, d, s in ((8, 64, 8.0), (64, 1024, 16.0), (4, 64, 1.0), (16, 256, 300.0)):
        want = jcodec.SparseProj(k=k, d_block=d, s=s).self_decode_norm_inflation
        got = tcodec.SparseProj(k=k, d_block=d, s=s)
        assert got.self_decode_norm_inflation == want
        assert got.nnz == jcodec.SparseProj(k=k, d_block=d, s=s).nnz
    with pytest.raises(ValueError, match="density"):
        tcodec.SparseProj(s=0.5)


def test_sparse_draws_laws_and_rederivation():
    """randint is uniform on [0, d) with repeats allowed, rademacher is +-1
    and balanced, and the encode's per-client draw equals the decode's
    stacked one, keyed by global chunk position."""
    keys = prand.fold_in(prand.key(5), torch.arange(64))
    draw = prand.sparse_draw(keys, 16, 32, 64)
    cols, signs = draw["cols"], draw["signs"]
    assert cols.shape == signs.shape == (64, 32, 64) and cols.dtype == torch.int64
    assert int(cols.min()) == 0 and int(cols.max()) == 15
    counts = torch.bincount(cols.reshape(-1), minlength=16).double()
    expect = cols.numel() / 16
    assert float(((counts - expect) ** 2 / expect).sum()) < 50.0  # chi2, 15 dof
    assert set(signs.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(signs.mean())) < 0.01
    for shared in (True, False):
        _, ts = _specs(shared, "fixed")
        stacked = tsp._draws(ts, 3, 2, 5, client_ids=[4, 1], chunk_offset=2, device="cpu")
        full = tsp._draws(ts, 3, 2, 7, client_ids=[4, 1], device="cpu")
        own = tsp._own_draw(ts, 3, 1, 7, None, torch.device("cpu"))
        for name in ("signs", "cols"):
            assert torch.equal(own[name], full[name][1])
            assert torch.equal(stacked[name], full[name] if shared else full[name][:, 2:])


def _clients(seed, n, rho):
    """(n, 1, D) unit client chunks at correlation ``rho`` (the JAX
    property suite's ``_clients``)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((1, D))
    xs = rho * base[None] + np.sqrt(max(0.0, 1 - rho**2)) * rng.standard_normal((n, 1, D))
    return (xs / np.linalg.norm(xs, axis=-1, keepdims=True)).astype(np.float32)


def test_sparse_proj_not_worse_than_rand_k_at_high_rho():
    """Twin of the JAX suite's variance ordering at rho = 0.995 (n in 4, 8;
    k in 4, 8; three seeds; 150 trials run as chunks with a draw per chunk):
    SparseProj's MSE within 1.05x of Rand-k's in every case, and its mean
    ratio below 0.9."""
    trials, ratios = 150, []
    for n in (4, 8):
        for k in (4, 8):
            for seed in range(3):
                xs = torch.from_numpy(_clients(seed, n, 0.995)).expand(n, trials, D)
                xbar = xs.mean(0)

                def mse(spec):
                    xh = tcodec.Pipeline([spec]).mean_estimate(200 + seed, xs, device="cpu")
                    return float(((xh - xbar) ** 2).sum(-1).mean())

                mse_rk = mse(tcodec.RandK(k=k, d_block=D, shared_randomness=False))
                mse_sp = mse(tcodec.SparseProj(k=k, d_block=D, s=8.0, shared_randomness=False))
                assert mse_sp <= mse_rk * 1.05, (n, k, seed, mse_sp, mse_rk)
                ratios.append(mse_sp / mse_rk)
    assert np.mean(ratios) < 0.9, ratios
