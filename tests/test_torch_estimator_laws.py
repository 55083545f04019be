"""The paper's laws on the port's own draws: twins of the statistical tests
of tests/test_estimators.py, at their sizes and tolerances.

Each twin runs its T trials as T chunks of the same vector in ONE call with
a draw per chunk (``shared_randomness=False``; wangni and induced always draw
per chunk): every chunk has its own key, so the chunks are independent
trials. Where the JAX test draws one map per client, the law under test
holds chunk by chunk in either mode. Pure PyTorch on the CPU, no JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import beta as tbeta
from repro_torch.core import codec, correlation
from repro_torch.kernels import ref as kref


def make_clients(kind, n, d, seed=0) -> np.ndarray:
    """tests/test_estimators.py's make_clients: unit-norm (n, d) float32."""
    rng = np.random.default_rng(seed)
    if kind == "identical":
        xs = np.tile(rng.standard_normal(d), (n, 1))
    elif kind == "orthogonal":
        q, _ = np.linalg.qr(rng.standard_normal((d, n)))
        xs = q.T * np.sqrt(d)
    else:
        xs = rng.standard_normal((n, d))
    return (xs / np.linalg.norm(xs, axis=1, keepdims=True)).astype(np.float32)


def run_trials(spec, xs: np.ndarray, trials: int, seed: int = 0):
    """(estimates (T, d) float64, squared errors (T,)) of ``trials``
    independent estimates of the mean of xs (n, d): one chunk a trial."""
    x = torch.from_numpy(xs)
    chunks = x[:, None, :].expand(x.shape[0], trials, x.shape[1]).contiguous()
    xh = codec.Pipeline([spec]).mean_estimate(seed, chunks, device="cpu")
    xbar = x.mean(0)
    mses = torch.stack([correlation.mse(row, xbar) for row in xh])
    return xh.double().numpy(), mses.double().numpy()


def _rk(**kw):
    return codec.RandK(shared_randomness=False, **kw)


def _rks(**kw):
    return codec.RandKSpatial(shared_randomness=False, **kw)


def _rps(**kw):
    return codec.RandProjSpatial(shared_randomness=False, **kw)


UNBIASED = [
    ("rand_k", _rk, {}),
    ("rand_k_spatial-avg", _rks, {"transform": "avg"}),
    ("rand_proj_spatial-avg", _rps, {"transform": "avg"}),
    ("rand_proj_spatial-max", _rps, {"transform": "max"}),
    ("wangni", codec.Wangni, {}),
    ("induced", codec.Induced, {}),
]


@pytest.mark.parametrize("make,kw", [(m, kw) for _, m, kw in UNBIASED],
                         ids=[name for name, _, _ in UNBIASED])
def test_unbiasedness(make, kw):
    """tests/test_estimators.py:64, 600 trials."""
    n, d, k = 8, 128, 8
    xs = make_clients("generic", n, d)
    xhs, _ = run_trials(make(k=k, d_block=d, **kw), xs, trials=600)
    err = np.abs(xhs.mean(0) - xs.astype(np.float64).mean(0))
    sem = xhs.std(0) / np.sqrt(xhs.shape[0]) + 1e-4
    assert (err < 6 * sem + 5e-3).all(), float(err.max())


def test_rand_k_mse_matches_eq1():
    """tests/test_estimators.py:77, 1500 trials."""
    n, d, k = 8, 128, 8
    xs = make_clients("generic", n, d)
    _, mses = run_trials(_rk(k=k, d_block=d), xs, trials=1500)
    want = (1 / n**2) * (d / k - 1) * float((xs.astype(np.float64) ** 2).sum())
    assert abs(mses.mean() - want) / want < 0.12, (mses.mean(), want)


def test_thm_4_3_full_correlation():
    """tests/test_estimators.py:88: identical vectors, T = id ("max"):
    MSE ~= (d/(nk) - 1) ||x||^2, and clearly below Rand-k's."""
    n, d, k = 8, 128, 8
    xs = make_clients("identical", n, d)
    _, mses = run_trials(_rps(k=k, d_block=d, transform="max"), xs, trials=400)
    norm_sq = float((xs[0].astype(np.float64) ** 2).sum())
    want = (d / (n * k) - 1) * norm_sq
    assert abs(mses.mean() - want) / want < 0.15, (mses.mean(), want)
    assert mses.mean() < (1 / n) * (d / k - 1) * norm_sq * 0.7


def test_thm_4_4_no_correlation():
    """tests/test_estimators.py:104: orthogonal vectors, T == 1 ("one"):
    MSE == Rand-k's Eq. 1."""
    n, d, k = 8, 128, 8
    xs = make_clients("orthogonal", n, d)
    _, mses = run_trials(_rps(k=k, d_block=d, transform="one"), xs, trials=1000)
    want = (1 / n**2) * (d / k - 1) * float((xs.astype(np.float64) ** 2).sum())
    assert abs(mses.mean() - want) / want < 0.12, (mses.mean(), want)


@pytest.mark.parametrize("seed", range(6))
def test_lemma_4_1_property_over_seeds(seed):
    """tests/test_estimators.py:132: the subsample projection matches
    Rand-k-Spatial in both draw modes, through the gram and direct decodes
    (the fused one: tests/test_torch_baselines.py)."""
    n, d, k = 5, 64, 4
    rng = np.random.default_rng(100 + seed)
    xs = torch.from_numpy(rng.standard_normal((n, 2, d)).astype(np.float32))
    for shared in (True, False):
        want = codec.Pipeline([codec.RandKSpatial(k=k, d_block=d, transform="avg",
                                                  shared_randomness=shared)])
        want = want.mean_estimate(1000 + seed, xs, device="cpu")
        for method in ("direct", "gram"):
            spec = codec.RandProjSpatial(k=k, d_block=d, transform="avg", projection="subsample",
                                         decode_method=method, shared_randomness=shared)
            got = codec.Pipeline([spec]).mean_estimate(1000 + seed, xs, device="cpu")
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-4,
                                       err_msg=f"shared={shared} method={method}")


def test_lemma_4_1_under_error_feedback():
    """tests/test_estimators.py:160: Lemma 4.1 extends through error
    feedback. The subsample projection's (d/k) G^T z self-decode IS Rand-k's
    (d/k) scatter, so the means AND the residuals coincide over 3 rounds of
    ``compressed_mean_tree(ef_chunks=)`` (direct decode, as the JAX test)."""
    from repro_torch.core import random as prand
    from repro_torch.dist import collectives

    n, d, k = 4, 64, 4
    rng = np.random.default_rng(9)
    tree = {"w": torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))}
    s_proj = codec.build("rand_proj_spatial", k=k, d_block=d, transform="avg",
                         projection="subsample", decode_method="direct", ef=True)
    s_spatial = codec.build("rand_k_spatial", k=k, d_block=d, transform="avg", ef=True)
    ef_a = ef_b = torch.zeros(n, 1, d)
    for t in range(3):
        key = prand.fold_in(prand.key(11, "cpu"), t)
        mean_a, _, ef_a = collectives.compressed_mean_tree(s_proj, key, tree, ef_chunks=ef_a,
                                                           device="cpu")
        mean_b, _, ef_b = collectives.compressed_mean_tree(s_spatial, key, tree,
                                                           ef_chunks=ef_b, device="cpu")
        np.testing.assert_allclose(mean_a["w"].numpy(), mean_b["w"].numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=f"round {t} mean")
        np.testing.assert_allclose(ef_a.numpy(), ef_b.numpy(), rtol=2e-3, atol=2e-4,
                                   err_msg=f"round {t} residual")
        assert float(ef_a.abs().sum()) > 0  # the residual carries mass


def test_varying_correlation_ordering():
    """tests/test_estimators.py:219 (Fig. 3): given R, Rand-Proj-Spatial(Opt)
    < Rand-k-Spatial(Opt) < Rand-k. The same key gives Rand-k and
    Rand-k-Spatial the same payloads, so their gap is a paired comparison."""
    n, d, k = 8, 256, 24
    assign = np.array([0, 0, 0, 0, 0, 0, 1, 1])  # R = (6*5 + 2*1)/8 = 4.0
    xs = np.eye(d, dtype=np.float32)[:2][assign]
    r = float(correlation.r_exact(torch.from_numpy(xs)[:, None, :]))
    assert r == pytest.approx(4.0)
    res = {}
    for name, spec in [("rand_k", _rk(k=k, d_block=d)),
                       ("rand_k_spatial", _rks(k=k, d_block=d, transform="opt", r_value=r)),
                       ("rand_proj_spatial", _rps(k=k, d_block=d, transform="opt", r_value=r))]:
        _, res[name] = run_trials(spec, xs, trials=600, seed=2)
    paired = res["rand_k"] - res["rand_k_spatial"]
    sem = paired.std() / np.sqrt(len(paired))
    assert paired.mean() > 1.5 * sem, (paired.mean(), sem)
    assert res["rand_proj_spatial"].mean() < res["rand_k_spatial"].mean() * 0.99


def test_same_rotation_no_gain_appendix_a1():
    """tests/test_estimators.py:243: pre-rotating every client by the SAME
    orthonormal G leaves Rand-k's MSE unchanged."""
    n, d, k = 8, 128, 8
    xs = make_clients("generic", n, d, seed=3)
    h = kref.hadamard_matrix(d) / np.sqrt(d)
    g = h * np.sign(np.random.default_rng(0).standard_normal(d))[None, :]
    xs_rot = (xs @ g.T).astype(np.float32)
    _, m_plain = run_trials(_rk(k=k, d_block=d), xs, trials=800)
    _, m_rot = run_trials(_rk(k=k, d_block=d), xs_rot, trials=800, seed=1)
    assert abs(m_plain.mean() - m_rot.mean()) / m_plain.mean() < 0.1


def test_beta_closed_forms():
    """tests/test_estimators.py:260, on the port's bank (the JAX test's
    default trials)."""
    n, k, d = 8, 8, 128
    assert tbeta.srht_beta(n, k, d, 0.0) == d / k
    assert tbeta.srht_beta(n, k, d, 1.0, device="cpu") == pytest.approx(d / k, rel=0.02)
    got = float(tbeta.rand_k_spatial_beta(n, k, d, torch.tensor(1.0)))
    assert got == pytest.approx(n / (1 - (1 - k / d) ** n), rel=1e-4)
    assert float(tbeta.rand_k_spatial_beta(n, k, d, torch.tensor(0.0))) == pytest.approx(
        d / k, rel=1e-5)


def test_rank_s_full_whp():
    """tests/test_estimators.py:275 (paper App. C.3): rank(S) == nk w.h.p."""
    n, k, d = 8, 8, 128
    bank = tbeta.srht_eig_bank(n, k, d, trials=64, seed=1, device="cpu")
    assert ((bank > 1e-4).sum(axis=1) == n * k).mean() > 0.95
