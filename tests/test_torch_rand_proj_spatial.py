"""The port's Rand-Proj-Spatial estimator against the JAX package's.

With the JAX draws and eigenvalue bank carried across (repro_torch.interop),
the two packages compute the same estimator: the encode agrees to rtol 1e-6,
the fused decode to relative L2 <= 1e-4 (CG stops at a 1e-4 residual, so a
rounding flip of one iteration must pass), the gram and direct decodes of
the srht and gauss projections to relative L2 <= 1e-4 (two LAPACK
eigendecompositions), ``self_decode`` and beta to rtol 1e-6. With the port's
own draws and bank the estimator is unbiased.
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
from repro.core.estimators import rand_proj_spatial as jrps
from repro_torch import interop
from repro_torch.core import beta as tbeta
from repro_torch.core import codec as tcodec
from repro_torch.core import random as prand
from repro_torch.core.estimators import rand_proj_spatial as trps
from repro_torch.kernels import ref as kref

N, C, D, K, TRIALS = 4, 3, 64, 8, 64
BETA_EPS = (0.0, 1e-2)
BETA_RHOS = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0], np.float32)


def _specs(shared, transform="avg", r_mode="fixed", **more):
    kw = dict(k=K, d_block=D, shared_randomness=shared, transform=transform, r_mode=r_mode,
              r_value=2.0 if transform == "opt" else None, beta_trials=TRIALS, **more)
    return jcodec.RandProjSpatial(use_pallas="never", **kw), tcodec.RandProjSpatial(**kw)


def _rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


# Every transform and both r_modes against JAX with one draw per client; with
# a draw per chunk, one transform per r_mode (each JAX decode is a CG loop to
# compile). test_per_chunk_draws_decode_as_shared covers the other transforms
# on the per-chunk route.
DECODE_CASES = [(True, "one", "fixed"), (True, "max", "fixed"), (True, "avg", "fixed"),
                (True, "opt", "fixed"), (True, "avg", "est"),
                (False, "avg", "fixed"), (False, "avg", "est")]
# the gram and direct routes: every projection with a bank, draw mode and r_mode
ROUTE_CASES = [(method, proj, shared, r_mode) for method in ("gram", "direct")
               for proj in ("srht", "gauss") for shared in (True, False)
               for r_mode in ("fixed", "est")]


def _route_id(method, proj, shared, r_mode) -> str:
    return f"{method}-{proj}-{'shared' if shared else 'per_chunk'}-{r_mode}"


@contextlib.contextmanager
def _cheap_compiles():
    """Compile the JAX reference without XLA's costly optimisation passes.
    It runs once, so they cost more than they save, and they change no
    float semantics (no fast math either way)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


@pytest.fixture(scope="module")
def jax_side():
    """Correlated client chunks, the JAX bank and beta, and per randomness
    mode the JAX draws, payloads (fixed and est modes) and fused decodes of
    every case. The JAX side runs as ONE compiled program: compiling it once
    is far cheaper than compiling each call on its own."""
    rng = np.random.default_rng(0)
    common = rng.standard_normal((C, D))
    xs = (common[None] + 0.5 * rng.standard_normal((N, C, D))).astype(np.float32)
    key = jax.random.key(3)

    def everything(x):
        out = {}
        for shared in (True, False):
            for r_mode in ("fixed", "est"):
                js, _ = _specs(shared, r_mode=r_mode)
                out[shared, r_mode] = jcodec.Pipeline([js]).encode_all(key, x)[0].arrays
            out[shared, "draws"] = jrps._fused_draws(_specs(shared)[0], key, N, C, None, 0)
        for shared, transform, r_mode in DECODE_CASES:
            js, _ = _specs(shared, transform, r_mode)
            out[shared, transform, r_mode] = jrps._decode_fused(
                js, key, out[shared, r_mode], N, None, 0)
        betas = {eps: jax.vmap(jbeta.beta_fn_from_bank(bank, N, D, eps=eps))(BETA_RHOS)
                 for eps in BETA_EPS}
        rks = jax.vmap(lambda r: jbeta.rand_k_spatial_beta(N, K, D, r))(BETA_RHOS)
        row_dot = jnp.sum(x * x, axis=-1, keepdims=True)  # as the CG's dot products
        return out, betas, rks, row_dot, routes(x)

    def routes(x):
        """Per projection and draw mode: draws, payloads (both r_modes),
        self_decodes; per case the gram or direct decode; one R-hat."""
        got = {}
        for proj in ("srht", "gauss"):
            for shared in (True, False):
                js = _specs(shared, r_mode="est", projection=proj)[0]
                pay = jcodec.Pipeline([js]).encode_all(key, x)[0].arrays
                got[f"{proj}/{shared}"] = {
                    "draws": jrps._fused_draws(js, key, N, C, None, 0), "payload": pay,
                    "self": jnp.stack([jrps.self_decode(js, key, i, {"vals": pay["vals"][i]})
                                       for i in range(N)])}
        for method, proj, shared, r_mode in ROUTE_CASES:
            js = _specs(shared, r_mode=r_mode, projection=proj, decode_method=method)[0]
            pay = got[f"{proj}/{shared}"]["payload"]
            if r_mode == "fixed":
                pay = {"vals": pay["vals"]}
            got[_route_id(method, proj, shared, r_mode)] = jrps.decode(js, key, pay, N)
        js = _specs(True, r_mode="est")[0]
        a = jrps._stack_a(js, key, N)
        pay = got["srht/True"]["payload"]
        z = jnp.moveaxis(pay["vals"], 0, 1)
        got["rho_hat"] = {"gram": a @ a.T, "z": z,
                          "rho": jrps._rho_hat(js, N, z, a @ a.T, pay["norm_sq"])}
        return got

    with _cheap_compiles():
        bank = np.asarray(jbeta.srht_eig_bank(N, K, D, TRIALS))
        gauss_bank = np.asarray(jbeta.srht_eig_bank(N, K, D, TRIALS, projection="gauss"))
        out, betas, rks, row_dot, routes = jax.tree.map(
            np.asarray, jax.jit(everything)(jnp.asarray(xs)))
    out.update(xs=xs, bank=bank, beta=betas, rand_k_spatial_beta=rks, row_dot=row_dot,
               routes=routes, banks={"srht": bank, "gauss": gauss_bank})
    return out


@pytest.mark.parametrize("r_mode", ["fixed", "est"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_chunk"])
def test_encode_matches_jax(jax_side, shared, r_mode):
    _, ts = _specs(shared, r_mode=r_mode)
    draws = interop.draws_from_numpy(jax_side[shared, "draws"], "cpu")
    pay, _ = tcodec.Pipeline([ts]).encode_all(0, torch.from_numpy(jax_side["xs"]), draws=draws)
    want = jax_side[shared, r_mode]
    assert sorted(pay.arrays) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_allclose(pay.arrays[name].numpy(), arr, rtol=1e-6, atol=1e-6)
    assert tcodec.check_against_schema(
        tcodec.Payload({k: v[0] for k, v in pay.arrays.items()}, pay.meta)) == []


def _port_decode(jax_side, shared, transform, r_mode, draws=None):
    _, ts = _specs(shared, transform, r_mode)
    return trps._decode_fused(
        ts, 0, {k: torch.tensor(v) for k, v in jax_side[shared, r_mode].items()}, N,
        draws=draws or interop.draws_from_numpy(jax_side[shared, "draws"], "cpu"),
        bank=interop.bank_from_numpy(jax_side["bank"]),
    )


@pytest.mark.parametrize("shared,transform,r_mode", DECODE_CASES,
                         ids=[f"{'shared' if s else 'per_chunk'}-{t}-{r}"
                              for s, t, r in DECODE_CASES])
def test_decode_fused_matches_jax(jax_side, shared, transform, r_mode):
    got = _port_decode(jax_side, shared, transform, r_mode)
    assert got.shape == (C, D)
    assert _rel_l2(got, jax_side[shared, transform, r_mode]) <= 1e-4


@pytest.mark.parametrize("transform", ["one", "max", "opt"])
def test_per_chunk_draws_decode_as_shared(jax_side, transform):
    """The per-chunk route (signs, rows and mask of shape (n, C, w)) given
    the JAX shared draws repeated over every chunk decodes the same bits as
    the shared route (n, 1, w), which matches JAX above."""
    shared = interop.draws_from_numpy(jax_side[True, "draws"], "cpu")
    repeated = {k: v.expand(N, C, v.shape[-1]).contiguous() for k, v in shared.items()}
    want = _port_decode(jax_side, True, transform, "fixed", draws=shared)
    got = _port_decode(jax_side, True, transform, "fixed", draws=repeated)
    assert torch.equal(got, want)


@pytest.mark.parametrize("eps", BETA_EPS)
def test_beta_matches_jax(jax_side, eps):
    tfn = tbeta.beta_fn_from_bank(interop.bank_from_numpy(jax_side["bank"]), N, D, eps=eps)
    want = jax_side["beta"][eps]
    np.testing.assert_allclose(tfn(torch.from_numpy(BETA_RHOS)).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(float(tfn(torch.tensor(BETA_RHOS[2]))), want[2], rtol=1e-6)
    np.testing.assert_allclose(
        tbeta.rand_k_spatial_beta(N, K, D, torch.from_numpy(BETA_RHOS)).numpy(),
        jax_side["rand_k_spatial_beta"], rtol=1e-6)


def test_draws_are_distinct_rademacher_and_rederivable():
    """The port's own draws: Rademacher signs, distinct in-range rows, the
    same bits on every call, and the encode's per-client derivation equals
    the decode's stacked one."""
    for shared in (True, False):
        _, ts = _specs(shared)
        draws = trps._fused_draws(ts, 7, N, C, device="cpu")
        again = trps._fused_draws(ts, 7, N, C, device="cpu")
        assert torch.equal(draws["signs"], again["signs"])
        assert torch.equal(draws["rows"], again["rows"])
        assert set(draws["signs"].unique().tolist()) == {-1.0, 1.0}
        rows = draws["rows"]
        assert int(rows.min()) >= 0 and int(rows.max()) < D
        assert (rows.sort(-1).values.diff(dim=-1) > 0).all()
        x = torch.randn(C, D)
        own = trps.encode(ts, 7, 2, x)
        injected = trps.encode(ts, 7, 2, x, draws={k: v[2] for k, v in draws.items()})
        assert torch.equal(own["vals"], injected["vals"])
    # chunk draws are keyed by global position: an offset slice re-derives them
    _, ts = _specs(False)
    full = trps._fused_draws(ts, 7, N, C, device="cpu")
    part = trps._fused_draws(ts, 7, N, 2, chunk_offset=1, device="cpu")
    assert torch.equal(full["rows"][:, 1:], part["rows"])
    # the law of a single sign: about half of many draws are +1
    keys = prand.fold_in(prand.key(11), torch.arange(4096))
    frac = float((prand.srht_draw(keys, 8, 2)["signs"] > 0).float().mean())
    assert abs(frac - 0.5) < 0.01


def test_cg_host_check_interval_changes_no_bits(monkeypatch):
    """Checking "all chunks done" every iteration or every 8 gives the same
    bits (converged chunks are frozen), and zero chunks decode to exactly 0."""
    _, ts = _specs(False, transform="max")
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.standard_normal((N, C, K)).astype(np.float32))
    vals[:, 1] = 0.0
    payloads = {"vals": vals}
    every8 = trps._decode_fused(ts, 5, payloads, N)
    monkeypatch.setattr(trps, "_CHECK_EVERY", 1)
    every1 = trps._decode_fused(ts, 5, payloads, N)
    assert torch.equal(every8, every1)
    assert torch.equal(every8[1], torch.zeros(D))
    assert torch.isfinite(every8).all()


def test_row_dot_matches_jax_sum(jax_side):
    """The CG's fixed-order row dot product against jnp.sum's (whose order is
    XLA's): equal to float rounding."""
    xs = torch.from_numpy(jax_side["xs"])
    got = kref.row_dot_ref(xs, xs)
    assert got.shape == (N, C, 1)
    np.testing.assert_allclose(got.numpy(), jax_side["row_dot"], rtol=1e-6)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_chunk"])
def test_cg_step_ref_looped_is_the_solve(shared):
    """``srht_cg_step_ref`` run for every one of cg_iters iterations, with no
    host check, gives the solve's bits (chunks done early stay frozen), with
    one rho for every chunk or one per chunk; a zero chunk stays exactly 0."""
    rng = np.random.default_rng(6)
    _, ts = _specs(shared)
    draws = trps._fused_draws(ts, 3, N, C, device="cpu")
    signs, rows = draws["signs"], draws["rows"]
    y = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32))
    y[1] = 0.0
    rho = torch.tensor(0.6) if shared else torch.tensor([0.3, 0.6, 0.9])
    got, it = trps._cg_resolvent_solve(y, rho, 0.01, signs, rows, ts.cg_iters)
    ys = kref.row_dot_ref(y, y)
    state = (torch.zeros_like(y), y, y, ys, ys <= 1e-8 * ys)
    mask = kref.srht_scatter_ref(torch.ones(rows.shape), rows, D)
    for _ in range(ts.cg_iters):
        state = kref.srht_cg_step_ref(*state, 1.0 - rho + 0.01, rho, 1e-8 * ys, signs, mask)
    assert torch.equal(got, state[0])
    assert bool(state[4].all()) and 0 < int(it) < ts.cg_iters
    assert torch.equal(got[1], torch.zeros(D))


def test_unbiased_with_own_draws_and_bank():
    """Mean over 64 seeds of the port's own estimate is within 4 sigma of
    the true mean, coordinate by coordinate (d = 32)."""
    n, c, d, k, seeds = 4, 2, 32, 8, 64
    rng = np.random.default_rng(1)
    common = rng.standard_normal((c, d))
    xs = torch.from_numpy((common[None] + 0.3 * rng.standard_normal((n, c, d))).astype(np.float32))
    pipe = tcodec.Pipeline([tcodec.RandProjSpatial(k=k, d_block=d, transform="avg")])
    est = torch.stack([pipe.mean_estimate(s, xs, device="cpu") for s in range(seeds)]).double()
    err = est.mean(0) - xs.double().mean(0)
    sigma = est.std(0) / np.sqrt(seeds)
    assert (err.abs() <= 4 * sigma).all(), float((err.abs() / sigma).max())


@pytest.mark.parametrize("method,proj,shared,r_mode", ROUTE_CASES,
                         ids=[_route_id(*case) for case in ROUTE_CASES])
def test_gram_and_direct_decodes_match_jax(jax_side, method, proj, shared, r_mode):
    """The eigendecomposition routes on JAX's draws, payloads and bank."""
    routes = jax_side["routes"]
    _, ts = _specs(shared, r_mode=r_mode, projection=proj, decode_method=method)
    pay = routes[f"{proj}/{shared}"]["payload"]
    pay = {k: torch.from_numpy(v) for k, v in pay.items() if r_mode == "est" or k == "vals"}
    got = trps.decode(ts, 0, pay, N,
                      draws=interop.draws_from_numpy(routes[f"{proj}/{shared}"]["draws"], "cpu"),
                      bank=interop.bank_from_numpy(jax_side["banks"][proj]))
    assert got.shape == (C, D)
    assert _rel_l2(got, routes[_route_id(method, proj, shared, r_mode)]) <= 1e-4


@pytest.mark.parametrize("proj", ["srht", "gauss"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_chunk"])
def test_self_decode_matches_jax(jax_side, proj, shared):
    j = jax_side["routes"][f"{proj}/{shared}"]
    _, ts = _specs(shared, projection=proj)
    draws = interop.draws_from_numpy(j["draws"], "cpu")
    for i in range(N):
        got = tcodec.Pipeline([ts]).self_decode(
            0, i, {"vals": torch.from_numpy(j["payload"]["vals"][i])},
            draws={k: v[i] for k, v in draws.items()})
        np.testing.assert_allclose(got.numpy(), j["self"][i], rtol=1e-6,
                                   atol=1e-6 * np.abs(j["self"][i]).max())


def test_rho_hat_matches_jax(jax_side):
    j = jax_side["routes"]["rho_hat"]
    _, ts = _specs(True, r_mode="est")
    norm_sq = torch.from_numpy(jax_side["routes"]["srht/True"]["payload"]["norm_sq"])
    got = trps._rho_hat(ts, N, torch.from_numpy(j["z"]), torch.from_numpy(j["gram"])[None],
                        norm_sq)
    np.testing.assert_allclose(got.numpy(), j["rho"], rtol=1e-5)


def test_fused_gauss_raises():
    """As in the JAX package: gauss maps have no FWHT structure."""
    spec = tcodec.RandProjSpatial(k=K, d_block=D, projection="gauss", decode_method="fused")
    with pytest.raises(ValueError, match="fused"):
        tcodec.Pipeline([spec]).mean_estimate(0, torch.randn(N, C, D), device="cpu")
