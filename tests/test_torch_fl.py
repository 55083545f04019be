"""The port's federated round driver (src/repro_torch/fl) against the JAX
package's (src/repro/fl), and the paper's FL laws on the port's own draws.

Against JAX, on the same numpy inputs (floats within 1e-5 relative, the
absolute slack 1e-5 times the largest magnitude compared, as the other port
tests do, so that sums over a differently ordered reduction compare too,
and never below 1e-12, round-off level for the identity codec's errors;
ints and ledgers exactly equal):

- clients: ``sample_round``, ``budget_groups``, ``partition`` and the two
  non-IID assignments give JAX's ids exactly;
- tasks: ``init``, ``client_vectors`` at two states, ``step`` and
  ``metric`` of all six tasks (``drift`` at rho = 1, where no draw enters);
- server: ``resolve_pipeline``, ``ema_update``, ``admit_stale``,
  ``commit_round``, ``side_info_for``, and ``measure_rho`` on JAX's draws;
- ``run_rounds``: every History column and the final client state, for
  the draw-free codecs (identity, top_k); the rand_k cases (their draws
  differ between the packages) compare the ledger columns;
- the refusals of ``run_rounds``: JAX's exception type and message.

On the port's own draws, no JAX: Fig. 4's order at equal bytes, temporal
beating spatial on drift, the wavg tracker, the heterogeneous-budget
decode, async rounds (equal to sync without stragglers, the staleness-0
ledger ablation, admission improving ``mse_pop``), and the overlapped and
owner-sharded decodes bitwise equal to the synchronous rounds.
"""
from __future__ import annotations

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core.estimators import rand_k as jrk
from repro.core.estimators import rand_proj_spatial as jrps
from repro.fl import clients as jclients
from repro.fl import rounds as jrounds
from repro.fl import server as jserver
from repro.fl import tasks as jtasks
from repro_torch import interop
from repro_torch.core import codec as tcodec
from repro_torch.core import random as prand
from repro_torch.fl import clients as tclients
from repro_torch.fl import rounds as trounds
from repro_torch.fl import run as trun
from repro_torch.fl import server as tserver
from repro_torch.fl import tasks as ttasks

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-12
INT_COLUMNS = ("bytes", "coded_bytes", "n_survivors", "n_sampled", "n_stale", "stale_bytes",
               "intra_pod_bytes", "dcn_bytes")
FLOAT_COLUMNS = ("metric", "mse", "mse_pop", "rho_hat")


@contextlib.contextmanager
def _cheap_compiles():
    """Compile the JAX reference without XLA's costly optimisation passes
    (each program runs a few times; they change no float semantics)."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


def _np(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, what=""):
    want = _np(want).astype(np.float64)
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(_np(got).astype(np.float64), want, rtol=RTOL,
                               atol=max(ATOL, RTOL * scale), err_msg=what)


def _equal_tree(got, want, path="") -> None:
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal_tree(g, w, f"{path}/{i}")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


# ------------------------------------------------------------------ clients

_LABELS = np.random.default_rng(0).integers(0, 10, 600)
_X = np.random.default_rng(1).standard_normal((600, 3)).astype(np.float32)


def _sample(m, participation, dropout):
    cohort = m.Cohort(10, participation=participation, dropout=dropout)
    return [(p.sampled, p.survivors, p.stragglers)
            for p in (cohort.sample_round(seed, t) for seed in (0, 3) for t in range(8))]


CLIENT_CASES = {
    **{f"sample_round/p{p}/drop{d}": functools.partial(_sample, participation=p, dropout=d)
       for p, d in ((1.0, 0.0), (0.5, 0.0), (0.75, 0.3), (0.4, 0.9))},
    "budget_groups": lambda m: [
        m.Cohort(6, budgets=(8, 8, 16, 16, 32, 8)).budget_groups(np.array([0, 2, 3, 5]), 4),
        m.Cohort(6).budget_groups(np.array([1, 4]), 4)],
    "partition/iid": lambda m: m.partition(_X, _LABELS, 4, "iid", seed=2),
    "partition/band": lambda m: m.partition(_X, _LABELS, 4, "band"),
    "partition/dirichlet": lambda m: m.partition(_X, _LABELS, 4, "dirichlet", alpha=0.2, seed=1),
    "band_assignment": lambda m: m.band_assignment(_LABELS, 5),
    "dirichlet_assignment": lambda m: m.dirichlet_assignment(_LABELS, 5, 0.3, seed=1),
}


@pytest.mark.parametrize("case", list(CLIENT_CASES))
def test_clients_match_jax_exactly(case):
    _equal_tree(CLIENT_CASES[case](tclients), CLIENT_CASES[case](jclients), case)


# -------------------------------------------------------------------- tasks

TASK_CASES = {
    "power_iteration": ("power_iteration", dict(n_clients=4, d=64, samples=200)),
    "power_iteration_band": ("power_iteration", dict(n_clients=4, d=64, samples=200,
                                                     scheme="band")),
    "kmeans": ("kmeans", dict(n_clients=4, d=16, samples=200, n_clusters=5)),
    "linear_regression": ("linear_regression", dict(n_clients=4, d=32, samples=200)),
    "logistic_regression": ("logistic_regression", dict(n_clients=4, feat=8, n_classes=5,
                                                        samples=200)),
    "dme": ("dme", dict(n_clients=4, d=64, rho=0.8)),
    "drift": ("drift", dict(n_clients=4, d=64, rho=1.0)),
    "drift_bias": ("drift", dict(n_clients=4, d=64, rho=1.0, client_bias=0.5)),
}


def _task_trace(name, kw, key, put, mean):
    """(init state, client vectors at it, state after one step, vectors and
    metric there) of one task in one package; ``put`` moves a float32 numpy
    array into the package."""
    task = (jtasks if put is jnp.asarray else ttasks).get_task(name, **kw)
    s0 = task.init(key)
    v0 = task.client_vectors(s0, key)
    s1 = task.step(s0, put(mean))
    s2 = task.step(s1, put(mean[::-1].copy()))
    out = {"s0": s0, "v0": v0, "s1": s1, "v1": task.client_vectors(s1, key),
           "v2": task.client_vectors(s2, key), "s2": s2}
    if task.metric is not None:
        out["metric"] = [task.metric(s1), task.metric(s2)]
    return task, out


@pytest.mark.parametrize("case", list(TASK_CASES))
def test_tasks_match_jax(case):
    name, kw = TASK_CASES[case]
    jt = jtasks.get_task(name, **kw)
    mean = np.random.default_rng(4).standard_normal(jt.dim).astype(np.float32) * 0.3
    with _cheap_compiles():
        _, want = _task_trace(name, kw, jax.random.key(0), jnp.asarray, mean)
    task, got = _task_trace(name, dict(kw, device=CPU), prand.key(0, CPU),
                            lambda a: torch.from_numpy(a), mean)
    assert task.device == torch.device(CPU) and task.dim == jt.dim
    for k in ("v0", "v1", "v2"):
        assert tuple(got[k].shape) == (task.n_clients, task.dim)
        _close(got[k], want[k], f"{case} {k}")
    for k in ("s0", "s1", "s2"):
        assert got[k]["t"] == want[k]["t"]
        for leaf in want[k]:
            if leaf != "t":
                _close(got[k][leaf], want[k][leaf], f"{case} {k}/{leaf}")
    if "metric" in want:
        assert all(isinstance(m, float) for m in got["metric"])
        _close(got["metric"], want["metric"], f"{case} metric")


def test_drift_noise_law():
    """drift's noise is the port's own normal(key, (n, d)) / sqrt(d), fresh
    each round: across clients, per coordinate, variance sigma^2 / d within
    Monte-Carlo error, and the client mean moves between rounds by noise of
    mean 0 only (omega = 0 holds the common part still)."""
    n, d, rho = 64, 256, 0.5
    sigma2 = 1.0 / rho - 1.0
    task = ttasks.get_task("drift", device=CPU, n_clients=n, d=d, rho=rho, omega=0.0)
    state = task.init(None)
    key = prand.key(0, CPU)
    v = [task.client_vectors(state, prand.fold_in(key, t)).double() for t in range(2)]
    var = float(((v[0] - v[0].mean(0)) ** 2).sum(0).mean()) / (n - 1)
    # the mean of d sample variances with n - 1 degrees of freedom each
    assert abs(var * d / sigma2 - 1.0) < 5 * np.sqrt(2.0 / ((n - 1) * d)), var * d / sigma2
    step = v[1].mean(0) - v[0].mean(0)  # per coordinate N(0, 2 sigma^2 / (n d))
    assert abs(float(step.mean())) < 5 * np.sqrt(2 * sigma2 / (n * d) / d)
    assert float(step.pow(2).mean()) == pytest.approx(2 * sigma2 / (n * d), rel=0.5)


# ------------------------------------------------------------------- server

def test_server_matches_jax():
    jpipe = jcodec.build("rand_proj_spatial", k=8, d_block=32, transform="wavg")
    tpipe = tcodec.build("rand_proj_spatial", k=8, d_block=32, transform="wavg")
    js, ts = jserver.ServerState(), tserver.ServerState()

    def resolved(mod, pipe, st, n):
        p = mod.resolve_pipeline(pipe, st, n)
        return p.describe(), p.transform, getattr(p.sparsifier, "r_value", None), p.k

    assert resolved(tserver, tpipe, ts, 8) == resolved(jserver, jpipe, js, 8)  # cold: avg
    for rho in (0.8, 0.35, 1.2, 0.6):
        jserver.ema_update(js, rho, gamma=0.3)
        tserver.ema_update(ts, rho, gamma=0.3)
        assert ts.r_ema == js.r_ema and ts.r_history == js.r_history
        for n in (8, 3, 1):  # warm: opt at R_ema (n - 1); singleton: one
            assert resolved(tserver, tpipe, ts, n) == resolved(jserver, jpipe, js, n)
    got = resolved(tserver, tpipe, ts, 5)
    assert got[1] == "opt" and got[2] == pytest.approx(ts.r_ema * 4)
    for name in ("rand_k", "top_k", "identity"):  # transform-free: pass through
        jp, tp = jcodec.build(name, k=8, d_block=32), tcodec.build(name, k=8, d_block=32)
        assert resolved(tserver, tp, ts, 1) == resolved(jserver, jp, js, 1)
        assert resolved(tserver, tp, ts, 4) == resolved(jserver, jp, js, 4)
    assert tserver.resolve_spec is tserver.resolve_pipeline

    rng = np.random.default_rng(5)
    fresh, stale = rng.standard_normal((2, 3, 32)).astype(np.float32)
    for w in (1.0, 0.5):
        _close(tserver.admit_stale(torch.from_numpy(fresh), 5, torch.from_numpy(stale), 2, w),
               jserver.admit_stale(jnp.asarray(fresh), 5, jnp.asarray(stale), 2, w))
    for mod, st, arr in ((jserver, js, jnp.asarray(fresh)),
                         (tserver, ts, torch.from_numpy(fresh))):
        assert mod.side_info_for(st, temporal=True) is None
        mod.commit_round(st, arr)
        assert mod.side_info_for(st, temporal=False) is None
        assert mod.side_info_for(st, temporal=True) is arr and st.round == 1
    info = {"intra_pod_bytes_allgather": 900, "intra_pod_bytes_ownership": 300}
    assert tserver.intra_pod_reduction(info) == jserver.intra_pod_reduction(info) == 3.0


MEASURE_N, MEASURE_C, MEASURE_D, MEASURE_K, MEASURE_IDS = 4, 3, 32, 8, (0, 2, 5, 6)


@functools.cache
def _jax_measure_rho() -> dict:
    rng = np.random.default_rng(6)
    common = rng.standard_normal((MEASURE_C, MEASURE_D))
    xs = (common[None] + rng.standard_normal((MEASURE_N,) + common.shape)).astype(np.float32)
    key = jax.random.key(9)
    ids = jnp.asarray(MEASURE_IDS)
    out = {"xs": xs}
    kw = dict(k=MEASURE_K, d_block=MEASURE_D)
    with _cheap_compiles():
        for name, spec in (("rand_k", jcodec.RandK(**kw)),
                           ("srht", jcodec.RandProjSpatial(transform="avg", **kw))):
            pipe = jcodec.Pipeline([spec])
            payloads, _ = pipe.encode_all(key, jnp.asarray(xs), client_ids=ids)
            if name == "rand_k":
                draws = {"rows": np.stack([np.asarray(jrk._indices(spec, key, cid, MEASURE_C))
                                           for cid in MEASURE_IDS])[:, :1]}
            else:
                draws = jax.tree.map(np.asarray,
                                     jrps._fused_draws(spec, key, MEASURE_N, MEASURE_C, ids, 0))
            out[name] = {"vals": np.asarray(payloads.arrays["vals"]), "draws": draws,
                         "rho": jserver.measure_rho(pipe, key, payloads, MEASURE_IDS)}
    return out


@pytest.mark.parametrize("name", ["rand_k", "srht"])
def test_measure_rho_matches_jax_on_its_draws(name):
    j = _jax_measure_rho()
    kw = dict(k=MEASURE_K, d_block=MEASURE_D)
    spec = tcodec.RandK(**kw) if name == "rand_k" else tcodec.RandProjSpatial(transform="avg",
                                                                               **kw)
    pipe = tcodec.Pipeline([spec])
    payloads = tcodec.Payload({"vals": torch.from_numpy(np.array(j[name]["vals"]))},
                              pipe.payload_meta(MEASURE_C))
    draws = interop.draws_from_numpy(j[name]["draws"], CPU)
    got = tserver.measure_rho(pipe, 0, payloads, MEASURE_IDS, draws=draws)
    assert 0.0 < j[name]["rho"] < 1.0
    assert got == pytest.approx(j[name]["rho"], rel=RTOL)
    assert tserver.measure_rho(pipe, 0, payloads, MEASURE_IDS[:1]) is None


# -------------------------------------------------------- run_rounds vs JAX

ROUND_CASES = {
    # name: (task, task kw, spec kw, cohort kw, cfg kw, compare every column)
    "identity_budgets": ("dme", dict(n_clients=4, d=64),
                         dict(name="identity", d_block=32),
                         dict(participation=0.75, dropout=0.3, budgets=(8, 8, 16, 16)),
                         dict(n_rounds=3), True),
    "top_k_ef": ("dme", dict(n_clients=4, d=64), dict(name="top_k", k=8, d_block=32, ef=True),
                 dict(dropout=0.3), dict(n_rounds=3), True),
    "top_k_temporal_async": ("drift", dict(n_clients=4, d=64, rho=1.0, client_bias=0.5),
                             dict(name="top_k", k=8, d_block=32, temporal=True),
                             dict(dropout=0.4), dict(n_rounds=3, async_rounds=True, seed=6),
                             True),
    "top_k_temporal_async_staleness0": (
        "drift", dict(n_clients=4, d=64, rho=1.0, client_bias=0.5),
        dict(name="top_k", k=8, d_block=32, temporal=True), dict(dropout=0.4),
        dict(n_rounds=3, async_rounds=True, staleness=0, seed=6), True),
    "broadcast_temporal": ("dme", dict(n_clients=4, d=64), dict(name="top_k", k=8, d_block=32),
                           {}, dict(n_rounds=3, temporal=True), True),
    "rand_k_entropy": ("dme", dict(n_clients=4, d=64),
                       dict(name="rand_k", k=8, d_block=32, entropy_code=True),
                       dict(dropout=0.3), dict(n_rounds=3), False),
    "rand_k_adaptive": ("dme", dict(n_clients=4, d=96),
                        dict(name="rand_k", k=8, d_block=32), {},
                        dict(n_rounds=3, adaptive_budgets=True), False),
}


def _run(mods, case):
    task_mod, codec_mod, rounds_mod, clients_mod, extra = mods
    name, task_kw, spec_kw, cohort_kw, cfg_kw, _ = ROUND_CASES[case]
    task = task_mod.get_task(name, **task_kw, **extra)
    spec_kw = dict(spec_kw)
    spec = codec_mod.build(spec_kw.pop("name"), **spec_kw)
    cohort = clients_mod.Cohort(task.n_clients, **cohort_kw)
    return rounds_mod.run_rounds(task, spec, cohort, rounds_mod.RoundConfig(**cfg_kw),
                                 **extra)


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_run_rounds_matches_jax(case):
    with _cheap_compiles():
        jstate, jh = _run((jtasks, jcodec, jrounds, jclients, {}), case)
    tstate, th = _run((ttasks, tcodec, trounds, tclients, {"device": CPU}), case)
    full = ROUND_CASES[case][-1]
    for col in INT_COLUMNS:
        assert getattr(th, col) == [int(v) for v in getattr(jh, col)], col
        assert all(type(v) is int for v in getattr(th, col)), col
    assert th.total_bytes == jh.total_bytes and th.total_coded_bytes == jh.total_coded_bytes
    assert th.total_stale_bytes == jh.total_stale_bytes
    if not full:  # rand_k: the draws differ; the ledger does not
        assert np.isfinite(th.mse).all() and np.isfinite(th.mse_pop).all()
        return
    for col in FLOAT_COLUMNS:
        assert all(isinstance(v, float) for v in getattr(th, col)), col
        _close(getattr(th, col), getattr(jh, col), col)
    assert (th.client_state is None) == (jh.client_state is None)
    if jh.client_state is not None:
        for leaf in ("ef", "memory"):
            want = getattr(jh.client_state, leaf)
            got = getattr(th.client_state, leaf)
            assert (got is None) == (want is None), leaf
            if want is not None:
                _close(got, want, leaf)
    for leaf in jstate:
        if leaf != "t":
            _close(tstate[leaf], jstate[leaf], leaf)
    assert [list(r) for r in th.round_records()] == [list(r) for r in jh.round_records()]


def test_async_cases_admit_a_straggler():
    """The async comparison above admits a late payload (staleness 1) and
    drops one (staleness 0): its seed was picked for it."""
    cohort = tclients.Cohort(4, dropout=0.4)
    parts = [cohort.sample_round(6, t) for t in range(3)]
    admitted = [np.setdiff1d(parts[t].stragglers, parts[t + 1].survivors) for t in range(2)]
    assert any(len(a) for a in admitted)


REFUSALS = {
    "not_streamable": (dict(name="rand_k", k=8, d_block=32, shared_randomness=False),
                       dict(overlap=True)),
    "not_shardable": (dict(name="rand_k_spatial", k=8, d_block=32, r_mode="est"),
                      dict(ownership=True, n_owners=2)),
    "overlap_stateful": (dict(name="rand_k", k=8, d_block=32, ef=True), dict(overlap=True)),
    "adaptive_overlap": (dict(name="rand_k", k=8, d_block=32),
                         dict(adaptive_budgets=True, overlap=True)),
    "adaptive_ownership": (dict(name="rand_k", k=8, d_block=32),
                           dict(adaptive_budgets=True, ownership=True)),
    "adaptive_async": (dict(name="rand_k", k=8, d_block=32),
                       dict(adaptive_budgets=True, async_rounds=True)),
    "adaptive_top_k": (dict(name="top_k", k=8, d_block=32), dict(adaptive_budgets=True)),
    "ef_async": (dict(name="top_k", k=8, d_block=32, ef=True), dict(async_rounds=True)),
    "staleness_2": (dict(name="rand_k", k=8, d_block=32), dict(async_rounds=True, staleness=2)),
    "negative_owners": (dict(name="rand_k", k=8, d_block=32), dict(ownership=True, n_owners=-1)),
    "bad_hierarchy": (dict(name="rand_k", k=8, d_block=32), dict(hierarchy="tree")),
}


def _refusal(task_mod, codec_mod, rounds_mod, case, **extra):
    spec_kw, cfg_kw = REFUSALS[case]
    spec_kw = dict(spec_kw)
    task = task_mod.get_task("dme", n_clients=4, d=64, **extra)
    with pytest.raises(Exception) as ei:
        rounds_mod.run_rounds(task, codec_mod.build(spec_kw.pop("name"), **spec_kw),
                              cfg=rounds_mod.RoundConfig(n_rounds=1, **cfg_kw), **extra)
    return ei.value


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_keep_jax_wording(case):
    want = _refusal(jtasks, jcodec, jrounds, case)
    got = _refusal(ttasks, tcodec, trounds, case, device=CPU)
    assert type(got) is type(want) is ValueError
    assert str(got) == str(want)


# ------------------------------------------------- laws on the port's draws

def _port(task_name, spec, cohort=None, device=CPU, **cfg):
    task = ttasks.get_task(task_name[0], device=device, **task_name[1])
    return trounds.run_rounds(task, spec, cohort, trounds.RoundConfig(**cfg), device=device)


def test_fig4_ordering_mse_at_equal_bytes():
    """Rand-Proj-Spatial < Rand-k-Spatial < Rand-k at equal bytes on a
    rho = 0.9 task (tests/test_fl.py's sizes, 50 rounds)."""
    res = {}
    for name, tf in [("rand_k", "one"), ("rand_k_spatial", "avg"), ("rand_proj_spatial", "avg")]:
        _, hist = _port(("dme", dict(n_clients=8, d=128, rho=0.9)),
                        tcodec.build(name, k=16, d_block=128, transform=tf), n_rounds=50)
        res[name] = (np.mean(hist.mse), hist.total_bytes)
    assert res["rand_k"][1] == res["rand_k_spatial"][1] == res["rand_proj_spatial"][1]
    assert res["rand_proj_spatial"][0] < res["rand_k_spatial"][0] < res["rand_k"][0], res


def test_temporal_beats_spatial_on_drift():
    drift = ("drift", dict(n_clients=8, d=128, rho=0.95, omega=0.03))
    spec = tcodec.build("rand_proj_spatial", k=16, d_block=128, transform="avg")
    _, h_sp = _port(drift, spec, n_rounds=20)
    _, h_tm = _port(drift, spec, n_rounds=20, temporal=True)
    assert h_sp.total_bytes == h_tm.total_bytes and h_sp.bytes == h_tm.bytes
    assert np.mean(h_tm.mse[2:]) < 0.7 * np.mean(h_sp.mse[2:])


def test_wavg_tracks_correlation_online():
    rho_true = 0.9
    dme = ("dme", dict(n_clients=8, d=128, rho=rho_true))
    spec = tcodec.build("rand_proj_spatial", k=24, d_block=128, transform="wavg")
    _, hist = _port(dme, spec, n_rounds=25)
    tail = [r for r in hist.rho_hat[5:] if not np.isnan(r)]
    assert len(tail) > 0
    assert abs(np.mean(tail) - rho_true) < 0.2, np.mean(tail)
    _, h_avg = _port(dme, spec.replace(transform="avg"), n_rounds=25)
    assert np.isnan(h_avg.rho_hat).all()
    assert np.mean(hist.mse) < np.mean(h_avg.mse)


def test_heterogeneous_budget_decode_is_unbiased():
    """Budget-grouped rand_k decode over 150 seeds: bounded by the
    worst-group Rand-k bound, and the mean of the estimates converges on
    the survivors' mean (statistical)."""
    n, d = 6, 64
    task = ttasks.get_task("dme", device=CPU, n_clients=n, d=d, rho=0.7)
    cohort = tclients.Cohort(n_clients=n, budgets=(8, 8, 8, 16, 16, 16))
    spec = tcodec.build("rand_k", k=8, d_block=d)
    ests, mses = [], []
    for seed in range(150):
        state, hist = trounds.run_rounds(task, spec, cohort,
                                         trounds.RoundConfig(n_rounds=1, seed=seed), device=CPU)
        ests.append(state["mean"].double())
        mses.append(hist.mse[0])
    xs = task.aux["xs"].double()
    worst = (1 / 3**2) * (d / 8 - 1) * float((xs**2).sum()) / 2
    assert np.mean(mses) < worst
    bias = torch.stack(ests).mean(0) - xs.mean(0)
    # the mean of 150 estimates: its squared error shrinks like mse / 150
    assert float((bias**2).sum()) < 5 * np.mean(mses) / 150


DRIFT = ("drift", dict(n_clients=8, d=128, rho=0.95, omega=0.02))


def test_async_equals_sync_without_stragglers():
    spec = tcodec.RandProjSpatial(k=16, d_block=128, transform="avg")
    _, h_sync = _port(DRIFT, spec, n_rounds=5)
    _, h_async = _port(DRIFT, spec, n_rounds=5, async_rounds=True)
    assert h_sync.mse == h_async.mse and h_sync.mse_pop == h_async.mse_pop
    assert h_sync.bytes == h_async.bytes and sum(h_async.n_stale) == 0


def test_async_ledger_identity_and_staleness0_ablation():
    spec = tcodec.RandProjSpatial(k=16, d_block=128, transform="avg")
    cohort = tclients.Cohort(n_clients=8, dropout=0.3)
    _, h_sync = _port(DRIFT, spec, cohort, n_rounds=10)
    _, h_async = _port(DRIFT, spec, cohort, n_rounds=10, async_rounds=True)
    _, h_drop = _port(DRIFT, spec, cohort, n_rounds=10, async_rounds=True, staleness=0)
    assert sum(h_async.n_stale) > 0
    assert h_async.total_bytes == h_sync.total_bytes + h_async.total_stale_bytes
    assert h_async.bytes == [s + e for s, e in zip(h_sync.bytes, h_async.stale_bytes)]
    assert h_drop.mse == h_sync.mse and h_drop.bytes == h_sync.bytes


def test_straggler_admission_improves_population_mse():
    drift = ("drift", dict(n_clients=8, d=256, rho=0.95, omega=0.02))
    spec = tcodec.RandProjSpatial(k=26, d_block=256, transform="avg")
    cohort = tclients.Cohort(n_clients=8, dropout=0.3)
    _, h_sync = _port(drift, spec, cohort, n_rounds=25)
    _, h_async = _port(drift, spec, cohort, n_rounds=25, async_rounds=True)
    assert sum(h_async.n_stale) > 0
    assert np.mean(h_async.mse_pop) < np.mean(h_sync.mse_pop)


# ------------------------------------------- overlap and ownership in rounds

PARITY_SPECS = {
    "rand_proj_spatial": lambda: tcodec.RandProjSpatial(k=8, d_block=64, transform="avg"),
    "rand_k": lambda: tcodec.RandK(k=8, d_block=64),
    "top_k": lambda: tcodec.TopK(k=8, d_block=64),
}
PARITY_VARIANTS = {
    "overlap_tile1": dict(overlap=True),
    "overlap_tile3": dict(overlap=True, overlap_tile=3),
    "overlap_tile_over_c": dict(overlap=True, overlap_tile=64),
    "owners2": dict(ownership=True, n_owners=2),
    "owners3": dict(ownership=True, n_owners=3),
    "owners3_overlap_tile2": dict(ownership=True, n_owners=3, overlap=True, overlap_tile=2),
}
# 320 values in chunks of 64: C = 5, so 2 and 3 owners are ragged; a fixed
# cohort of 6 of 8 clients, different ones each round
PARITY_TASK = ("drift", dict(n_clients=8, d=320, rho=0.95, omega=0.02))
PARITY_COHORT = dict(n_clients=8, participation=0.75)


@functools.cache
def _parity_base(spec_name):
    state, hist = _port(PARITY_TASK, PARITY_SPECS[spec_name](),
                        tclients.Cohort(**PARITY_COHORT), n_rounds=3)
    return state, hist


@pytest.mark.parametrize("variant", list(PARITY_VARIANTS))
@pytest.mark.parametrize("spec_name", list(PARITY_SPECS))
def test_overlap_and_ownership_bitwise_through_rounds(spec_name, variant):
    s0, h0 = _parity_base(spec_name)
    cfg = PARITY_VARIANTS[variant]
    s1, h1 = _port(PARITY_TASK, PARITY_SPECS[spec_name](), tclients.Cohort(**PARITY_COHORT),
                   n_rounds=3, **cfg)
    for col in INT_COLUMNS + FLOAT_COLUMNS:
        if col == "intra_pod_bytes":
            continue
        np.testing.assert_array_equal(getattr(h1, col), getattr(h0, col), err_msg=col)
    assert torch.equal(s1["mean"], s0["mean"])
    if cfg.get("ownership"):
        assert all(b > 0 for b in h1.intra_pod_bytes)
    else:
        assert h1.intra_pod_bytes == h0.intra_pod_bytes == [0, 0, 0]


# ---------------------------------------------------------------------- CLI

def test_cli_smoke_on_cpu(capsys, tmp_path):
    path = tmp_path / "m.json"
    assert trun.main(["--device", "cpu", "--smoke", "--task", "kmeans", "--estimator", "rand_k",
                      "--metrics-json", str(path)]) == 0
    out = capsys.readouterr().out
    assert "kmeans" in out and "final_quant_loss=" in out
    data = json.loads(path.read_text())
    assert data["schema_version"] == 2 and data["run"]["device"] == "cpu"
    assert len(data["runs"]) == 1 and len(data["runs"][0]["rounds"]) == 3
