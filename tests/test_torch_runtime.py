"""The port's multi-host hierarchical runtime (src/repro_torch/runtime) and
the hierarchical rounds of fl/rounds.py against the JAX package's, on the
CPU.

- ``PodPlan`` (slices, owners, order-preserving restrict, refusals),
  ``combine_records`` (bitwise, weights), ``combine_rho``,
  ``Topology.from_env`` and ``cross_pod_traffic`` (the same integers) on
  the same inputs as JAX's; the context's pod ownership;
- two hierarchical rounds at 1 and 2 pods of 4 clients on
  tests/test_runtime.py's drift setup, every client taking part, against the JAX package's on the
  same seed (the port draws JAX's threefry maps): floats within ``RTOL``
  1e-5 (tests/test_torch_fl.py's), ledgers and ``dcn_bytes`` exactly
  equal; one pod bitwise the port's flat rounds; the refusals in JAX's
  words (the two-process runs below keep the setup's dropout);
- two processes started once through tests/torch_dist_ranks.py's
  ``run_ranks`` (a 120 s deadline; each joins the runtime on the CPU, its
  store hosted by process 0): the store's byte round trip
  (``kv_roundtrip_worker``), and the base, ef, hetero and async variants of
  tests/test_runtime.py, every process's History bitwise one process's.
  (``spawn_local`` itself runs under tests/test_torch_port_rules.py's
  ``fl.run --pods 2 --hosts 2``.)
"""
from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro.core import codec as jcodec
from repro.fl import Cohort as JCohort
from repro.fl import RoundConfig as JRoundConfig
from repro.fl import get_task as jget_task
from repro.fl import run_rounds as jrun_rounds
from repro.runtime import PodPlan as JPodPlan
from repro.runtime import Topology as JTopology
from repro.runtime import combine_records as jcombine_records
from repro.runtime import combine_rho as jcombine_rho
from repro.runtime import cross_pod_traffic as jcross_pod_traffic
from repro.runtime import launch as jlaunch
from repro_torch.core import codec as tcodec
from repro_torch.fl import Cohort, RoundConfig, get_task, run_rounds
from repro_torch.runtime import (
    PodPlan,
    RuntimeContext,
    Topology,
    combine_records,
    combine_rho,
    cross_pod_traffic,
    free_port,
    launch,
)
from repro_torch.runtime.workers import history_arrays, kv_roundtrip_worker, round_worker

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-12   # tests/test_torch_fl.py's
INT_COLUMNS = ("bytes", "n_survivors", "n_sampled", "n_stale", "stale_bytes",
               "intra_pod_bytes", "dcn_bytes")
FLOAT_COLUMNS = ("metric", "mse", "mse_pop", "rho_hat")


@contextlib.contextmanager
def _cheap_compiles():
    """Run the JAX reference without XLA's costly optimisation passes:
    it runs once, and they change no float semantics."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


# ------------------------------------------------------- plans and combines


@pytest.mark.parametrize("n_clients,n_pods", [(10, 3), (12, 3), (8, 1), (5, 5)])
def test_pod_plan_matches_jax(n_clients, n_pods):
    got, want = PodPlan(n_clients, n_pods), JPodPlan(n_clients, n_pods)
    assert got.clients_per_pod == want.clients_per_pod
    ids = np.random.default_rng(n_clients).permutation(n_clients)[: n_clients - 1]
    for p in range(n_pods):
        assert got.slice_for(p) == want.slice_for(p)
        assert np.array_equal(got.clients_of(p), want.clients_of(p))
        assert np.array_equal(got.restrict(ids, p), want.restrict(ids, p))
    assert [got.pod_of(c) for c in range(n_clients)] == [want.pod_of(c) for c in range(n_clients)]
    if n_pods == 1:  # the bitwise contract: a 1-pod restrict is the identity
        assert np.array_equal(got.restrict(ids, 0), ids)


@pytest.mark.parametrize("args,match", [((4, 0), "n_pods"), ((2, 3), "one client per pod")])
def test_pod_plan_refusals_match_jax(args, match):
    for cls in (PodPlan, JPodPlan):
        with pytest.raises(ValueError, match=match):
            cls(*args)
    for plan in (PodPlan(4, 2), JPodPlan(4, 2)):
        with pytest.raises(ValueError, match="out of range"):
            plan.slice_for(2)


def _records(case: str) -> dict:
    rng = np.random.default_rng(len(case))

    def est():
        return rng.standard_normal((2, 16)).astype(np.float32)

    return {
        "single": {0: {"mean": est(), "n": 5, "rho": 0.25}, 1: {"mean": None, "n": 0}},
        "weighted": {0: {"mean": est(), "n": 1, "rho": 0.2}, 1: {"mean": est(), "n": 3,
                                                              "rho": 0.6}},
        "three": {2: {"mean": est(), "n": 2, "rho": None}, 0: {"mean": est(), "n": 3,
                                                              "rho": 0.5},
                  1: {"mean": est(), "n": 4, "rho": 0.9}},
        "empty": {0: {"mean": None, "n": 0, "rho": None}},
    }[case]


@pytest.mark.parametrize("case", ["single", "weighted", "three", "empty"])
def test_combine_records_and_rho_match_jax(case):
    recs = _records(case)
    got, want = combine_records(recs), jcombine_records(recs)
    assert got[1:] == want[1:]
    assert (got[0] is None) == (want[0] is None)
    if want[0] is not None:
        got_np = got[0].numpy()
        assert got_np.dtype == want[0].dtype and got_np.tobytes() == np.asarray(want[0]).tobytes()
    assert combine_rho(recs) == jcombine_rho(recs)


def test_topology_from_env_matches_jax(monkeypatch):
    assert Topology() == Topology.from_env()
    for cls in (Topology, JTopology):
        with pytest.raises(ValueError, match="out of range"):
            cls(n_processes=2, process_id=5)
        with pytest.raises(ValueError, match="coordinator"):
            cls(n_processes=2, process_id=1)
    keys = ("ENV_NUM_PROCESSES", "ENV_PROCESS_ID", "ENV_COORDINATOR", "ENV_LOCAL_DEVICES")
    assert [getattr(launch, k) for k in keys] == [getattr(jlaunch, k) for k in keys]
    for key, value in zip(keys, ("4", "2", "127.0.0.1:1234", "2")):
        monkeypatch.setenv(getattr(launch, key), value)
    got, want = Topology.from_env(), JTopology.from_env()
    assert (got.n_processes, got.process_id, got.coordinator, got.local_devices) == \
        (want.n_processes, want.process_id, want.coordinator, want.local_devices) == \
        (4, 2, "127.0.0.1:1234", 2)
    assert Topology.from_env(coordinator="h:1", process_id=0).coordinator == "h:1"
    assert 0 < free_port() < 65536


@pytest.mark.parametrize("n_processes,n_pods", [(2, 2), (2, 3), (3, 2), (4, 7)])
def test_pod_ownership_covers_every_pod_once(n_processes, n_pods):
    owned = []
    for pid in range(n_processes):
        ctx = RuntimeContext(Topology(n_processes, pid, "h:1"), device=CPU)
        owned += list(ctx.pods_owned(n_pods))
        assert all(ctx.owner_of_pod(p, n_pods) == pid for p in ctx.pods_owned(n_pods))
    assert owned == list(range(n_pods))
    with pytest.raises(RuntimeError, match="no KV store"):
        RuntimeContext(Topology(), device=CPU).put_bytes("k", b"")


TRAFFIC = {  # name -> (n_clients, k, d_block, budgets, survivors, pods, stale_pods, hierarchy)
    "nk_over_d": (16, 64, 128, None, np.arange(16), 2, 0, "hier"),
    "flat": (16, 64, 128, None, np.arange(16), 2, 0, "flat"),
    "hetero_stale": (8, 8, 64, (4, 4, 8, 8, 8, 8, 16, 16), np.array([0, 3, 5, 6]), 3, 1, "hier"),
    "one_pod": (6, 8, 64, None, np.array([1, 2, 4]), 1, 0, "hier"),
}


@pytest.mark.parametrize("case", list(TRAFFIC))
def test_cross_pod_traffic_matches_jax(case):
    n, k, d_block, budgets, survivors, pods, stale, hierarchy = TRAFFIC[case]
    kw = dict(stale_pods=stale, hierarchy=hierarchy)
    got = cross_pod_traffic(tcodec.as_pipeline(tcodec.RandProjSpatial(k=k, d_block=d_block)),
                            Cohort(n_clients=n, budgets=budgets), survivors, PodPlan(n, pods),
                            3, **kw)
    want = jcross_pod_traffic(jcodec.as_pipeline(jcodec.RandProjSpatial(k=k, d_block=d_block)),
                              JCohort(n_clients=n, budgets=budgets), survivors,
                              JPodPlan(n, pods), 3, **kw)
    assert got == want and all(type(v) is int for v in got.values())
    if case == "nk_over_d":  # the regime the hierarchy exists for
        assert 0 < got["dcn_bytes"] == got["dcn_bytes_hier"] < got["dcn_bytes_flat"]


# --------------------------------------------------- hierarchical rounds


CLIENTS_A_POD = 4  # both pod counts decode pods of this many clients


def _drift(mods, n_rounds=2, n_clients=8, **cfg):
    """tests/test_runtime.py's drift setup through one package's rounds,
    every client taking part (one shape a decode, so the JAX package's
    eager rounds compile each program once)."""
    get, cohort_cls, cfg_cls, run, codec_mod, extra = mods
    task = get("drift", n_clients=n_clients, d=128, rho=0.9, omega=0.05, client_bias=0.5,
               **extra)
    cohort = cohort_cls(n_clients=n_clients, participation=1.0, dropout=0.0)
    pipe = codec_mod.Pipeline([codec_mod.RandProjSpatial(k=8, d_block=64, transform="wavg")])
    _, hist = run(task, pipe, cohort, cfg_cls(n_rounds=n_rounds, **cfg), **extra)
    return hist


PORT = (get_task, Cohort, RoundConfig, run_rounds, tcodec, {"device": CPU})
JAX = (jget_task, JCohort, JRoundConfig, jrun_rounds, jcodec, {})


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=max(ATOL, RTOL * scale), err_msg=what)


@pytest.mark.parametrize("pods", [1, 2])
def test_hier_rounds_match_jax(pods):
    n = CLIENTS_A_POD * pods
    with _cheap_compiles():
        jh = _drift(JAX, hierarchy="hier", pods=pods, n_clients=n)
    th = _drift(PORT, hierarchy="hier", pods=pods, n_clients=n)
    for col in INT_COLUMNS:
        assert getattr(th, col) == [int(v) for v in getattr(jh, col)], col
    assert th.total_dcn_bytes == jh.total_dcn_bytes
    assert (th.total_dcn_bytes > 0) == (pods > 1)
    for col in FLOAT_COLUMNS:
        _close(getattr(th, col), getattr(jh, col), col)
    if pods == 1:  # bitwise the flat rounds
        flat = history_arrays(_drift(PORT, n_clients=n))
        assert all(flat[k].tobytes() == v.tobytes() for k, v in history_arrays(th).items())


@pytest.mark.parametrize("cfg,match", [(dict(hierarchy="nope"), "hierarchy"),
                                       (dict(hierarchy="hier", pods=0), "pods"),
                                       (dict(hierarchy="hier", pods=2, backend="gspmd"),
                                        "backend")])
def test_hier_refusals_keep_jax_wording(cfg, match):
    errs = []
    for mods in (JAX, PORT):
        with pytest.raises(ValueError, match=match) as ei:
            _drift(mods, n_rounds=1, **cfg)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


# --------------------------------------------------------- two processes


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    return ranks.run_ranks("runtime_two", 2, tmp_path_factory.mktemp("runtime2"))


def test_kv_roundtrip_bytes(two_processes):
    """Each process read the other's array back bit for bit (the worker
    checks the bytes) and both hold the same checksums; one process alone
    exchanges nothing."""
    sums = [out["kv"] for out in two_processes]
    assert sums[0] == sums[1] and sorted(sums[0]) == [0, 1]
    alone = kv_roundtrip_worker(RuntimeContext(Topology(), device=CPU))
    assert alone == {0: sums[0][0]}


def _compared(out: dict) -> list:
    """The History columns and ledger totals of a worker's result (not its
    wall time or process id)."""
    return [(k, v) for k, v in out.items() if k not in ("wall_s", "process_id")]


@pytest.mark.parametrize("variant", list(ranks.RUNTIME_VARIANTS))
def test_two_processes_bitwise_one_process(variant, two_processes):
    ref = round_worker(RuntimeContext(Topology(), device=CPU), ranks.RUNTIME_VARIANTS[variant])
    for pid, out in enumerate(two_processes):
        got = out[variant]
        assert got["process_id"] == pid
        for key, want in _compared(ref):
            assert np.asarray(got[key]).tobytes() == np.asarray(want).tobytes(), (variant, pid,
                                                                                    key)
    if variant == "async":
        assert ref["n_stale"].sum() > 0  # a late payload was admitted
    assert ref["total_dcn_bytes"] > 0
