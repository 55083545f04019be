"""The port's observability layer (src/repro_torch/obs): the registry's
no-op when disabled, its refusal to read tensors, deterministic counters,
and the round tracer's byte-ledger parity with History, in the JAX
package's Chrome-trace format (tools/trace_report.py reads it); the
profiler session's trace file and ``fl.run --profile-dir``; and the kernel
telemetry (``kernels/dispatch``, ``kernels/decode_route``,
``kernels/cg_iters``), held against the JAX package's on one tiny round
(the one test that imports JAX).

The load-bearing contract is the disabled case: with recording off (the
default), the instrumented driver computes the same bits as with it on.
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import codec
from repro_torch.dist import collectives
from repro_torch.fl import Cohort, RoundConfig, get_task, run_rounds
from repro_torch.fl import run as run_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
D = 64
N_ROUNDS = 4


@pytest.fixture(autouse=True)
def obs_clean():
    """Every test starts and ends disabled and empty, with no tracer: obs
    state is process-global, so leakage would couple tests."""
    obs.disable()
    obs.reset()
    obs.uninstall_tracer()
    yield
    obs.disable()
    obs.reset()
    obs.uninstall_tracer()


def _trace_report():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import trace_report
    finally:
        sys.path.pop(0)
    return trace_report


# the round configurations the tracer must cover: every phase, every round
RUNS = {
    "sync": (lambda: codec.RandProjSpatial(k=8, d_block=D, transform="avg"), {}, {}),
    "overlap": (lambda: codec.RandProjSpatial(k=8, d_block=D, transform="avg"), {},
                dict(overlap=True, overlap_tile=1)),
    "ownership": (lambda: codec.RandK(k=8, d_block=D), {}, dict(ownership=True, n_owners=2)),
    "async": (lambda: codec.build("rand_k", k=8, d_block=D, temporal=True),
              dict(dropout=0.4), dict(async_rounds=True, seed=5)),
    "wavg_coded": (lambda: codec.build("rand_proj_spatial", k=8, d_block=D, transform="wavg",
                                       entropy_code=True), {}, {}),
}


def _run(name):
    make, cohort_kw, cfg_kw = RUNS[name]
    task = get_task("drift", device="cpu", n_clients=6, d=2 * D)
    return run_rounds(task, make(), Cohort(n_clients=6, **cohort_kw),
                      RoundConfig(n_rounds=N_ROUNDS, **cfg_kw), device="cpu")


# ------------------------------------------------------------ registry basics

def test_disabled_recording_is_a_noop():
    obs.count("t", "c")
    obs.gauge("t", "g", 3.0)
    obs.observe("t", "h", 1.0)
    obs.marker("t", "m")
    snap = obs.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {}
    assert snap["histograms"] == {} and snap["tracer_drops"] == 0
    # the disabled span is one shared object that still yields a dict
    s1, s2 = obs.span("t", "s"), obs.span("t", "s")
    assert s1 is s2
    with s1 as ann:
        ann["late"] = 1


def test_enabled_recording_and_keys():
    obs.enable()
    obs.count("codec", "decode.calls", sparsifier="rand_k")
    obs.count("codec", "decode.calls", sparsifier="rand_k")
    obs.gauge("bench", "x.compile_us", 12.5)
    obs.observe("fl", "round.duration_us", 3.0)
    with obs.span("fl", "step") as ann:
        ann["note"] = "hi"
    snap = obs.snapshot()
    assert snap["counters"]["codec/decode.calls{sparsifier=rand_k}"] == 2
    assert snap["gauges"]["bench/x.compile_us"] == 12.5
    assert snap["counters"]["fl/step.calls"] == 1
    assert snap["histograms"]["fl/step.duration_us"]["count"] == 1
    obs.reset()
    assert obs.snapshot()["counters"] == {}


def test_tensors_are_dropped_and_counted():
    """A tensor handed to the registry is never read (on the card that read
    would wait for the device): the sample is dropped and counted."""
    obs.enable()
    tracer = obs.install_tracer(obs.Tracer())
    obs.count("t", "dynamic", torch.tensor(3.0))
    obs.gauge("t", "dyn_gauge", torch.ones(()))
    obs.observe("t", "dyn_hist", torch.zeros(2))
    obs.count("t", "static", 1)
    with obs.span("t", "blk", dyn=torch.tensor(1.0), static_lbl="s", n=3) as ann:
        ann["also_dyn"] = torch.tensor(2.0)
    obs.marker("t", "mark", dyn=torch.tensor(1.0), bytes=7)
    snap = obs.snapshot()
    assert "t/dynamic" not in snap["counters"]
    assert "t/dyn_gauge" not in snap["gauges"]
    assert "t/dyn_hist" not in snap["histograms"]
    assert snap["counters"]["t/static"] == 1
    assert obs.tracer_drops() == snap["tracer_drops"] == 6
    spans = [e for e in tracer.events if e["ph"] == "X"]
    assert spans[0]["args"] == {"static_lbl": "s", "n": 3.0}
    assert spans[1]["args"] == {"bytes": 7.0}


def test_counters_deterministic_across_runs():
    snaps = []
    for _ in range(2):
        obs.reset()
        obs.enable()
        _run("sync")
        snaps.append(obs.snapshot()["counters"])
        obs.disable()
    assert snaps[0] == snaps[1]
    assert snaps[0]["fl/client_encode.calls"] == N_ROUNDS
    assert any(k.startswith("codec/decode") for k in snaps[0])
    assert any(k.startswith("codec/encode_all") for k in snaps[0])


def test_collective_records_dist_spans():
    obs.enable()
    tree = {"w": torch.randn(3, 2 * D)}
    collectives.compressed_mean_tree(codec.RandK(k=8, d_block=D), 0, tree, device="cpu")
    collectives.compressed_mean_tree(codec.RandK(k=8, d_block=D), 0, tree, device="cpu",
                                     ownership=2)
    counters = obs.snapshot()["counters"]
    assert counters["dist/client_encode.calls"] == 2
    assert counters["dist/owner_decode.calls"] == 2


# ------------------------------------------- disabled-mode bitwise identity

@pytest.mark.parametrize("name", list(RUNS))
def test_disabled_run_bitwise_identical(name):
    _, h_off = _run(name)
    obs.enable()
    obs.install_tracer(obs.Tracer())
    _, h_on = _run(name)
    obs.uninstall_tracer()
    obs.disable()
    for key in ("mse", "mse_pop", "metric", "bytes", "coded_bytes", "n_survivors", "n_stale",
                "rho_hat"):
        np.testing.assert_array_equal(np.asarray(getattr(h_off, key), dtype=np.float64),
                                      np.asarray(getattr(h_on, key), dtype=np.float64),
                                      err_msg=f"History.{key} differs ({name})")


# --------------------------------------------------- tracer + ledger parity

def _tracks(tracer):
    names = {e["tid"]: e["args"]["name"] for e in tracer.events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    out = {}
    for e in tracer.events:
        if e["ph"] == "X":
            out.setdefault(names[e["tid"]], []).append(e)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_trace_covers_every_phase_and_bytes_match_ledger(name):
    obs.enable()
    tracer = obs.install_tracer(obs.Tracer())
    _, hist = _run(name)
    obs.uninstall_tracer()
    tracks = _tracks(tracer)
    assert set(obs.PHASES) <= set(tracks), set(obs.PHASES) - set(tracks)
    assert len(tracks["round"]) == N_ROUNDS
    for phase in obs.PHASES:
        assert {e["args"]["round"] for e in tracks[phase]} == set(range(N_ROUNDS)), phase
    # THE invariant: the trace's byte annotations sum exactly to the ledger,
    # and ride only on the two wire-crossing tracks
    traced = sum(e["args"]["bytes"] for evs in tracks.values() for e in evs
                 if "bytes" in e["args"])
    assert traced == hist.total_bytes
    for track, evs in tracks.items():
        if track not in ("client_encode", "stale_admission"):
            assert not any("bytes" in e["args"] for e in evs), track
    coded = sum(e["args"]["bytes_coded"] for e in tracks["round"])
    assert coded == hist.total_coded_bytes
    if name == "async":
        assert sum(hist.n_stale) > 0 and hist.total_stale_bytes > 0


def test_trace_json_passes_trace_report(tmp_path):
    obs.enable()
    tracer = obs.install_tracer(obs.Tracer())
    _, hist = _run("async")
    obs.uninstall_tracer()
    tracer.set_meta("n_rounds", N_ROUNDS)
    tracer.set_meta("ledger_total_bytes", hist.total_bytes)
    tracer.set_meta("ledger_coded_bytes", hist.total_coded_bytes)
    path = tmp_path / "trace.json"
    tracer.write(str(path))
    doc = json.loads(path.read_text())
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    assert all(e["ph"] in ("X", "M", "C") for e in doc["traceEvents"])
    assert doc["displayTimeUnit"] == "ms"
    assert _trace_report().report(doc) == []
    assert _trace_report().PHASES == obs.PHASES


def test_history_round_records():
    _, hist = _run("sync")
    recs = hist.round_records()
    assert len(recs) == N_ROUNDS and recs[0]["round"] == 0
    assert recs[2]["bytes"] == hist.bytes[2] and recs[3]["mse"] == hist.mse[3]


def test_profiler_session_passes_through_or_names_roadmap(tmp_path):
    """None passes through and writes nothing; a directory gets one Chrome
    trace of the block's host activities (the card's too, on a card)."""
    with obs.profiler_session(None):
        pass
    with obs.profiler_session(str(tmp_path / "prof"), "cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {ev.get("name") for ev in json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::mm" in names


def test_kernel_telemetry_matches_jax_on_one_round():
    """One tiny Rand-Proj-Spatial round per draw mode, recorded in both
    packages (JAX eagerly, as its own telemetry test runs it): the decode
    route and every CG iteration count equal JAX's (the draws are JAX's);
    the dispatch labels cover the same ops on the plain route (JAX's
    ``oracle``). The port counts each call, where JAX counts a traced
    program once: one encode a client, and one fused CG step a launched
    iteration (JAX traces its CG's ``srht_gram_apply`` once)."""
    import jax
    import jax.numpy as jnp

    from repro import obs as jobs
    from repro.core import codec as jcodec

    n, c, k = 4, 3, 8
    xs = np.random.default_rng(0).standard_normal((n, c, D)).astype(np.float32)
    # XLA's costly optimisation passes change no float semantics; each op runs once
    was = jax.config.read("jax_disable_most_optimizations")
    for shared in (True, False):
        snaps = []
        for pkg_obs, pkg_codec, key, x in ((jobs, jcodec, jax.random.key(3), jnp.asarray(xs)),
                                           (obs, codec, 3, torch.from_numpy(xs))):
            pkg_obs.reset()
            pkg_obs.enable()
            jax.config.update("jax_disable_most_optimizations", True)
            try:
                pipe = pkg_codec.Pipeline([pkg_codec.RandProjSpatial(
                    k=k, d_block=D, transform="avg", shared_randomness=shared)])
                payloads, _ = pipe.encode_all(key, x)
                pipe.decode(key, payloads, n)
                snaps.append(pkg_obs.snapshot())
            finally:
                jax.config.update("jax_disable_most_optimizations", was)
                pkg_obs.disable()
                pkg_obs.reset()
        want, got = snaps
        routes = {name: v for name, v in got["counters"].items() if "decode_route" in name}
        assert routes == {name: v for name, v in want["counters"].items()
                          if "decode_route" in name} == {
            "kernels/decode_route{estimator=rand_proj_spatial,method=fused}": 1.0}
        cg = got["histograms"]["kernels/cg_iters"]
        assert cg == want["histograms"]["kernels/cg_iters"] and cg["count"] == 1
        encode = "srht_encode" if shared else "srht_encode_batch"
        assert {name: v for name, v in got["counters"].items() if "dispatch" in name} == {
            f"kernels/dispatch{{op={encode},route=plain}}": float(n),
            "kernels/dispatch{op=srht_decode_sum,route=plain}": 1.0,
            "kernels/dispatch{op=srht_cg_step,route=plain}": float(-(-cg["sum"] // 8) * 8)}
        assert {name for name in want["counters"] if "dispatch" in name} == {
            f"kernels/dispatch{{op={encode},route=oracle}}",
            "kernels/dispatch{op=srht_decode_sum,route=oracle}",
            "kernels/dispatch{op=srht_gram_apply,route=oracle}"}


def test_cli_profile_dir_writes_trace_and_telemetry(tmp_path):
    """``fl.run --profile-dir`` on the CPU: one trace file in the directory,
    and ``--metrics-json`` with the kernel telemetry of every round."""
    metrics, prof = tmp_path / "metrics.json", tmp_path / "prof"
    assert run_cli.main(["--device", "cpu", "--task", "dme", "--clients", "4",
                         "--rounds", "2", "--k", "8", "--d-block", str(D), "--dim", str(2 * D),
                         "--profile-dir", str(prof), "--metrics-json", str(metrics)]) == 0
    assert len(list(prof.glob("*.pt.trace.json"))) == 1
    snap = json.loads(metrics.read_text())["runs"][0]["metrics"]
    counters = snap["counters"]
    assert counters["kernels/decode_route{estimator=rand_proj_spatial,method=fused}"] == 2
    assert counters["kernels/dispatch{op=srht_encode,route=plain}"] == 8
    assert snap["histograms"]["kernels/cg_iters"]["count"] == 2


# ------------------------------------------- --compare metrics export (CLI)

def test_compare_metrics_json_and_trace_are_per_run(tmp_path, capsys):
    """--compare with --metrics-json and --trace: one entry per compared
    run, each with ITS OWN counters and round records (schema v2), and a
    trace file that tools/trace_report.py accepts."""
    metrics, trace = tmp_path / "metrics.json", tmp_path / "trace.json"
    assert run_cli.main(["--device", "cpu", "--task", "dme", "--compare", "--smoke",
                         "--clients", "4", "--metrics-json", str(metrics),
                         "--trace", str(trace)]) == 0
    data = json.loads(metrics.read_text())
    assert data["schema_version"] == 2
    labels = [r["estimator"] for r in data["runs"]]
    assert labels == ["rand_k", "rand_k_spatial", "rand_proj_spatial", "sparse_proj"]
    assert data["run"]["estimators"] == labels and data["run"]["n_rounds"] == 12
    assert data["run"]["torch_version"] == torch.__version__
    for entry in data["runs"]:
        assert len(entry["rounds"]) == 3
        encodes = [v for k, v in entry["metrics"]["counters"].items() if "client_encode" in k]
        assert encodes and sum(encodes) == 3.0, entry["metrics"]["counters"]
    doc = json.loads(trace.read_text())
    assert _trace_report().report(doc) == []
    assert doc["metadata"]["ledger_total_bytes"] == sum(
        r["bytes"] for entry in data["runs"] for r in entry["rounds"])
    assert "MSE at equal bytes" in capsys.readouterr().out
