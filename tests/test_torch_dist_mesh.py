"""The mesh route of the port's dist/ on torch.distributed (gloo, CPU).

- World size 1, in-process (a gloo group of this process alone): the
  shard_map route synchronous, owner-routed and owner-routed with overlap,
  and the GSPMD route, bitwise the local route (the twin of
  tests/test_ownership.py's one-device test), ``info``'s intra-pod columns,
  ``psum_scatter_mean``.
- Four ranks, spawned once for the file (tests/torch_dist_ranks.py; the
  ranks import no JAX), 8 clients, 2 a rank: every estimator of
  tests/test_ownership.py's four-shard subprocess on the shard_map route,
  with and without ownership, bitwise the port's local route on every rank
  and within the seeded parity tolerance (tests/test_torch_seeded.py:
  relative L2 1e-5) of the JAX package's local route; error feedback with
  participants, ownership and overlap (the residual rows bitwise); ragged
  chunk grids (7 chunks, and 3 chunks on 4 owners); the ``beta_trials=8``
  regime at rtol 1e-4 / atol 1e-5, where the owner route receives fewer
  bytes; ``psum_scatter_mean`` at C = 3, 4, 8 (JAX's rtol 1e-5 / atol
  1e-6); ``run_rounds`` on gspmd and shard_map, with and without
  ownership, and with error feedback and per-client temporal memories,
  bitwise the local backend (History and client state); two DME training
  steps with error feedback bitwise the mesh-less steps; two client axes
  flattened into one group.
- Two ranks, spawned once: the GSPMD route with 5 clients (shares of 3 and
  2), training steps whose 3 clients do not divide over the ranks, and
  ``restore(shardings=)`` onto a ``model`` axis over them (DTensors whose
  ``full_tensor()`` is the plain restore).

The JAX package's own mesh tests fail on jax 0.9.0 (ROADMAP "Known"), so
the JAX side here is its local route, which its own tests hold equal to
its mesh routes; one program, compiled without XLA's costly passes.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks as R
from repro.core import codec as jcodec
from repro.dist import collectives as jcoll
from repro_torch.core import codec
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding

MEAN_RTOL = 1e-5          # tests/test_torch_seeded.py
BETA8_RTOL, BETA8_ATOL = 1e-4, 1e-5
PSUM_RTOL, PSUM_ATOL = 1e-5, 1e-6


def _flat(tree) -> torch.Tensor:
    return R._mean(tree)


def _local(spec, t, **kw):
    m, info, ef = coll.compressed_mean_tree(spec, R.KEY, t, device="cpu", **kw)
    return {"mean": _flat(m), "info": info, "ef": ef}


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


# --------------------------------------------------------------- world size 1


@pytest.fixture(scope="module")
def mesh1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield sharding.make_mesh((1,), ("pod",), device="cpu")
    finally:
        dist.destroy_process_group()


ONE_RANK_ROUTES = {
    "shard_map": ("shard_map", {}),
    "shard_map_owners": ("shard_map", {"ownership": True}),
    "shard_map_owners_overlap": ("shard_map", {"ownership": True, "overlap": True,
                                               "overlap_tile": 2}),
    "gspmd": ("gspmd", {}),
    "gspmd_owners_overlap": ("gspmd", {"ownership": True, "overlap": True, "overlap_tile": 2}),
}


@pytest.mark.parametrize("route", list(ONE_RANK_ROUTES))
def test_one_rank_routes_are_the_local_route(mesh1, route):
    entry, kw = ONE_RANK_ROUTES[route]
    t = R.tree(6)
    spec = codec.RandProjSpatial(k=16, d_block=128)
    want = _local(spec, t)
    got = (R._shardmap if entry == "shard_map" else R._gspmd)(spec, t, mesh1, **kw)
    assert torch.equal(got["mean"], want["mean"])
    assert got["info"]["n_shards"] == 1 and got["info"]["bytes_sent"] == want["info"]["bytes_sent"]


def test_one_rank_info_columns(mesh1):
    t = R.tree(6)
    spec = codec.RandK(k=16, d_block=128)
    for got in (R._shardmap(spec, t, mesh1, ownership=True), R._gspmd(spec, t, mesh1)):
        info = got["info"]
        for k in ("n_shards", "intra_pod_bytes", "intra_pod_bytes_allgather",
                  "intra_pod_bytes_ownership"):
            assert k in info
        assert info["n_shards"] == 1 and info["intra_pod_bytes"] == 0


def test_one_rank_psum_scatter_mean_and_refusals(mesh1):
    tiles = R.psum_tiles(5)[:1]
    got = coll.psum_scatter_mean(tiles, [3.0], mesh1)
    np.testing.assert_allclose(got.numpy(), tiles[0].numpy(), rtol=PSUM_RTOL, atol=PSUM_ATOL)
    with pytest.raises(ValueError, match="tiles must be"):
        coll.psum_scatter_mean(R.psum_tiles(5), [3.0], mesh1)
    with pytest.raises(ValueError, match="owners but the mesh"):
        R._shardmap(codec.RandK(k=16, d_block=128), R.tree(2), mesh1, ownership=2)
    with pytest.raises(ValueError, match="none of the client axes"):
        R._shardmap(codec.RandK(k=16, d_block=128), R.tree(2), mesh1, client_axes=("data",))


# ------------------------------------------------------------- JAX's side


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


JAX_SPECS = {
    "rand_proj_spatial": lambda: jcodec.RandProjSpatial(k=16, d_block=128, use_pallas="never"),
    "rand_k_per_chunk": lambda: jcodec.RandK(k=16, d_block=128, shared_randomness=False),
    "wangni": lambda: jcodec.Wangni(k=16, d_block=128, capacity=8.0),
    "induced": lambda: jcodec.Induced(k=16, d_block=128),
    "identity": lambda: jcodec.Identity(d_block=128),
    "rand_k_int8": lambda: jcodec.Pipeline([jcodec.RandK(k=16, d_block=128),
                                            jcodec.Int8Quant()]),
    "beta8": lambda: jcodec.RandProjSpatial(k=64, d_block=128, beta_trials=8,
                                            use_pallas="never"),
}


def _jflat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(leaf).reshape(-1) for leaf in jax.tree.leaves(
        {k: tree[k] for k in sorted(tree)})])


@pytest.fixture(scope="module")
def jax_means():
    """The JAX package's local-route means, as one compiled program."""
    key = jax.random.key(R.KEY)
    trees = {"tree": R.tree(), "big": R.big_tree()}
    args = {name: {k: jnp.asarray(v.numpy()) for k, v in t.items()} for name, t in trees.items()}

    def everything(args):
        return {name: jcoll.compressed_mean_tree(make(), key,
                                                 args["big" if name == "beta8" else "tree"])[0]
                for name, make in JAX_SPECS.items()}

    with _cheap_compiles():
        out = jax.tree.map(np.asarray, jax.jit(everything)(args))
    return {name: _jflat(m) for name, m in out.items()}


# --------------------------------------------------------------- four ranks


@pytest.fixture(scope="module")
def local4():
    """The port's local route and backends on the ranks' inputs; built
    before the spawn, so the ranks read the eigenvalue banks from disk."""
    full, pipe = R.tree(), R.ef_pipe()
    out = {name: _local(make(), full) for name, make in R.SPECS.items()}
    out["ef/participants"] = _local(pipe, full, participants=R.PARTICIPANTS)
    out["ef/all"] = _local(pipe, full)
    out["ef/second"] = _local(pipe, full, ef_chunks=out["ef/participants"]["ef"])
    for name, (_, d_block) in R.RAGGED.items():
        grid = R.ragged_tree(name)
        out[name] = _local(codec.RandProjSpatial(k=8, d_block=d_block), grid)
        out[f"{name}/ef"] = _local(R.ef_pipe(8, d_block), grid, participants=R.PARTICIPANTS)
    out["beta8"] = _local(codec.RandProjSpatial(k=64, d_block=128, beta_trials=8), R.big_tree())
    for case in R.ROUND_CASES:
        out[f"rounds/{case}"] = R.history(R.rounds(case, "local"))
    out["train"] = R.train()
    return out


@pytest.fixture(scope="module")
def four(local4, tmp_path_factory):
    return R.run_ranks("four_ranks", 4, tmp_path_factory.mktemp("four_ranks"))


def _same_on_every_rank(four, name, field="mean"):
    for r in range(1, 4):
        assert torch.equal(four[r][name][field], four[0][name][field]), (name, r)


def _gathered_ef(four, name) -> torch.Tensor:
    """The shard_map route's residual rows of every rank, in client order."""
    return torch.cat([four[r][name]["ef"] for r in range(4)])


def test_ranks_import_no_jax(four):
    assert [four[r]["imported"] for r in range(4)] == [[]] * 4


SPEC_ROUTES = [(name, route) for name in R.SPECS for route in ("shard_map", "shard_map_owners")]
SPEC_ROUTES += [("rand_proj_spatial", "gspmd"), ("rand_proj_spatial", "gspmd_owners")]


@pytest.mark.parametrize("name,route", SPEC_ROUTES)
def test_four_ranks_mean_is_the_local_route(four, local4, jax_means, name, route):
    key = f"{name}/{route}"
    _same_on_every_rank(four, key)
    got, want = four[0][key], local4[name]
    assert torch.equal(got["mean"], want["mean"])
    assert _rel(got["mean"], jax_means[name]) <= MEAN_RTOL
    assert got["info"]["n_shards"] == 4
    for k in ("n_clients", "n_total", "n_chunks", "d_flat", "full_bytes",
              "payload_bytes_per_client", "bytes_sent"):
        assert got["info"][k] == want["info"][k], k
    want_traffic = coll.intra_pod_traffic(codec.as_pipeline(R.SPECS[name]()), R.N_CLIENTS,
                                          want["info"]["n_chunks"], 4,
                                          plan=None if "owners" not in route else
                                          sharding.chunk_ownership(want["info"]["n_chunks"], 4))
    assert {k: got["info"][k] for k in want_traffic} == want_traffic


EF_CASES = {  # rank result -> (local reference, rows: the shard_map route's own)
    "ef/shard_map_participants": ("ef/participants", "local"),
    "ef/shard_map_participants_owners": ("ef/participants", "local"),
    "ef/shard_map_owners_second": ("ef/second", "local"),
    "ef/shard_map_owners_overlap": ("ef/all", "local"),
    "ef/gspmd_participants_owners_overlap": ("ef/participants", "full"),
}


@pytest.mark.parametrize("name", list(EF_CASES))
def test_four_ranks_error_feedback_rows(four, local4, name):
    ref, rows = EF_CASES[name]
    _same_on_every_rank(four, name)
    assert torch.equal(four[0][name]["mean"], local4[ref]["mean"])
    if rows == "local":
        assert torch.equal(_gathered_ef(four, name), local4[ref]["ef"])
    else:
        _same_on_every_rank(four, name, "ef")
        assert torch.equal(four[0][name]["ef"], local4[ref]["ef"])


@pytest.mark.parametrize("grid", list(R.RAGGED))
@pytest.mark.parametrize("route", ["owners", "owners_overlap", "ef_participants_owners_overlap"])
def test_four_ranks_ragged_chunk_grid(four, local4, grid, route):
    key = f"{grid}/{route}"
    _same_on_every_rank(four, key)
    ref = local4[f"{grid}/ef" if route.startswith("ef") else grid]
    assert torch.equal(four[0][key]["mean"], ref["mean"])
    if route.startswith("ef"):
        assert torch.equal(_gathered_ef(four, key), ref["ef"])


def test_four_ranks_beta8_regime(four, local4, jax_means):
    """n k payload bytes a chunk above d's: the owner route receives fewer
    intra-pod bytes, and says so."""
    for route in ("shard_map", "shard_map_owners"):
        got = four[0][f"beta8/{route}"]
        _same_on_every_rank(four, f"beta8/{route}")
        np.testing.assert_allclose(got["mean"].numpy(), local4["beta8"]["mean"].numpy(),
                                   rtol=BETA8_RTOL, atol=BETA8_ATOL)
        np.testing.assert_allclose(got["mean"].numpy(), jax_means["beta8"],
                                   rtol=BETA8_RTOL, atol=BETA8_ATOL)
    info = four[0]["beta8/shard_map_owners"]["info"]
    assert info["intra_pod_bytes"] == info["intra_pod_bytes_ownership"]
    assert info["intra_pod_bytes_ownership"] < info["intra_pod_bytes_allgather"]


@pytest.mark.parametrize("n_chunks", R.PSUM_CHUNKS)
def test_four_ranks_psum_scatter_mean(four, n_chunks):
    tiles = R.psum_tiles(n_chunks).numpy()
    want = np.einsum("p,pcd->cd", np.asarray(R.PSUM_COUNTS), tiles) / sum(R.PSUM_COUNTS)
    for r in range(4):
        got = four[r][f"psum/{n_chunks}"]
        assert got.shape == (n_chunks, 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=PSUM_RTOL, atol=PSUM_ATOL)


ROUND_RUNS = [(case, backend) for case, (_, _, backends) in R.ROUND_CASES.items()
              for backend in backends]


@pytest.mark.parametrize("case,backend", ROUND_RUNS)
def test_four_ranks_rounds_are_the_local_backend(four, local4, case, backend):
    want = local4[f"rounds/{case}"]
    for r in range(4):
        got = four[r][f"rounds/{case}/{backend}"]
        for k in ("mse", "mse_pop", "bytes", "coded_bytes", "n_survivors"):
            assert got[k] == want[k], (k, r)
        if want["state"] is not None:
            for k, v in want["state"].items():
                assert (v is None and got["state"][k] is None) or torch.equal(got["state"][k], v)
    # the mesh routes ledger their modelled intra-pod traffic at 4 shards
    assert all(b > 0 for b in four[0][f"rounds/{case}/{backend}"]["intra_pod_bytes"])


def test_four_ranks_train_steps_are_the_meshless_steps(four, local4):
    want = local4["train"]
    for r in range(4):
        got = four[r]["train/shard_map"]
        assert all(torch.equal(a, b) for a, b in zip(got["params"], want["params"]))
        assert got["metrics"].keys() == want["metrics"].keys()
        for k, v in want["metrics"].items():
            assert torch.equal(got["metrics"][k], torch.as_tensor(v)), k
    assert torch.equal(torch.cat([four[r]["train/shard_map"]["ef"] for r in range(4)]),
                       want["ef"])


def test_four_ranks_two_client_axes(four, local4):
    for route in ("shard_map", "shard_map_owners"):
        _same_on_every_rank(four, f"two_axes/{route}")
        assert torch.equal(four[0][f"two_axes/{route}"]["mean"],
                           local4["rand_proj_spatial"]["mean"])
        assert four[0][f"two_axes/{route}"]["info"]["n_shards"] == 4




# ---------------------------------------------------------------- two ranks


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    t, spec = R.tree(5), codec.RandProjSpatial(k=16, d_block=128)
    local = {"gspmd": _local(spec, t), "gspmd_owners": _local(spec, t),
             "gspmd_ef": _local(R.ef_pipe(), t, participants=[0, 1, 3, 4]),
             "train_auto": R.train(n_clients=3)}
    return local, R.run_ranks("two_ranks", 2, tmp_path_factory.mktemp("two_ranks"))


@pytest.mark.parametrize("name", ["gspmd", "gspmd_owners", "gspmd_ef"])
def test_two_ranks_gspmd_uneven_shares(two, name):
    local, ranks = two
    for r in range(2):
        got = ranks[r][name]
        assert torch.equal(got["mean"], local[name]["mean"])
        assert got["info"]["n_shards"] == 2 and got["info"]["n_total"] == 5
        if local[name]["ef"] is not None:
            assert torch.equal(got["ef"], local[name]["ef"])


def test_two_ranks_train_auto_takes_gspmd(two):
    local, ranks = two
    want = local["train_auto"]
    for r in range(2):
        got = ranks[r]["train_auto"]
        assert all(torch.equal(a, b) for a, b in zip(got["params"], want["params"]))
        assert torch.equal(got["ef"], want["ef"])
        for k, v in want["metrics"].items():
            assert torch.equal(got["metrics"][k], v), k


def test_two_ranks_restore_onto_a_mesh(two):
    for r in range(2):
        got = two[1][r]["restore"]
        assert got["step"] == 1 and all(got["bitwise"]) and len(got["bitwise"]) == got["leaves"]
        assert got["sharded"] > 0
        assert got["local_is_shard_tree"]  # the placed steps' shards
