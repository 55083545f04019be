"""The port's compressed_mean_tree against the JAX package's.

A three-leaf dict tree, inserted out of sorted key order and with leaf sizes
that leave a ragged last chunk, goes through both packages with the JAX
draws and bank carried across: the mean tree agrees to relative L2 <= 1e-4
leaf by leaf and every byte field of ``info`` is equal, with all clients and
with a subset of participants.

The overlapped stream and the chunk-ownership decode: ``ownership_plan``
(divisible, ragged, more shards than chunks), ``stream_tiles`` and
``intra_pod_traffic`` equal JAX's exactly; ``sharded_decode`` and
``streamed_mean`` on JAX's shared draws (and bank) agree with JAX's within
1e-5 and are bitwise equal to the port's own synchronous decode; the
refusals keep JAX's wording. The local route derives a round's maps once
for its encode, decode and self-decode, with the bits each derives alone.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.flatten_util import ravel_pytree

from repro.core import beta as jbeta
from repro.core import codec as jcodec
from repro.core.estimators import rand_k as jrk
from repro.core.estimators import rand_proj_spatial as jrps
from repro.dist import collectives as jcoll
from repro.dist import sharding as jshard
from repro_torch import interop
from repro_torch.core import chunking
from repro_torch.core import codec as tcodec
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import sharding as tshard

D_BLOCK, K, TRIALS = 64, 8, 64
SHAPES = {"w": (10, 30), "b": (17,), "a": (5, 3)}  # 332 values: 6 chunks, the last ragged


def _tree(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    common = {name: rng.standard_normal(shape) for name, shape in SHAPES.items()}
    return {name: (common[name][None] + 0.5 * rng.standard_normal((n,) + shape)).astype(np.float32)
            for name, shape in SHAPES.items()}


def test_flatten_order_is_ravel_pytree():
    tree = {"z": np.arange(3.0, dtype=np.float32), "a": {"y": np.ones((2, 2), np.float32),
                                                          "b": [np.full(2, 7.0, np.float32)]}}
    flat, unravel = chunking.flatten_tree(interop.tree_from_numpy(tree, "cpu"))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ravel_pytree(tree)[0]))
    back = unravel(flat)
    assert list(back) == ["z", "a"] and list(back["a"]) == ["y", "b"]
    np.testing.assert_array_equal(back["a"]["b"][0].numpy(), tree["a"]["b"][0])


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


# four reporting clients either way, so both cases decode with one bank
CASES = {"all": (4, None), "participants": (5, [0, 2, 3, 4])}
KEY_SEED = 7


def _jspec():
    return jcodec.RandProjSpatial(use_pallas="never", k=K, d_block=D_BLOCK, transform="avg",
                                  beta_trials=TRIALS)


@functools.cache
def _jax_side() -> dict:
    """Per case: the client tree, and JAX's mean tree, info and draws, from
    ONE compiled program for both cases."""
    trees = {case: _tree(1, n_total) for case, (n_total, _) in CASES.items()}
    n_chunks = -(-sum(int(np.prod(s)) for s in SHAPES.values()) // D_BLOCK)

    def everything(trees):
        key = jax.random.key(KEY_SEED)
        out = {}
        for case, (n_total, participants) in CASES.items():
            ids = None if participants is None else jnp.asarray(participants)
            n = n_total if participants is None else len(participants)
            mean, info, _ = jcoll.compressed_mean_tree(_jspec(), key, trees[case],
                                                       participants=participants)
            out[case] = {"mean": mean, "info": info,
                         "draws": jrps._fused_draws(_jspec(), key, n, n_chunks, ids, 0)}
        return out

    args = {case: {k: jnp.asarray(v) for k, v in t.items()} for case, t in trees.items()}
    with _cheap_compiles():
        out = jax.tree.map(np.asarray, jax.jit(everything)(args))
        bank = jbeta.srht_eig_bank(4, K, D_BLOCK, TRIALS)
    for case in CASES:
        out[case].update(tree=trees[case], bank=bank)
        assert int(out[case]["info"]["n_chunks"]) == n_chunks
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_compressed_mean_tree_matches_jax(case):
    n_total, participants = CASES[case]
    jax_side = _jax_side()[case]
    tree, jmean, jinfo = jax_side["tree"], jax_side["mean"], jax_side["info"]
    n = n_total if participants is None else len(participants)
    tmean, tinfo, ef = tcoll.compressed_mean_tree(
        tcodec.RandProjSpatial(k=K, d_block=D_BLOCK, transform="avg", beta_trials=TRIALS), 0,
        interop.tree_from_numpy(tree, "cpu"), participants=participants, device="cpu",
        draws=interop.draws_from_numpy(jax_side["draws"], "cpu"),
        bank=interop.bank_from_numpy(jax_side["bank"]),
    )
    assert ef is None
    assert list(tmean) == list(tree)
    for name in SHAPES:
        want = np.asarray(jmean[name], np.float64)
        got = tmean[name].double().numpy()
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4
    assert tinfo == {k: int(v) for k, v in jinfo.items()}
    assert tinfo["n_clients"] == n and tinfo["n_total"] == n_total


def test_unported_routes_raise():
    """The route once refused here (``shardings=``, ROADMAP A.9) runs: on a
    one-rank gloo mesh it is the local route, bitwise."""
    tree = interop.tree_from_numpy(_tree(2, 4), "cpu")
    spec = tcodec.RandProjSpatial(k=K, d_block=D_BLOCK)
    want, _, _ = tcoll.compressed_mean_tree(spec, 0, tree, device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = tshard.make_mesh((1,), ("pod",), device="cpu")
        got, info, _ = tcoll.compressed_mean_tree(spec, 0, tree, device="cpu",
                                                  shardings=tcoll.dme_shardings(mesh))
    finally:
        dist.destroy_process_group()
    assert info["n_shards"] == 1
    assert all(torch.equal(got[name], want[name]) for name in SHAPES)


# ------------------------------------------- the stream and the owner decode

PLANS = {"divisible": (12, 4), "ragged": (7, 3), "more_shards": (2, 4), "one": (5, 1)}


def _plan_facts(mod_shard, mod_coll, n_chunks, n_shards):
    plan = mod_shard.chunk_ownership(n_chunks, n_shards)
    return {
        "geometry": (plan.chunks_per_owner, plan.padded_chunks, plan.pad, plan.slices),
        "owners": [plan.owner_of(c) for c in range(n_chunks)],
        "tiles": [mod_coll.stream_tiles(n_chunks, tile, own)
                  for tile in (1, 2, 3, n_chunks + 5) for own in (None, plan)],
        "via_ownership_plan": [mod_coll.ownership_plan(arg, n_chunks, n_shards)
                               for arg in (None, False, True, 2, plan)],
    }


@pytest.mark.parametrize("case", list(PLANS))
def test_ownership_plan_and_tiles_match_jax(case):
    n_chunks, n_shards = PLANS[case]
    got = _plan_facts(tshard, tcoll, n_chunks, n_shards)
    want = _plan_facts(jshard, jcoll, n_chunks, n_shards)
    assert got["geometry"] == want["geometry"] and got["owners"] == want["owners"]
    assert got["tiles"] == want["tiles"]
    as_pair = [None if p is None else (p.n_chunks, p.n_shards) for p in got["via_ownership_plan"]]
    assert as_pair == [None if p is None else (p.n_chunks, p.n_shards)
                       for p in want["via_ownership_plan"]]
    covered = [c for lo, hi in got["geometry"][3] for c in range(lo, hi)]
    assert covered == list(range(n_chunks))


def _plan_errors(mod_shard, mod_coll) -> list:
    out = []
    for call in (lambda: mod_shard.ChunkOwnership(n_chunks=0, n_shards=2),
                 lambda: mod_shard.ChunkOwnership(n_chunks=4, n_shards=0),
                 lambda: mod_shard.chunk_ownership(4, 2).owner_of(4),
                 lambda: mod_shard.chunk_ownership(4, 2).slice_for(2),
                 lambda: mod_coll.stream_tiles(7, 0),
                 lambda: mod_coll.ownership_plan(mod_shard.chunk_ownership(6, 2), 7, 1)):
        with pytest.raises(ValueError) as ei:
            call()
        out.append(str(ei.value))
    return out


def test_plan_refusals_keep_jax_wording():
    assert _plan_errors(tshard, tcoll) == _plan_errors(jshard, jcoll)


TRAFFIC_SPECS = {
    "rand_k": lambda m: m.RandK(k=K, d_block=D_BLOCK),
    "rand_proj_spatial_int8": lambda m: m.Pipeline([m.RandProjSpatial(k=K, d_block=D_BLOCK),
                                                    m.Int8Quant()]),
    "top_k": lambda m: m.TopK(k=K, d_block=D_BLOCK),
    "identity": lambda m: m.Identity(d_block=D_BLOCK),
}


@pytest.mark.parametrize("name", list(TRAFFIC_SPECS))
def test_intra_pod_traffic_matches_jax_exactly(name):
    tp, jp = (m.as_pipeline(TRAFFIC_SPECS[name](m)) for m in (tcodec, jcodec))
    for n, n_chunks, n_shards in ((8, 12, 1), (8, 12, 4), (6, 7, 3), (5, 2, 4), (4, 126, 4)):
        plan_t = tshard.chunk_ownership(n_chunks, n_shards)
        plan_j = jshard.chunk_ownership(n_chunks, n_shards)
        for pt, pj in ((None, None), (plan_t, plan_j)):
            got = tcoll.intra_pod_traffic(tp, n, n_chunks, n_shards, plan=pt)
            want = jcoll.intra_pod_traffic(jp, n, n_chunks, n_shards, plan=pj)
            assert got == want and all(type(v) is int for v in got.values())
            assert tcoll.intra_pod_reduction(got) == jcoll.intra_pod_reduction(want)


STREAM_N, STREAM_C, STREAM_PLAN, STREAM_TILE = 4, 7, (7, 3), 2
STREAM_SPECS = {
    "rand_proj_spatial": lambda m, **kw: m.RandProjSpatial(k=K, d_block=D_BLOCK, transform="avg",
                                                           beta_trials=TRIALS, **kw),
    "rand_k": lambda m, **kw: m.RandK(k=K, d_block=D_BLOCK),
}


@functools.cache
def _jax_stream_side() -> dict:
    """JAX's sharded and streamed decodes of one (n, C, d) input, and its
    shared draws, from ONE compiled program."""
    rng = np.random.default_rng(8)
    common = rng.standard_normal((STREAM_C, D_BLOCK))
    xs = (common[None] + 0.5 * rng.standard_normal((STREAM_N,) + common.shape)).astype(
        np.float32)
    plan = jshard.chunk_ownership(*STREAM_PLAN)

    def everything(x):
        key = jax.random.key(KEY_SEED)
        out = {}
        for name, make in STREAM_SPECS.items():
            spec = make(jcodec, use_pallas="never") if name == "rand_proj_spatial" else \
                make(jcodec)
            pipe = jcodec.as_pipeline(spec)
            payloads, _ = pipe.encode_all(key, x)
            if name == "rand_k":
                draws = {"rows": jnp.stack([jrk._indices(spec, key, i, STREAM_C)[:1]
                                            for i in range(STREAM_N)])}
            else:
                draws = jrps._fused_draws(spec, key, STREAM_N, STREAM_C, None, 0)
            out[name] = {
                "draws": draws,
                "sync": pipe.decode_payload(key, payloads, STREAM_N),
                "sharded": jcoll.sharded_decode(pipe, key, payloads, STREAM_N, plan),
                "streamed": jcoll.streamed_mean(pipe, key, x, STREAM_N, tile=STREAM_TILE,
                                                ownership=plan)[0],
                "streamed_side": jcoll.streamed_mean(pipe, key, x, STREAM_N, tile=3,
                                                     side_info=x[0])[0],
            }
        return out

    with _cheap_compiles():
        out = jax.tree.map(np.asarray, jax.jit(everything)(jnp.asarray(xs)))
        out["bank"] = jbeta.srht_eig_bank(STREAM_N, K, D_BLOCK, TRIALS)
    out["xs"] = xs
    return out


@pytest.mark.parametrize("name", list(STREAM_SPECS))
def test_sharded_and_streamed_decodes_match_jax(name):
    j = _jax_stream_side()
    pipe = tcodec.as_pipeline(STREAM_SPECS[name](tcodec))
    draws = interop.draws_from_numpy(j[name]["draws"], "cpu")
    bank = interop.bank_from_numpy(j["bank"]) if name == "rand_proj_spatial" else None
    xs = torch.from_numpy(j["xs"])
    plan = tshard.chunk_ownership(*STREAM_PLAN)
    payloads, _ = pipe.encode_all(0, xs, draws=draws)
    sync = pipe.decode_payload(0, payloads, STREAM_N, draws=draws, bank=bank)
    got = {
        "sharded": tcoll.sharded_decode(pipe, 0, payloads, STREAM_N, plan, draws=draws,
                                        bank=bank),
        "streamed": tcoll.streamed_mean(pipe, 0, xs, STREAM_N, tile=STREAM_TILE, ownership=plan,
                                        draws=draws, bank=bank)[0],
    }
    side, _ = tcoll.streamed_mean(pipe, 0, xs, STREAM_N, tile=3, side_info=xs[0], draws=draws,
                                  bank=bank)
    for what, out in got.items():
        assert torch.equal(out, sync), what  # the port's own contract: bitwise
        want = j[name][what]
        assert np.linalg.norm(out.numpy() - want) <= 1e-5 * np.linalg.norm(want), what
    want = j[name]["streamed_side"]
    assert np.linalg.norm(side.numpy() - want) <= 1e-5 * np.linalg.norm(want)


REFUSED_PIPES = {
    "int8": lambda m: m.Pipeline([m.RandK(k=K, d_block=D_BLOCK), m.Int8Quant()]),
    "per_chunk_rand_k": lambda m: m.RandK(k=K, d_block=D_BLOCK, shared_randomness=False),
    "wangni": lambda m: m.Wangni(k=K, d_block=D_BLOCK),
    "rand_k_spatial_est": lambda m: m.RandKSpatial(k=K, d_block=D_BLOCK, r_mode="est"),
    "chunk_budgets": lambda m: m.RandK(k=K, d_block=D_BLOCK, chunk_budgets=(4, 8, 12)),
}


def _refusal_texts(codec_mod, coll_mod, name) -> list:
    pipe = codec_mod.as_pipeline(REFUSED_PIPES[name](codec_mod))
    out = []
    for check in (coll_mod.check_streamable, coll_mod.check_shardable):
        try:
            check(pipe)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("name", list(REFUSED_PIPES))
def test_stream_and_ownership_refusals_keep_jax_wording(name):
    got = _refusal_texts(tcodec, tcoll, name)
    assert got == _refusal_texts(jcodec, jcoll, name)
    assert any(got)
    tree = interop.tree_from_numpy(_tree(2, 4), "cpu")
    spec = REFUSED_PIPES[name](tcodec)
    if name != "chunk_budgets":  # its payload layout needs the tree's own C
        for kw, text in (({"overlap": True}, got[0]), ({"ownership": 2}, got[1])):
            if text is not None:
                with pytest.raises(ValueError) as ei:
                    tcoll.compressed_mean_tree(spec, 0, tree, device="cpu", **kw)
                assert str(ei.value) == text


SHARED_DRAW_SPECS = {
    "srht_per_chunk": lambda c: c.RandProjSpatial(k=K, d_block=D_BLOCK, transform="avg",
                                                  shared_randomness=False),
    "srht_shared": lambda c: c.RandProjSpatial(k=K, d_block=D_BLOCK, transform="avg"),
    "rand_k_spatial": lambda c: c.RandKSpatial(k=K, d_block=D_BLOCK, transform="avg",
                                               shared_randomness=False),
    "sparse_proj_ef": lambda c: c.Pipeline([c.SparseProj(k=K, d_block=D_BLOCK, s=4,
                                                         shared_randomness=False),
                                            c.ErrorFeedback()]),
}


@pytest.mark.parametrize("name", list(SHARED_DRAW_SPECS))
def test_local_round_makes_its_draws_once(monkeypatch, name):
    """The local route derives each client's maps once a round and hands
    them to the encode, the decode and the self-decode; the result is the
    one each of them gets deriving its own."""
    from repro_torch.core import random as prand

    spec = SHARED_DRAW_SPECS[name](tcodec)
    pipe = tcodec.as_pipeline(spec)
    tree = interop.tree_from_numpy(_tree(3, 3), "cpu")
    chunks = torch.stack([chunking.flatten_tree({n: v[i] for n, v in tree.items()})[0]
                          for i in range(3)])
    c = -(-chunks.shape[1] // D_BLOCK)
    xs = torch.nn.functional.pad(chunks, (0, c * D_BLOCK - chunks.shape[1])).reshape(3, c, D_BLOCK)
    payloads, _ = pipe.encode_all(5, xs)
    want = pipe.decode_payload(5, payloads, 3)
    drawn = []
    for fn in ("srht_draw", "sparse_draw", "subset"):
        def counted(keys, *a, _fn=getattr(prand, fn), **kw):
            drawn.append(keys.shape[:-1].numel())
            return _fn(keys, *a, **kw)
        monkeypatch.setattr(prand, fn, counted)
    got, _, _ = tcoll.compressed_mean_tree(spec, 5, tree, device="cpu")
    maps = 3 * (1 if pipe.sparsifier.shared_randomness else c)
    assert sum(drawn) == maps
    flat = chunking.flatten_tree(got)[0]
    assert torch.equal(flat, want.reshape(-1)[:flat.numel()])
