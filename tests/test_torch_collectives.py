"""The port's compressed_mean_tree against the JAX package's.

A three-leaf dict tree, inserted out of sorted key order and with leaf sizes
that leave a ragged last chunk, goes through both packages with the JAX
draws and bank carried across: the mean tree agrees to relative L2 <= 1e-4
leaf by leaf and every byte field of ``info`` is equal, with all clients and
with a subset of participants.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import beta as jbeta
from repro.core import codec as jcodec
from repro.core.estimators import rand_proj_spatial as jrps
from repro.dist import collectives as jcoll
from repro_torch import interop
from repro_torch.core import chunking
from repro_torch.core import codec as tcodec
from repro_torch.dist import collectives as tcoll

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
    tree = interop.tree_from_numpy(_tree(2, 4), "cpu")
    spec = tcodec.RandProjSpatial(k=K, d_block=D_BLOCK)
    for kw in ({"overlap": True}, {"ownership": 2}):
        with pytest.raises(NotImplementedError):
            tcoll.compressed_mean_tree(spec, 0, tree, device="cpu", **kw)
