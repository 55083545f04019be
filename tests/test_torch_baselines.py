"""The port's baselines and plain sparsifiers against the JAX package's.

The same seeded numpy inputs go through both packages. Where the draws
differ (every key-derived index set), the JAX draws are carried across, so
the two compute the same estimator: Rand-k and Rand-k-Spatial (both r_modes)
on JAX's indices within rtol 1e-6, with ``client_ids``, ``chunk_offset`` and
``chunk_budgets``; the subsample projection's fused decode and
``self_decode`` on JAX's rows; top_k, wangni, induced and identity decoded
from the JAX package's own payloads (their indices travel in them).
Lemma 4.1 holds inside the port on its own draws.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import correlation as jcorr
from repro.core.estimators import base as jbase
from repro.core.estimators import rand_k as jrk
from repro.core.estimators import rand_k_spatial as jrks
from repro.core.estimators import rand_proj_spatial as jrps
from repro.core.estimators import wangni as jwangni
from repro_torch import interop
from repro_torch.core import codec as tcodec
from repro_torch.core import correlation as tcorr
from repro_torch.core.estimators import rand_k as trk
from repro_torch.core.estimators import rand_k_spatial as trks
from repro_torch.core.estimators import rand_proj_spatial as trps
from repro_torch.core.estimators import wangni as twangni
from repro_torch.dist import collectives

N, C, D, K = 4, 3, 64, 8
IDS = [5, 2, 7, 1]          # client ids of the Rand-k cases
OFFSET = 2                  # chunk_offset of their decodes
BUDGETS = (4, 8, 12)        # chunk_budgets of the adaptive cases
SHARED = [True, False]
SHARED_IDS = ["shared", "per_chunk"]


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


def _plain_specs():
    """name -> (JAX config, port config) of the sparsifiers whose indices
    travel in the payload."""
    return {
        "top_k": (jcodec.TopK(k=K, d_block=D), tcodec.TopK(k=K, d_block=D)),
        "wangni": (jcodec.Wangni(k=K, d_block=D), tcodec.Wangni(k=K, d_block=D)),
        "induced": (jcodec.Induced(k=K, d_block=D), tcodec.Induced(k=K, d_block=D)),
        "identity": (jcodec.Identity(d_block=D), tcodec.Identity(d_block=D)),
    }


def _order(shared, ckey):
    """Rand-k's full order of one client, as _budgeted_indices draws it: (1|C, D)."""
    if shared:
        return jax.random.permutation(ckey, D)[None]
    return jnp.stack([jax.random.permutation(jbase.chunk_key(ckey, ci), D) for ci in range(C)])


@pytest.fixture(scope="module")
def jax_side():
    """Inputs, and every JAX draw, payload and decode the tests compare,
    computed as ONE compiled program."""
    rng = np.random.default_rng(0)
    common = rng.standard_normal((C, D))
    xs = (common[None] + 0.5 * rng.standard_normal((N, C, D))).astype(np.float32)
    key = jax.random.key(3)

    def everything(x):
        out = {}
        for shared in SHARED:
            js = jcodec.RandK(k=K, d_block=D, shared_randomness=shared)
            pay = {"vals": jnp.stack([jrk.encode(js, key, cid, x[i])["vals"]
                                      for i, cid in enumerate(IDS)])}
            out[f"rk/{shared}"] = {
                "rows_enc": jnp.stack([jrk._indices(js, key, cid, C) for cid in IDS]),
                "rows_dec": jnp.stack([jrk._indices(js, key, cid, C, OFFSET) for cid in IDS]),
                "vals": pay["vals"],
                "decode": jrk.decode(js, key, pay, N, IDS, OFFSET),
                "self": jnp.stack([jrk.self_decode(js, key, cid, {"vals": pay["vals"][i]})
                                   for i, cid in enumerate(IDS)]),
            }
            jb = jcodec.RandK(k=K, d_block=D, shared_randomness=shared, chunk_budgets=BUDGETS)
            pay = {"vals": jnp.stack([jrk.encode(jb, key, cid, x[i])["vals"]
                                      for i, cid in enumerate(IDS)])}
            out[f"budgets/{shared}"] = {
                "orders": jnp.stack([_order(shared, jbase.client_key(key, cid)) for cid in IDS]),
                "vals": pay["vals"],
                "decode": jrk.decode(jb, key, pay, N, IDS),
                "self": jnp.stack([jrk.self_decode(jb, key, cid, {"vals": pay["vals"][i]})
                                   for i, cid in enumerate(IDS)]),
            }
            for r_mode in ("fixed", "est"):
                jks = jcodec.RandKSpatial(k=K, d_block=D, shared_randomness=shared,
                                          r_mode=r_mode)
                pays = [jrks.encode(jks, key, cid, x[i]) for i, cid in enumerate(IDS)]
                pay = {name: jnp.stack([p[name] for p in pays]) for name in pays[0]}
                out[f"rks/{shared}/{r_mode}"] = {"payload": pay,
                                              "decode": jrks.decode(jks, key, pay, N, IDS,
                                                                    OFFSET)}
            jsub = jcodec.RandProjSpatial(k=K, d_block=D, shared_randomness=shared,
                                          projection="subsample")
            pay = jcodec.Pipeline([jsub]).encode_all(key, x)[0].arrays
            out[f"sub/{shared}"] = {
                "draws": jrps._fused_draws(jsub, key, N, C, None, 0),
                "vals": pay["vals"],
                "fused": jrps._decode_fused(jsub, key, pay, N, None, 0),
                "self": jnp.stack([jrps.self_decode(jsub, key, i, {"vals": pay["vals"][i]})
                                   for i in range(N)]),
            }
        for name, (js, _) in _plain_specs().items():
            pipe = jcodec.Pipeline([js])
            pay = pipe.encode_all(key, x)[0]
            out[name] = {"payload": pay.arrays,
                         "decode": pipe.decode_payload(key, pay, N),
                         "self": pipe.self_decode(key, 1, jax.tree.map(lambda v: v[1], pay))}
        out["wangni"]["uniform"] = jnp.stack([
            jnp.stack([jax.random.uniform(jbase.chunk_key(jbase.client_key(key, i), ci), (D,))
                       for ci in range(C)]) for i in range(N)])
        out["wangni"]["p"] = jax.vmap(lambda v: jwangni.probabilities(v, K))(x.reshape(-1, D))
        out["r_exact"] = jcorr.r_exact(x)
        out["mse"] = jcorr.mse(x[0], x[1])
        return out

    with _cheap_compiles():
        out = jax.tree.map(np.asarray, jax.jit(everything)(jnp.asarray(xs)))
    out["xs"] = xs
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, rtol=1e-6):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _rows(rows, shared):
    """JAX's (n, C, k) indices, broadcast over chunks when shared -> (n, 1|C, k)."""
    return _t(rows[:, :1] if shared else rows).long()


@pytest.mark.parametrize("shared", SHARED, ids=SHARED_IDS)
def test_rand_k_matches_jax(jax_side, shared):
    """encode (bitwise: a gather), decode with client_ids and chunk_offset,
    and self_decode, on JAX's indices."""
    j = jax_side[f"rk/{shared}"]
    spec = tcodec.RandK(k=K, d_block=D, shared_randomness=shared)
    enc_rows = _rows(j["rows_enc"], shared)
    xs = _t(jax_side["xs"])
    for i, cid in enumerate(IDS):
        got = trk.encode(spec, 0, cid, xs[i], draws={"rows": enc_rows[i]})
        np.testing.assert_array_equal(got["vals"].numpy(), j["vals"][i])
        _close(trk.self_decode(spec, 0, cid, {"vals": got["vals"]}, {"rows": enc_rows[i]}),
               j["self"][i])
    got = trk.decode(spec, 0, {"vals": _t(j["vals"])}, N, IDS, OFFSET,
                     draws={"rows": _rows(j["rows_dec"], shared)})
    _close(got, j["decode"])


@pytest.mark.parametrize("shared", SHARED, ids=SHARED_IDS)
def test_rand_k_chunk_budgets_match_jax(jax_side, shared):
    """Adaptive budgets: chunk c takes the first k_c of JAX's full orders."""
    j = jax_side[f"budgets/{shared}"]
    spec = tcodec.RandK(k=K, d_block=D, shared_randomness=shared, chunk_budgets=BUDGETS)
    orders = _t(j["orders"]).long()
    xs = _t(jax_side["xs"])
    for i, cid in enumerate(IDS):
        got = trk.encode(spec, 0, cid, xs[i], draws={"rows": orders[i]})
        np.testing.assert_array_equal(got["vals"].numpy(), j["vals"][i])
        _close(trk.self_decode(spec, 0, cid, got, {"rows": orders[i]}), j["self"][i])
    _close(trk.decode(spec, 0, {"vals": _t(j["vals"])}, N, IDS, draws={"rows": orders}),
           j["decode"])
    with pytest.raises(ValueError, match="shardable"):
        trk.decode(spec, 0, {"vals": _t(j["vals"])}, N, IDS, chunk_offset=1,
                   draws={"rows": orders})


@pytest.mark.parametrize("r_mode", ["fixed", "est"])
@pytest.mark.parametrize("shared", SHARED, ids=SHARED_IDS)
def test_rand_k_spatial_matches_jax(jax_side, shared, r_mode):
    j = jax_side[f"rks/{shared}/{r_mode}"]
    spec = tcodec.RandKSpatial(k=K, d_block=D, shared_randomness=shared, r_mode=r_mode)
    xs = _t(jax_side["xs"])
    enc_rows = _rows(jax_side[f"rk/{shared}"]["rows_enc"], shared)
    for i, cid in enumerate(IDS):
        got = trks.encode(spec, 0, cid, xs[i], draws={"rows": enc_rows[i]})
        assert sorted(got) == sorted(j["payload"])
        for name, arr in got.items():
            _close(arr, j["payload"][name][i])
    got = trks.decode(spec, 0, {k: _t(v) for k, v in j["payload"].items()}, N, IDS, OFFSET,
                      draws={"rows": _rows(jax_side[f"rk/{shared}"]["rows_dec"], shared)})
    _close(got, j["decode"])


@pytest.mark.parametrize("shared", SHARED, ids=SHARED_IDS)
def test_subsample_matches_jax(jax_side, shared):
    """The subsample projection through the fused route (the closed-form
    diagonal solve) and its self_decode, on JAX's rows."""
    j = jax_side[f"sub/{shared}"]
    spec = tcodec.RandProjSpatial(k=K, d_block=D, shared_randomness=shared,
                                  projection="subsample")
    draws = interop.draws_from_numpy(j["draws"], "cpu")
    pay, _ = tcodec.Pipeline([spec]).encode_all(0, _t(jax_side["xs"]), draws=draws)
    np.testing.assert_array_equal(pay["vals"].numpy(), j["vals"])
    _close(trps.decode(spec, 0, {"vals": _t(j["vals"])}, N, draws=draws), j["fused"])
    for i in range(N):
        got = trps.self_decode(spec, 0, i, {"vals": _t(j["vals"][i])},
                               draws={"rows": draws["rows"][i]})
        _close(got, j["self"][i])


@pytest.mark.parametrize("shared", SHARED, ids=SHARED_IDS)
def test_lemma_4_1_inside_the_port(shared):
    """On the port's own draws the subsample projection shares Rand-k's rows
    and payloads: its fused, gram and direct decodes match Rand-k-Spatial's
    within rtol 2e-6 (a reciprocal-then-multiply against a divide), and its
    self_decode equals Rand-k's bit for bit."""
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(rng.standard_normal((N, C, D)).astype(np.float32))
    rks = tcodec.RandKSpatial(k=K, d_block=D, shared_randomness=shared)
    want = tcodec.Pipeline([rks]).mean_estimate(21, xs, device="cpu")
    pay_rk, _ = tcodec.Pipeline([rks]).encode_all(21, xs)
    for method in ("fused", "gram", "direct"):
        spec = tcodec.RandProjSpatial(k=K, d_block=D, shared_randomness=shared,
                                      projection="subsample", decode_method=method)
        pipe = tcodec.Pipeline([spec])
        pay, _ = pipe.encode_all(21, xs)
        assert torch.equal(pay["vals"], pay_rk["vals"])
        _close(pipe.mean_estimate(21, xs, device="cpu"), want.numpy(), rtol=2e-6)
    for i in range(N):
        one = tcodec.Payload({"vals": pay["vals"][i]}, pay.meta)
        assert torch.equal(pipe.self_decode(21, i, one),
                           tcodec.Pipeline([rks]).self_decode(21, i, one))


def test_correlation_matches_jax(jax_side):
    xs = _t(jax_side["xs"])
    _close(tcorr.r_exact(xs), jax_side["r_exact"])
    _close(tcorr.mse(xs[0], xs[1]), jax_side["mse"])


@pytest.mark.parametrize("name", list(_plain_specs()))
def test_plain_sparsifier_decodes_match_jax(jax_side, name):
    """Decode and self_decode of the JAX package's own payloads; the encode
    too, with JAX's uniforms (wangni) and random rows (induced)."""
    j = jax_side[name]
    _, spec = _plain_specs()[name]
    pipe = tcodec.Pipeline([spec])
    pay = tcodec.Payload({k: _t(v) for k, v in j["payload"].items()}, pipe.payload_meta(C))
    _close(pipe.decode(0, pay, N), j["decode"])
    one = tcodec.Payload({k: v[1] for k, v in pay.arrays.items()}, pay.meta)
    _close(pipe.self_decode(0, 1, one), j["self"])
    xs = _t(jax_side["xs"])
    for i in range(N):
        draws = None
        if name == "wangni":
            draws = {"uniform": _t(j["uniform"][i])}
        elif name == "induced":
            draws = {"rows": _t(j["payload"]["rand_idx"][i])}
        got = spec.encode(0, i, xs[i], draws=draws)
        want = {k: _t(v[i]) for k, v in j["payload"].items()}
        assert sorted(got) == sorted(want)
        assert all(got[k].dtype == want[k].dtype for k in got)
        if name == "wangni":
            # the kept values x_j / p_j of unsaturated coordinates are equal
            # but for rounding, so their packing order is rounding's: compare
            # the kept set and its values
            torch.testing.assert_close(got["idx"].sort(-1).values, want["idx"].sort(-1).values,
                                       rtol=0, atol=0)
            _close(spec.self_decode(0, i, got), spec.self_decode(0, i, want).numpy())
            continue
        for arr_name, arr in got.items():
            _close(arr, want[arr_name].numpy())


def test_wangni_probabilities_match_jax(jax_side):
    got = twangni.probabilities(_t(jax_side["xs"]).reshape(-1, D), K)
    _close(got, jax_side["wangni"]["p"])
    assert torch.allclose(got.sum(-1), torch.full((N * C,), float(K)), rtol=1e-5)


ALL_CONFIGS = {
    "rand_k": (tcodec.RandK(k=K, d_block=D), jcodec.RandK(k=K, d_block=D)),
    "rand_k_budgets": (tcodec.RandK(k=K, d_block=D, chunk_budgets=BUDGETS),
                       jcodec.RandK(k=K, d_block=D, chunk_budgets=BUDGETS)),
    "rand_k_spatial_est": (tcodec.RandKSpatial(k=K, d_block=D, r_mode="est"),
                           jcodec.RandKSpatial(k=K, d_block=D, r_mode="est")),
    "rand_proj_spatial_est": (tcodec.RandProjSpatial(k=K, d_block=D, r_mode="est"),
                              jcodec.RandProjSpatial(k=K, d_block=D, r_mode="est")),
    **{name: (t, j) for name, (j, t) in _plain_specs().items()},
}


@pytest.mark.parametrize("name", list(ALL_CONFIGS))
def test_payload_schema_and_norm_inflation(name):
    """Each config's declared schema against the tensors it produces, and
    its self_decode_norm_inflation against the JAX config's value; then a
    compressed mean of a small tree through it."""
    spec, jspec = ALL_CONFIGS[name]
    assert spec.self_decode_norm_inflation == jspec.self_decode_norm_inflation
    assert spec.payload_schema(C) == tuple(tuple(s) for s in jspec.payload_schema(C))
    assert spec.supports_self_decode
    xs = torch.from_numpy(np.random.default_rng(2).standard_normal((N, C, D)).astype(np.float32))
    pay, _ = tcodec.Pipeline([spec]).encode_all(4, xs)
    for i in range(N):
        one = tcodec.Payload({k: v[i] for k, v in pay.arrays.items()}, pay.meta)
        assert tcodec.check_against_schema(one) == []
    tree = {"w": xs.reshape(N, C * D)[:, :150], "b": [xs.reshape(N, C * D)[:, 150:]]}
    mean, info, _ = collectives.compressed_mean_tree(spec, 4, tree, device="cpu")
    assert mean["w"].shape == (150,) and torch.isfinite(mean["w"]).all()
    assert info["payload_bytes_per_client"] == sum(s.nbytes for s in spec.payload_schema(C))
