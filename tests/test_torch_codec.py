"""The port's codec layer against the JAX package's: quantizers, error
feedback and temporal stages, entropy coding, budgets, ``build`` and the
pipeline's payload-driven decode.

- adaptive per-chunk budgets ride the payload: a pipeline built with a
  plain k decodes a ``chunk_budgets`` payload as JAX does (within 1e-6);
- the int8 and correlated rounding, fed JAX's own uniforms, and the bf16
  cast give JAX's bits; the entropy streams are JAX's byte for byte and
  round-trip; the budget rules give JAX's numbers and errors;
- error feedback (top_k, 3 rounds) and per-client temporal memories (Rand-k
  on JAX's indices) follow JAX within 1e-6;
- on the port's own draws: the declared ledger equals the payload bytes for
  every sparsifier x quantizer, and int8 composition stays unbiased.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core.codec import quantizers as jquant
from repro.core.estimators import base as jbase
from repro.core.estimators import rand_k as jrk
from repro.dist import collectives as jcoll
from repro_torch.core import codec as tcodec
from repro_torch.core.codec import quantizers as tquant
from repro_torch.dist import collectives as tcoll

N, C, D, K = 4, 3, 64, 8
BUDGETS = (4, 8, 12)
SHARED = [True, False]
SHARED_IDS = ["shared", "per_chunk"]
QUANT_IDS = ["f32", "bf16", "int8", "correlated"]
EF_SHAPES = {"w": (5, 30), "b": (40,)}  # 190 values: 3 chunks of 64, the last ragged
EF_ROUNDS = (None, None, [0, 2, 3])     # participants by round
TEMPORAL_ROUNDS = 3


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


def _xs(n=N, c=C, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    common = rng.standard_normal((c, D))
    return (common[None] + 0.5 * rng.standard_normal((n, c, D))).astype(np.float32)


def _round_values(seed=1) -> np.ndarray:
    """(6, 16) values to quantize: mixed scales, an all-zero row, a row
    whose max sits at -max (the clip edge)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((6, 16)).astype(np.float32) * np.float32(3.0) ** np.arange(6)[:, None]
    v[2] = 0.0
    v[4, 3] = -np.abs(v[4]).max() * 2
    return v.astype(np.float32)


def _bf16_values() -> np.ndarray:
    rng = np.random.default_rng(2)
    v = rng.standard_normal(64).astype(np.float32)
    # ties to even at bf16's rounding position, a denormal, large magnitudes
    edge = np.array([1.00390625, 1.01171875, -3.0078125, 1e-40, 3.0e38, -2.5e-30],
                    np.float32)
    return np.concatenate([v, edge]).reshape(5, 14)


def _order(shared, ckey):
    """Rand-k's full order of one client, as JAX's budgeted draw takes it: (1|C, D)."""
    if shared:
        return jax.random.permutation(ckey, D)[None]
    return jnp.stack([jax.random.permutation(jbase.chunk_key(ckey, ci), D) for ci in range(C)])


def _ef_tree(seed=3) -> dict:
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal((N,) + shape).astype(np.float32)
            for name, shape in EF_SHAPES.items()}


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX payload, uniform, decode, residual and memory the tests
    compare, from ONE compiled program."""
    xs = _xs()
    v = _round_values()
    key = jax.random.key(7)

    def everything(x, bf, tree):
        out = {}
        for shared in SHARED:
            jb = jcodec.RandK(k=K, d_block=D, shared_randomness=shared, chunk_budgets=BUDGETS)
            payloads, _ = jcodec.Pipeline([jb]).encode_all(key, x)
            plain = jcodec.Pipeline([jcodec.RandK(k=K, d_block=D, shared_randomness=shared)])
            out[f"budgets/{shared}"] = {
                "orders": jnp.stack([_order(shared, jbase.client_key(key, i)) for i in range(N)]),
                "vals": payloads.arrays["vals"],
                "decode": plain.decode_payload(key, payloads, N),
                "self": jnp.stack([plain.self_decode(
                    key, i, jcodec.Payload({"vals": payloads.arrays["vals"][i]}, payloads.meta))
                    for i in range(N)]),
            }
        out["bf16"] = jax.lax.bitcast_convert_type(
            jcodec.Bf16Quant().encode(None, {"vals": bf}, ("vals",))["vals"], jnp.uint16)
        ef_spec = jcodec.build("top_k", k=K, d_block=D, ef=True)
        ef = jnp.zeros((N, C, D))
        rounds = []
        for t, participants in enumerate(EF_ROUNDS):
            mean, _, ef = jcoll.compressed_mean_tree(
                ef_spec, jax.random.fold_in(key, t), tree, ef_chunks=ef,
                participants=participants)
            rounds.append({"mean": mean, "ef": ef})
        out["ef"] = rounds
        out["temporal"] = temporal(x)
        return out

    def temporal(x):
        """Per-client Rand-k-Temporal over rounds: each round's rows (JAX's
        indices), payload decode plus the mean memory, and memories."""
        spec = jcodec.RandK(k=16, d_block=D)
        pipe = jcodec.Pipeline([spec, jcodec.Temporal()])
        states = pipe.init_client_state(N, C)
        got = []
        for t in range(TEMPORAL_ROUNDS):
            kt = jax.random.fold_in(key, 100 + t)
            xt = x + 0.1 * t
            rows = jnp.stack([jrk._indices(spec, kt, i, C)[:1] for i in range(N)])
            side = jnp.mean(states.memory, axis=0)
            payloads, states = pipe.encode_all(kt, xt, states=states)
            got.append({"rows": rows, "decode": pipe.decode(kt, payloads, N, side_info=side),
                        "memory": states.memory})
        return got

    def rounding(v):
        """Per client id: JAX's int8 and correlated encodes of ``v`` and the
        uniforms they drew. Eager: under jit XLA turns the scale's division
        by 127 into a multiply by its reciprocal, one ulp off the division
        that the quantizer (and the port) computes."""
        got = {}
        for cid in range(6):
            qkey = jbase.client_key(key, cid)
            arrays = {"vals": v, "idx": jnp.zeros(v.shape, jnp.int32)}
            dkey = jax.random.fold_in(key, jquant._COHORT_SALT)
            got[cid] = {
                "int8": jquant.Int8Quant().encode(qkey, arrays, ("vals",)),
                "u": jax.random.uniform(jax.random.fold_in(qkey, jquant._salt("vals")), v.shape),
                "correlated": jquant.CorrelatedQuant().encode(qkey, arrays, ("vals",),
                                                              round_key=key, client_id=cid),
                "shared": jax.random.uniform(jax.random.fold_in(dkey, jquant._salt("vals")),
                                             v.shape),
            }
        return got

    with _cheap_compiles():
        out = jax.tree.map(np.asarray, jax.jit(everything)(
            jnp.asarray(xs), jnp.asarray(_bf16_values()),
            {k: jnp.asarray(a) for k, a in _ef_tree().items()}))
        out["rounding"] = jax.tree.map(np.array, rounding(jnp.asarray(v)))
    out["xs"] = xs
    return out


# ----------------------------------------------------- the adaptive-budget fault


@pytest.mark.parametrize("shared", SHARED, ids=SHARED_IDS)
def test_chunk_budgets_payload_decodes_through_plain_pipeline(jax_side, shared):
    """A ``chunk_budgets`` payload carries its budgets in its meta, and a
    pipeline built with a plain k follows them, as in the JAX package."""
    side = jax_side[f"budgets/{shared}"]
    draws = {"rows": torch.from_numpy(side["orders"].astype(np.int64))}
    xs = torch.from_numpy(jax_side["xs"])
    budgeted = tcodec.Pipeline([tcodec.RandK(k=K, d_block=D, shared_randomness=shared,
                                             chunk_budgets=BUDGETS)])
    payloads, _ = budgeted.encode_all(0, xs, draws=draws)
    assert payloads.meta.chunk_budgets == BUDGETS
    np.testing.assert_array_equal(payloads.arrays["vals"].numpy(), side["vals"])
    plain = tcodec.Pipeline([tcodec.RandK(k=K, d_block=D, shared_randomness=shared)])
    got = plain.decode_payload(0, payloads, N, draws=draws)
    np.testing.assert_allclose(got.numpy(), side["decode"], rtol=1e-6, atol=1e-6)
    for i in range(N):
        one = tcodec.Payload({"vals": payloads.arrays["vals"][i]}, payloads.meta)
        got = plain.self_decode(0, i, one, draws={"rows": draws["rows"][i]})
        np.testing.assert_allclose(got.numpy(), side["self"][i], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ quantizers


def test_salts_match_jax():
    for name in ("vals", "top_vals", "rand_vals", "norm_sq", "idx", "some_values_x"):
        assert tquant._salt(name) == jquant._salt(name)
    assert (tquant._PHI, tquant._COHORT_SALT) == (jquant._PHI, jquant._COHORT_SALT)


@pytest.mark.parametrize("cid", range(6))
def test_int8_and_correlated_rounding_match_jax_bitwise(jax_side, cid):
    """``stochastic_round`` on JAX's own uniforms gives JAX's int8 values and
    scales bit for bit; ``cohort_dither`` on JAX's shared uniforms gives the
    correlated quantizer's."""
    side = jax_side["rounding"][cid]
    v = torch.from_numpy(_round_values())
    for name, u in (("int8", torch.from_numpy(side["u"])),
                    ("correlated", tquant.cohort_dither(torch.from_numpy(side["shared"]), cid))):
        q, scale = tquant.stochastic_round(v, u)
        want = side[name]
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), want["vals"], err_msg=name)
        np.testing.assert_array_equal(scale.numpy(), want["vals_scale"], err_msg=name)
        assert sorted(want) == ["idx", "vals", "vals_scale"]


def test_int8_encode_uses_the_client_keys_stream():
    """The port's own dither: uniforms of fold_in(qkey, salt); correlated:
    of the round key's cohort stream, rotated by the client id; and the
    correlated quantizer refuses to run without its cohort context."""
    from repro_torch.core import random as prand

    v = torch.from_numpy(_round_values())
    qkey = prand.fold_in(prand.key(7), 3)
    got = tcodec.Int8Quant().encode(qkey, {"vals": v}, ("vals",))
    q, scale = tquant.stochastic_round(v, prand.uniform(prand.fold_in(qkey, 101), v.shape))
    assert torch.equal(got["vals"], q) and torch.equal(got["vals_scale"], scale)
    got = tcodec.CorrelatedQuant().encode(qkey, {"vals": v}, ("vals",), round_key=7, client_id=3)
    shared = prand.uniform(prand.fold_in(prand.fold_in(prand.key(7), tquant._COHORT_SALT), 101),
                           v.shape)
    assert torch.equal(got["vals"], tquant.stochastic_round(v, tquant.cohort_dither(shared, 3))[0])
    with pytest.raises(ValueError, match="round key"):
        tcodec.CorrelatedQuant().encode(qkey, {"vals": v}, ("vals",))


def test_bf16_cast_matches_jax_bitwise(jax_side):
    got = tcodec.Bf16Quant().encode(None, {"vals": torch.from_numpy(_bf16_values())}, ("vals",))
    assert got["vals"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["vals"].view(torch.int16).numpy().view(np.uint16),
                                  jax_side["bf16"])


SPARSIFIERS = [
    tcodec.RandK(k=8, d_block=D),
    tcodec.RandKSpatial(k=8, d_block=D, transform="avg"),
    tcodec.RandKSpatial(k=8, d_block=D, transform="avg", r_mode="est"),
    tcodec.RandProjSpatial(k=8, d_block=D, transform="avg"),
    tcodec.RandProjSpatial(k=8, d_block=D, transform="avg", r_mode="est"),
    tcodec.SparseProj(k=8, d_block=D, s=8.0),
    tcodec.SparseProj(k=8, d_block=D, s=8.0, r_mode="est"),
    tcodec.TopK(k=8, d_block=D),
    tcodec.Wangni(k=8, d_block=D),
    tcodec.Induced(k=8, d_block=D),
    tcodec.Identity(d_block=D),
]
QUANTS = [None, tcodec.Bf16Quant(), tcodec.Int8Quant(), tcodec.CorrelatedQuant()]


@pytest.mark.parametrize("quant", QUANTS, ids=QUANT_IDS)
@pytest.mark.parametrize(
    "sp", SPARSIFIERS,
    ids=lambda s: f"{s.name}{'-est' if getattr(s, 'r_mode', '') == 'est' else ''}")
def test_ledger_honesty_every_codec(sp, quant):
    """The declared ledger (schema) equals the actual tensor bytes for every
    sparsifier x quantizer, one client and stacked."""
    pipe = tcodec.Pipeline([sp] + ([quant] if quant is not None else []))
    xs = torch.from_numpy(_xs(n=6, c=2))
    payload = pipe.encode_payload(0, 3, xs[0])
    assert tcodec.check_against_schema(payload) == []
    assert payload.nbytes == payload.meta.declared_nbytes == pipe.payload_nbytes(2)
    stacked, _ = pipe.encode_all(1, xs)
    assert stacked.per_client_nbytes() == pipe.payload_nbytes(2)
    assert tcodec.coded_payload_nbytes(pipe, stacked) == stacked.nbytes


UNBIASED = [
    tcodec.RandK(k=8, d_block=D, shared_randomness=False),
    tcodec.RandKSpatial(k=8, d_block=D, transform="avg", shared_randomness=False),
    tcodec.RandProjSpatial(k=8, d_block=D, transform="avg", shared_randomness=False),
    tcodec.Wangni(k=8, d_block=D),
    tcodec.Induced(k=8, d_block=D),
]


@pytest.mark.parametrize("with_side", [False, True], ids=["plain", "side_info"])
@pytest.mark.parametrize("sp", UNBIASED, ids=lambda s: s.name)
def test_pipeline_int8_composition_stays_unbiased(sp, with_side):
    """E[decode] = mean(x) for [unbiased sparsifier, Int8Quant], with and
    without side information: 600 trials of the JAX suite's 6 clients x 2
    chunks, run as chunks (a draw, and rounding noise, per chunk)."""
    trials, n, c = 600, 6, 2
    xs = torch.from_numpy(_xs(n=n, c=c)).repeat(1, trials, 1)
    pipe = tcodec.Pipeline([sp, tcodec.Int8Quant()])
    side = 0.5 * xs.mean(0) if with_side else None
    xh = pipe.mean_estimate(2, xs, side_info=side, device="cpu").reshape(trials, c, D).double()
    xbar = xs[:, :c].mean(0).double()
    sem = xh.std(0) / np.sqrt(trials) + 1e-4
    err = (xh.mean(0) - xbar).abs()
    assert bool((err < 6 * sem + 6e-3).all()), float(err.max())


# --------------------------------------------------------------- error feedback


def test_ef_residual_is_input_minus_self_decode():
    n, d, k = 3, 64, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    spec = tcodec.build("top_k", k=k, d_block=d, ef=True)
    ef0 = torch.zeros((n, 1, d))
    _, _, ef1 = tcoll.compressed_mean_tree(spec, 0, {"w": torch.from_numpy(x)}, ef_chunks=ef0,
                                           device="cpu")
    assert torch.equal(ef0, torch.zeros((n, 1, d)))  # the caller's residuals stay
    for i in range(n):
        r = ef1[i, 0].numpy()
        kept = np.argsort(-np.abs(x[i]))[:k]
        assert np.allclose(r[kept], 0, atol=1e-6)
        mask = np.ones(d, bool)
        mask[kept] = False
        np.testing.assert_allclose(r[mask], x[i][mask], rtol=1e-6)


def test_ef_accumulates_missed_mass_over_rounds():
    """A coordinate always below the top-k threshold is sent at last under
    EF (its residual grows); without EF it never is."""
    n, d, k = 2, 32, 4
    base = np.zeros(d, np.float32)
    base[:k] = 3.0
    base[k] = 1.0
    tree = {"w": torch.from_numpy(np.tile(base, (n, 1)))}
    spec = tcodec.build("top_k", k=k, d_block=d, ef=True)
    ef, seen = torch.zeros((n, 1, d)), 0.0
    for t in range(8):
        mean, _, ef = tcoll.compressed_mean_tree(spec, t, tree, ef_chunks=ef, device="cpu")
        seen += float(mean["w"][k])
    assert seen > 0.5, "EF never flushed the missed coordinate"
    mean_plain, _, none = tcoll.compressed_mean_tree(tcodec.TopK(k=k, d_block=d), 2, tree,
                                                     device="cpu")
    assert float(mean_plain["w"][k]) == 0.0 and none is None


def test_ef_rounds_match_jax(jax_side):
    """top_k + ErrorFeedback, 3 rounds (the third with clients 0, 2 and 3
    reporting) through both packages' compressed_mean_tree: means and
    residuals within 1e-6; the absent client's residual row carries over."""
    spec = tcodec.build("top_k", k=K, d_block=D, ef=True)
    tree = {k: torch.from_numpy(a) for k, a in _ef_tree().items()}
    ef = None
    for t, participants in enumerate(EF_ROUNDS):
        before = ef
        mean, info, ef = tcoll.compressed_mean_tree(spec, t, tree, ef_chunks=ef,
                                                    participants=participants, device="cpu")
        want = jax_side["ef"][t]
        for name in EF_SHAPES:
            np.testing.assert_allclose(mean[name].numpy(), want["mean"][name], rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(ef.numpy(), want["ef"], rtol=1e-6, atol=1e-6)
        if participants is not None:
            assert torch.equal(ef[1], before[1]) and info["n_clients"] == 3


def test_temporal_memories_match_jax(jax_side):
    """Per-client Rand-k-Temporal on JAX's indices: each round's decode
    (plus the mean memory) and every client's memory within 1e-6."""
    pipe = tcodec.Pipeline([tcodec.RandK(k=16, d_block=D), tcodec.Temporal()])
    x = torch.from_numpy(jax_side["xs"])
    states = pipe.init_client_state(N, C, device="cpu")
    assert states.ef is None and torch.equal(states.memory, torch.zeros(N, C, D))
    for t, want in enumerate(jax_side["temporal"]):
        draws = {"rows": torch.from_numpy(want["rows"].astype(np.int64))}
        side = states.memory.mean(0)
        payloads, states = pipe.encode_all(t, x + 0.1 * t, states=states, draws=draws)
        got = pipe.decode(t, payloads, N, side_info=side, draws=draws)
        np.testing.assert_allclose(got.numpy(), want["decode"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(states.memory.numpy(), want["memory"], rtol=1e-6, atol=1e-6)


def test_client_temporal_memory_tracks_clients():
    """On the port's own draws each client's memory converges toward ITS
    vector, not the mean (twin of the JAX suite's drift test, fixed vectors)."""
    rng = np.random.default_rng(3)
    common = rng.standard_normal(D)
    xs = torch.from_numpy((common + rng.standard_normal((4, 1, D))).astype(np.float32))
    pipe = tcodec.Pipeline([tcodec.RandK(k=16, d_block=D), tcodec.Temporal()])
    states = pipe.init_client_state(4, 1, device="cpu")
    for t in range(40):
        _, states = pipe.encode_all(t, xs, states=states)
    mem, xbar = states.memory[:, 0], xs[:, 0].mean(0)
    for i in range(4):
        assert float((mem[i] - xs[i, 0]).norm()) < float((mem[i] - xbar).norm())


def test_client_state_rows():
    st = tcodec.ClientState(ef=torch.arange(12.0).reshape(3, 2, 2), memory=None)
    part = st.rows([2, 0])
    assert torch.equal(part.ef, st.ef[[2, 0]]) and part.memory is None
    new = st.with_rows([1], tcodec.ClientState(ef=torch.full((1, 2, 2), -1.0)))
    assert torch.equal(new.ef[1], torch.full((2, 2), -1.0))
    assert torch.equal(new.ef[[0, 2]], st.ef[[0, 2]]) and torch.equal(st.ef[1], st.ef[1])
    assert float(st.ef[1, 0, 0]) == 4.0  # the source state is unchanged
    assert torch.equal(tcodec.ClientState.stack([st.client(0), st.client(2)]).ef, part.ef[[1, 0]])


# --------------------------------------------------------- build and the pipeline


def test_build_numeric_parity_with_explicit_pipeline():
    xs = torch.from_numpy(_xs())
    for kw, stages in ((dict(), []), (dict(payload_dtype="int8"), [tcodec.Int8Quant()]),
                       (dict(payload_dtype="bfloat16"), [tcodec.Bf16Quant()]),
                       (dict(payload_dtype="correlated"), [tcodec.CorrelatedQuant()])):
        built = tcodec.build("rand_proj_spatial", k=8, d_block=D, transform="avg", **kw)
        pipe = tcodec.Pipeline([tcodec.RandProjSpatial(k=8, d_block=D, transform="avg")] + stages)
        assert built == pipe
        assert torch.equal(built.mean_estimate(5, xs, device="cpu"),
                           pipe.mean_estimate(5, xs, device="cpu"))
    pipe = tcodec.build("rand_proj_spatial", k=8, d_block=D, payload_dtype="int8", ef=True,
                        temporal=True, entropy_code=True, use_pallas="never")
    assert pipe.has_ef and pipe.has_client_temporal and pipe.stateful
    assert isinstance(pipe.quantizer, tcodec.Int8Quant)
    assert isinstance(pipe.code_stage, tcodec.EntropyCode)
    assert pipe.sparsifier.use_kernel == "never"
    assert tcodec.build("wangni", k=8, d_block=D, wangni_capacity=2.0).sparsifier.capacity == 2.0
    assert tcodec.build("induced", k=8, d_block=D, induced_topk_frac=0.25).sparsifier.topk_frac \
        == 0.25


def test_build_rejects_unknown_fields_but_tolerates_legacy():
    with pytest.raises(TypeError, match="no field"):
        tcodec.build("rand_k", k=8, d_block=D, klingon=True)
    with pytest.raises(KeyError, match="unknown estimator"):
        tcodec.build("rand_q", k=8)
    with pytest.raises(ValueError, match="payload_dtype"):
        tcodec.build("rand_k", k=8, payload_dtype="int4")
    pipe = tcodec.build("rand_k", k=8, d_block=D, transform="one", use_pallas="never")
    assert pipe.transform is None
    with pytest.raises(TypeError, match="expected Pipeline"):
        tcodec.as_pipeline(object())


def test_pipeline_validation_and_structure_match_jax():
    with pytest.raises(ValueError, match="sparsifier"):
        tcodec.Pipeline([tcodec.Int8Quant()])
    with pytest.raises(ValueError, match="more than one"):
        tcodec.Pipeline([tcodec.RandK(k=4, d_block=D), tcodec.Identity(d_block=D)])
    with pytest.raises(ValueError, match="more than one"):
        tcodec.Pipeline([tcodec.RandK(k=4, d_block=D), tcodec.Int8Quant(), tcodec.Bf16Quant()])
    with pytest.raises(TypeError):
        tcodec.Pipeline([tcodec.RandK(k=4, d_block=D), "not a stage"])
    cases = [
        dict(name="rand_k", k=4, d_block=D),
        dict(name="rand_k", k=4, d_block=D, shared_randomness=False),
        dict(name="rand_k", k=4, d_block=D, chunk_budgets=(2, 6)),
        dict(name="rand_k_spatial", k=4, d_block=D, r_mode="est"),
        dict(name="sparse_proj", k=4, d_block=D, r_mode="est"),
        dict(name="top_k", k=4, d_block=D, payload_dtype="int8"),
        dict(name="top_k", k=4, d_block=D, payload_dtype="correlated", ef=True),
        dict(name="identity", d_block=D, payload_dtype="bfloat16", temporal=True),
    ]
    for kw in cases:
        kw = dict(kw)
        name = kw.pop("name")
        j, t = jcodec.build(name, **kw), tcodec.build(name, **kw)
        for attr in ("non_streamable_stage", "non_shardable_stage"):
            js, ts = getattr(j, attr), getattr(t, attr)
            assert (js is None) == (ts is None), (name, kw, attr)
            if js is not None:
                assert (js[0].name, js[1]) == (ts[0].name, ts[1])
        assert (j.describe(), j.k, j.d_block, j.transform, j.stateful) == \
            (t.describe(), t.k, t.d_block, t.transform, t.stateful)
        assert j.payload_nbytes(2) == t.payload_nbytes(2)
        jm, tm = j.payload_meta(2), t.payload_meta(2)
        assert (jm.chunk_budgets, jm.value_names, jm.stages) == \
            (tm.chunk_budgets, tm.value_names, tm.stages)


def test_payload_meta_and_staleness():
    pipe = tcodec.Pipeline([tcodec.RandK(k=8, d_block=D), tcodec.Int8Quant()])
    payload = pipe.encode_payload(0, 0, torch.from_numpy(_xs()[0]))
    assert payload.meta.array_spec("vals_scale").kind == tcodec.SCALES
    with pytest.raises(KeyError):
        payload.meta.array_spec("nope")
    stale = tcodec.with_staleness(payload, 1)
    assert stale.meta.staleness == 1 and stale.arrays is payload.arrays
    with pytest.raises(ValueError):
        tcodec.with_staleness(payload, -1)


# ----------------------------------------------------------------- entropy coding


def _entropy_payloads() -> list:
    """Payload dicts as numpy arrays (bf16 as its uint16 bits): int8 values
    that code (a Gaussian scale) and that escape to raw (uniform), int32
    indices that code (small) and that escape (huge), float32 and bf16 raw."""
    rng = np.random.default_rng(4)
    gauss = np.clip(np.round(rng.standard_normal((3, 40)) * 20), -128, 127).astype(np.int8)
    flat = rng.integers(-128, 128, (3, 40)).astype(np.int8)
    idx = np.sort(rng.integers(0, 64, (3, 16)), axis=-1).astype(np.int32)
    wide = rng.integers(-2**31, 2**31 - 1, (3, 4)).astype(np.int32)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = (rng.standard_normal((3, 6)).astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    return [{"vals": gauss, "vals_scale": f32[:, :1], "idx": idx},
            {"vals": flat, "idx": wide, "norm_sq": f32},
            {"vals": bf, "idx": idx}]


def _port(payload: dict) -> dict:
    return {name: (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                   if a.dtype == np.uint16 else torch.from_numpy(a))
            for name, a in payload.items()}


def _jax(payload: dict) -> dict:
    return {name: (jax.lax.bitcast_convert_type(jnp.asarray(a), jnp.bfloat16)
                   if a.dtype == np.uint16 else jnp.asarray(a)) for name, a in payload.items()}


def _schema(payload: dict) -> tuple:
    names = {np.dtype(np.int8): "int8", np.dtype(np.int32): "int32",
             np.dtype(np.float32): "float32", np.dtype(np.uint16): "bfloat16"}
    return tuple(tcodec.ArraySpec(n, a.shape[1:], names[a.dtype], tcodec.VALUES)
                 for n, a in payload.items())


@pytest.mark.parametrize("case", range(3))
def test_entropy_streams_match_jax_and_round_trip(case):
    payload = _entropy_payloads()[case]
    tcode, jcode = tcodec.EntropyCode(), jcodec.EntropyCode()
    tp, jp = _port(payload), _jax(payload)
    assert tcode.coded_nbytes_stacked(tp) == jcode.coded_nbytes_stacked(jp)
    for i in range(3):
        one_t = {n: a[i] for n, a in tp.items()}
        stream = tcode.encode_stream(one_t)
        assert stream == jcode.encode_stream({n: a[i] for n, a in jp.items()})
        assert tcode.coded_nbytes(one_t) == len(stream)
        back = tcode.decode_stream(stream, _schema(payload))
        assert sorted(back) == sorted(one_t)
        for name, a in one_t.items():
            assert back[name].dtype == a.dtype and torch.equal(back[name], a), name
    if case == 1:  # the escapes: raw bytes plus one header byte
        one = {n: a[0] for n, a in tp.items()}
        assert tcode.coded_nbytes({"vals": one["vals"]}) == 40 + 1
        assert tcode.coded_nbytes({"idx": one["idx"]}) == 16 + 1


def test_coded_payload_nbytes_follows_the_code_stage():
    pipe = tcodec.build("top_k", k=8, d_block=D, payload_dtype="int8", entropy_code=True)
    payloads, _ = pipe.encode_all(0, torch.from_numpy(_xs()))
    coded = tcodec.coded_payload_nbytes(pipe, payloads)
    assert coded == pipe.code_stage.coded_nbytes_stacked(payloads)
    assert 0 < coded < payloads.nbytes + 3 * N


# ------------------------------------------------------------------------ budgets


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:  # BudgetExceedsDimension included
        return (type(e).__name__, str(e))


def test_budget_rules_match_jax():
    for n in (1, 2, 4, 16, 1000):
        for eps in (0.0, 0.05, 0.1, 0.3, 0.5, 0.9, 0.999, 1.0):
            assert _outcome(tcodec.jl_min_k, n, eps) == _outcome(jcodec.jl_min_k, n, eps)
            for d in (0, 64, 1024, 16384):
                assert _outcome(tcodec.suggest_budget, n, eps, d) == \
                    _outcome(jcodec.suggest_budget, n, eps, d)
    rng = np.random.default_rng(6)
    masses = [rng.random(7), rng.random(7) ** 8, np.zeros(5), np.array([1.0, np.nan, 2.0]),
              np.array([5.0, 0.0, 0.0, 0.0]), np.array([-1.0, 2.0]), np.array([])]
    for mass in masses:
        for k, d_block in ((1, 4), (3, 4), (8, 64), (4, 4), (0, 4)):
            assert _outcome(tcodec.adaptive_chunk_budgets, mass, k, d_block) == \
                _outcome(jcodec.adaptive_chunk_budgets, mass, k, d_block)
