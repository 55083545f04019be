"""The port seeded from one integer, with no draws carried across, against
the JAX package on the CPU: on core.random's threefry the port draws JAX's
own maps, banks, batches and weights.

- ``mean_estimate`` of every estimator with draws (rand_k with a draw per
  chunk and shared, Rand-k-Spatial, Rand-Proj-Spatial's srht shared and per
  chunk, subsample and gauss, SparseProj, wangni, induced) within relative
  L2 ``MEAN_RTOL``; measured at most 1.0e-6 (gauss: two LAPACK
  eigendecompositions), the CG decodes ran the same iterations. wangni's
  packing chooses among kept values that are equal but for rounding
  (tests/test_torch_baselines.py), so its case gives every kept coordinate
  a slot;
- the eigenvalue banks (srht, gauss, sparse) within ``BANK_RTOL`` of the
  largest eigenvalue (two LAPACK ``eigvalsh``; measured 6.1e-7);
- one ``run_rounds`` on the dme task: the byte ledger exactly, mse within
  relative 1e-5;
- the int8 and correlated quantizers' payloads bitwise, the drift task's
  client noise within ``NORMAL_ATOL``;
- a ``SyntheticLM`` batch bitwise (tokens, non-IID skew; the embeddings
  table within the normal draw's tolerance), the serve CLI's prompts
  bitwise, and ``init_params`` of tiny configs within ``NORMAL_ATOL``.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import beta as jbeta
from repro.core import codec as jcodec
from repro.data import synthetic as jsynth
from repro.fl import rounds as jrounds
from repro.fl import tasks as jtasks
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.core import beta as tbeta
from repro_torch.core import codec as tcodec
from repro_torch.core import random as prand
from repro_torch.data import synthetic as tsynth
from repro_torch.fl import rounds as trounds
from repro_torch.fl import tasks as ttasks
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf

N, C, D, K, SEED = 4, 3, 64, 8, 7
BANK_TRIALS = 16
MEAN_RTOL, BANK_RTOL, NORMAL_ATOL = 1e-5, 1e-6, 1e-6
CASES = {
    "rand_k_per_chunk": ("rand_k", dict()),
    "rand_k_shared": ("rand_k", dict(shared_randomness=True)),
    "rand_k_spatial": ("rand_k_spatial", dict(transform="avg")),
    "srht_shared": ("rand_proj_spatial", dict(transform="avg")),
    "srht_per_chunk": ("rand_proj_spatial", dict(transform="avg", shared_randomness=False)),
    "subsample": ("rand_proj_spatial", dict(transform="avg", projection="subsample",
                                            shared_randomness=False)),
    "gauss": ("rand_proj_spatial", dict(transform="avg", projection="gauss")),
    "sparse_proj": ("sparse_proj", dict(transform="avg", s=4)),
    "wangni": ("wangni", dict(capacity=D / K)),
    "induced": ("induced", dict()),
}


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


def _xs() -> np.ndarray:
    rng = np.random.default_rng(0)
    common = rng.standard_normal((C, D))
    return (common[None] + 0.5 * rng.standard_normal((N, C, D))).astype(np.float32)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def jax_means():
    """Every case's JAX mean estimate, as ONE compiled program."""
    def everything(x):
        return {name: jcodec.build(est, k=K, d_block=D, **kw).mean_estimate(
            jax.random.key(SEED), x) for name, (est, kw) in CASES.items()}

    with _cheap_compiles():
        return jax.tree.map(np.asarray, jax.jit(everything)(jnp.asarray(_xs())))


@pytest.mark.parametrize("case", list(CASES))
def test_mean_estimate_seeded_matches_jax(jax_means, case):
    est, kw = CASES[case]
    got = tcodec.build(est, k=K, d_block=D, **kw).mean_estimate(
        SEED, torch.from_numpy(_xs()), device="cpu")
    assert got.shape == (C, D)
    assert _rel(got, jax_means[case]) <= MEAN_RTOL


@pytest.mark.parametrize("projection", ("srht", "gauss", "sparse4"))
def test_beta_bank_seeded_matches_jax(projection):
    want = jbeta._simulate_bank(N, K, D, BANK_TRIALS, 0, projection)
    got = tbeta.simulate_bank(N, K, D, BANK_TRIALS, 0, device="cpu", projection=projection)
    assert got.shape == want.shape == (BANK_TRIALS, N * K)
    assert np.abs(got - want).max() <= BANK_RTOL * np.abs(want).max()


def test_run_rounds_seeded_matches_jax():
    def run(tasks, codec, rounds, **dev):
        task = tasks.get_task("dme", n_clients=N, d=200, rho=0.9, seed=3, **dev)
        spec = codec.build("rand_proj_spatial", k=K, d_block=D, transform="avg")
        return rounds.run_rounds(task, spec, cfg=rounds.RoundConfig(n_rounds=3, seed=SEED),
                                 **dev)

    with _cheap_compiles():
        _, jh = run(jtasks, jcodec, jrounds)
    _, th = run(ttasks, tcodec, trounds, device="cpu")
    assert th.bytes == [int(b) for b in jh.bytes] and th.total_bytes == jh.total_bytes
    np.testing.assert_allclose(th.mse, jh.mse, rtol=1e-5, atol=0)


def test_quantizer_dithers_seeded_match_jax():
    """Int8Quant's dither (fold_in(qkey, salt)) and CorrelatedQuant's cohort
    field (fold_in(round key, cohort salt)) are JAX's uniforms, so the int8
    payloads agree bit for bit (JAX eager: under jit XLA turns the scale's
    division by 127 into a multiply, one ulp off)."""
    from repro.core.codec import quantizers as jquant

    v = np.random.default_rng(1).standard_normal((C, 37)).astype(np.float32)
    qkey, jqkey = prand.fold_in(prand.key(SEED), 3), jax.random.fold_in(jax.random.key(SEED), 3)
    for name in ("Int8Quant", "CorrelatedQuant"):
        extra = {"round_key": SEED, "client_id": 3} if name == "CorrelatedQuant" else {}
        jextra = dict(extra, round_key=jax.random.key(SEED)) if extra else {}
        got = getattr(tcodec, name)().encode(qkey, {"vals": torch.from_numpy(v)}, ("vals",),
                                             **extra)
        want = getattr(jquant, name)().encode(jqkey, {"vals": jnp.asarray(v)}, ("vals",),
                                              **jextra)
        for arr in ("vals", "vals_scale"):
            np.testing.assert_array_equal(got[arr].numpy(), np.asarray(want[arr]), err_msg=name)


def test_drift_noise_seeded_matches_jax():
    """The drift task's per-round client noise (fl/tasks.py) is JAX's
    normal draw of the round key."""
    kw = dict(n_clients=N, d=D, rho=0.9, seed=2)
    jt, tt = jtasks.get_task("drift", **kw), ttasks.get_task("drift", device="cpu", **kw)
    with _cheap_compiles():
        want = jt.client_vectors(jt.init(None), jax.random.fold_in(jax.random.key(SEED), 1))
    got = tt.client_vectors(tt.init(None), prand.fold_in(prand.key(SEED), 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=NORMAL_ATOL)


def test_synthetic_batch_bitwise():
    for kw in (dict(n_clients=3, non_iid=0.5), dict(n_clients=0)):
        spec = dict(vocab_size=50, seq_len=9, batch=2, seed=4, **kw)
        with _cheap_compiles():  # jitted, as the JAX package's batch iterator runs it
            want = jax.jit(jsynth.SyntheticLM(**spec).batch_at)(5)
        got = tsynth.SyntheticLM(**spec).batch_at(5, "cpu")
        for name in ("inputs", "labels"):
            assert got[name].dtype == torch.int32
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    spec = dict(vocab_size=50, seq_len=9, batch=2, n_clients=2, seed=4, embed_dim=8)
    with _cheap_compiles():
        want = jax.jit(jsynth.SyntheticLM(**spec).batch_at)(1)["inputs"]
    got = tsynth.SyntheticLM(**spec).batch_at(1, "cpu")["inputs"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=NORMAL_ATOL)


def test_serve_prompts_are_jax_cli_prompts():
    cfg = tconfigs.preset_config("gemma3-4b", "tiny")
    params = ttf.init_params(cfg, 0, device="cpu")
    res = tserve.serve(cfg, params, batch=2, prompt_len=8, gen=1, seed=3, device="cpu")
    want = jax.random.randint(jax.random.key(4), (2, 8), 0, cfg.vocab_size)
    np.testing.assert_array_equal(res["prompts"].numpy(), np.asarray(want))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ("musicgen-medium", "mamba2-130m"))
def test_init_params_seeded_matches_jax(arch):
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    with _cheap_compiles():  # one program: op by op, each leaf's shape compiles its own
        want = dict(_leaves(jax.jit(lambda k: jtf.init_params(jcfg, k))(jax.random.key(5))))
    got = dict(_leaves(ttf.init_params(tconfigs.preset_config(arch, "tiny"), 5, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        w = np.asarray(want[path], np.float32)
        assert tuple(leaf.shape) == w.shape, path
        np.testing.assert_allclose(leaf.float().numpy(), w, rtol=0, atol=NORMAL_ATOL,
                                   err_msg=str(path))
    key = prand.key(5)
    assert torch.equal(ttf.init_params(tconfigs.preset_config(arch, "tiny"), key)["embed"],
                       got[("embed",)])


def test_bank_cache_is_keyed_by_generator(tmp_path, monkeypatch):
    """A bank's file name carries its generator, so a bank of the port's
    earlier counter hash, cached under the generator-less name, is never
    read for a threefry run."""
    monkeypatch.setattr(tbeta, "_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tbeta, "_BANKS", {})
    stale = np.full((8, 8), 7.0, np.float32)
    np.save(tmp_path / "srht_eigs_n2_k4_d16_t8_s0.npy", stale)
    bank = tbeta.srht_eig_bank(2, 4, 16, trials=8, device="cpu")
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["srht_eigs_n2_k4_d16_t8_s0.npy", "threefry_srht_eigs_n2_k4_d16_t8_s0.npy"]
    assert not np.array_equal(bank, stale)
    assert np.array_equal(bank, tbeta.simulate_bank(2, 4, 16, 8, 0, device="cpu"))
    monkeypatch.setattr(tbeta, "_BANKS", {})  # read back from its own file
    assert np.array_equal(tbeta.srht_eig_bank(2, 4, 16, trials=8, device="cpu"), bank)
