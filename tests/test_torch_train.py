"""The port's training path (repro_torch: optim, data, transformer.loss_fn,
train.train_step, train.checkpoint, train.supervisor, launch.train) against
the JAX package's, on the CPU, float32.

Tiny musicgen-medium (MHA, the plain GeLU FFN, untied head) and tiny
gemma3-4b (GQA, window-8 layers, tied embedding), with the JAX package's
``init_params`` carried across by ``interop.params_from_numpy`` and numpy
token batches (some labels -1, ignored) fed to both:

- ``loss_fn``'s loss (within 1e-6) and every gradient leaf (relative L2
  1e-5) against ``jax.value_and_grad`` at sequence 32 (the kv-blocked
  attention: ``attn_kv_block`` 16) and per client against ``jax.vmap`` of
  it at sequence 16 (the dense attention); the flash route's plain version
  against JAX's oracle;
- 3 plain steps, 3 DME steps through ``identity`` and 3 through ``top_k``
  with error feedback against JAX's: parameters, ``mu``, ``nu``, ``step``,
  ``grad_norm``, ``lr`` and the ``ef`` buffer within 1e-5;
- port only: ``remat="block"`` bitwise ``remat="none"``; the
  Rand-Proj-Spatial step bitwise its own composition (per-client gradients,
  ``compressed_mean_tree`` at ``fold_in(key(seed), step)``, AdamW); the data
  pipeline's determinism and non-IID skew on the port's own draws; the
  checkpoint and supervisor twins of tests/test_fault_tolerance.py on tiny
  musicgen-medium; the CLI, and its default arch (mamba2-130m) for a step;
  the refusals.

The JAX side is a few jitted programs compiled without XLA's costly passes
(one for the gradients and one for each step kind an arch runs).
"""
from __future__ import annotations

import contextlib
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.launch.train import preset_config as jpreset
from repro.models import transformer as jtf
from repro.optim import SGDM as JSGDM
from repro.optim import AdamW as JAdamW
from repro.train import make_train_step as jmake_train_step
from repro.train.train_step import init_train_state as jinit_train_state
import repro_torch
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import codec as tcodec
from repro_torch.core import random as prand
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.dist import collectives
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttf
from repro_torch.optim import SGDM, AdamW
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train import train_step as ttrain_step
from repro_torch.train.supervisor import FaultPlan, Supervisor

ARCHS = ("musicgen-medium", "gemma3-4b")
SEQS = {"blocked": 32, "dense": 16}  # tiny attn_kv_block is 16
CLIENTS, BATCH, N_STEPS, SEED = 2, 2, 3, 5
# The CLI's AdamW (lr 3e-3, 20 warmup steps) with weight decay, and eps 1e-6
# for the default 1e-8. AdamW divides each gradient element g by |g| + eps,
# which is ill-conditioned where |g| is near eps (tiny attention and FFN
# gradients at init): at eps 1e-8 it turns the two packages' float32
# rounding of the gradient (under 7e-7 relative L2 a leaf) into 1.3e-5 of a
# gemma parameter leaf after one step (4.4e-5 at lr 1e-2), and the
# trajectories part from there; at 1e-6 every reading stays under 2.8e-6.
# The default eps is held against JAX on equal gradients
# (test_optimizers_match_jax_eagerly), and the port's step at the default
# eps against its own composition, bitwise.
OPT = dict(lr=3e-3, warmup_steps=20, weight_decay=0.01, eps=1e-6)
TOL, LOSS_TOL = 1e-5, 1e-6
BATCH_SEEDS = {"plain": 20, "top_k_ef": 21, "identity": 22}
# the step kinds each arch runs against JAX: name -> (codec args or None, attention)
STEPS = {
    "musicgen-medium": {"plain": (None, "blocked"),
                        "top_k_ef": (("top_k", dict(k=16, d_block=256, ef=True)), "blocked")},
    "gemma3-4b": {"plain": (None, "dense"),
                  "identity": (("identity", dict(d_block=256)), "dense")},
}


def _cfgs(arch, **over):
    return jpreset(arch, "tiny").replace(**over), tconfigs.preset_config(arch, "tiny").replace(**over)


@contextlib.contextmanager
def _cheap_compiles():
    """Compile the JAX reference without XLA's costly optimisation passes:
    it runs once, and they change no float semantics."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


def _batches(vocab: int, seq: int, lead: tuple, n: int, seed: int) -> list:
    """``n`` numpy token batches of shape lead + (seq,); a few labels -1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, lead + (seq + 1,)).astype(np.int32)
        labels = toks[..., 1:].copy()
        labels[..., -3:][rng.random(labels[..., -3:].shape) < 0.5] = -1
        out.append({"inputs": toks[..., :-1].copy(), "labels": labels})
    return out


def _step_batches(arch: str, name: str) -> list:
    spec, attn = STEPS[arch][name]
    lead = (BATCH,) if spec is None else (CLIENTS, BATCH)
    return _batches(_cfgs(arch)[0].vocab_size, SEQS[attn], lead, N_STEPS, seed=BATCH_SEEDS[name])


def _jax_grads(cfg, flash_cfg):
    vg = jax.value_and_grad(jtf.loss_fn, has_aux=True)

    def run(params, b32, cb16):
        (l32, _), g32 = vg(params, cfg, b32)
        (lc, _), gc = jax.vmap(lambda b: vg(params, cfg, b))(cb16)
        out = {"l32": l32, "g32": g32, "lc": lc, "gc": gc}
        if flash_cfg is not None:
            (out["lf"], _), out["gf"] = vg(params, flash_cfg, b32)
        return out

    return jax.jit(run)


def _jax_spec(name):
    spec = STEPS_BY_NAME[name][0]
    return None if spec is None else jcodec.build(spec[0], **spec[1])


STEPS_BY_NAME = {name: v for steps in STEPS.values() for name, v in steps.items()}


@functools.cache
def _jax_side():
    """Per arch, as numpy: the params, the gradient batches and JAX's losses
    and gradients, and for each step kind its batches and the state,
    metrics and parameters after every step."""
    out = {}
    with _cheap_compiles():
        for a, arch in enumerate(ARCHS):
            cfg = _cfgs(arch)[0]
            params = jtf.init_params(cfg, jax.random.key(10 + a, impl="rbg"))
            b32 = _batches(cfg.vocab_size, SEQS["blocked"], (BATCH,), 1, seed=a)[0]
            cb16 = _batches(cfg.vocab_size, SEQS["dense"], (CLIENTS, BATCH), 1, seed=a + 5)[0]
            flash = cfg.replace(attn_impl="flash") if arch == "gemma3-4b" else None
            res = {"params": params, "b32": b32, "cb16": cb16,
                   "grads": _jax_grads(cfg, flash)(params, b32, cb16), "steps": {}}
            opt = JAdamW(**OPT)
            for name in STEPS[arch]:
                spec = _jax_spec(name)
                step = jax.jit(jmake_train_step(cfg, opt, dme_spec=spec, seed=SEED))
                p, state = params, jinit_train_state(cfg, opt, params, spec, CLIENTS)
                trail = []
                for i, batch in enumerate(_step_batches(arch, name)):
                    p, state, metrics = step(p, state, batch, i)
                    trail.append({"params": p, "state": state, "metrics": metrics})
                res["steps"][name] = trail
            out[arch] = res
    return jax.tree.map(np.asarray, out)


def _rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want, np.float64))
    err = float((got.double() - want).norm())
    return err / max(float(want.norm()), 1e-30)


def _close_tree(got, want, tol: float, what: str) -> None:
    """Every leaf of ``got`` (tensors) within relative L2 ``tol`` of
    ``want`` (numpy), leaf by leaf in ravel order."""
    from repro_torch.core import chunking

    g, w = chunking.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == np.shape(b), f"{what} leaf {i}"
        assert _rel(a, b) <= tol, f"{what} leaf {i}: {_rel(a, b)}"


def _port(arch):
    """(port cfg, params carried across) of ``arch``."""
    res = _jax_side()[arch]
    cfg = _cfgs(arch)[1]
    return cfg, interop.params_from_numpy(cfg, res["params"], "cpu")


def _t(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------------ loss and grads


@pytest.mark.parametrize("attn", ["blocked", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, attn):
    """At 32 tokens one batch against value_and_grad; at 16 each client's
    batch against JAX's vmap of it (the per-client gradients)."""
    res = _jax_side()[arch]
    cfg, params = _port(arch)
    want = res["grads"]
    if attn == "blocked":
        cases = [(res["b32"], want["l32"], want["g32"])]
    else:
        cases = [({k: v[i] for k, v in res["cb16"].items()}, want["lc"][i],
                  jax.tree.map(lambda g, i=i: g[i], want["gc"])) for i in range(CLIENTS)]
    for batch, loss_want, grads_want in cases:
        loss, metrics, grads = ttrain_step._value_and_grad(params, cfg, _t(batch))
        assert abs(float(loss) - float(loss_want)) <= LOSS_TOL * abs(float(loss_want))
        assert float(metrics["ce"]) == float(loss) and float(metrics["aux"]) == 0.0
        _close_tree(grads, grads_want, TOL, f"{arch} {attn} gradients")


def test_flash_plain_route_is_differentiable_and_matches_jax():
    """attn_impl="flash" on the CPU takes the plain version, which autograd
    differentiates; JAX's CPU route is its oracle."""
    res = _jax_side()["gemma3-4b"]
    cfg, params = _port("gemma3-4b")
    loss, _, grads = ttrain_step._value_and_grad(params, cfg.replace(attn_impl="flash"),
                                                 _t(res["b32"]))
    assert abs(float(loss) - float(res["grads"]["lf"])) <= LOSS_TOL * float(res["grads"]["lf"])
    _close_tree(grads, res["grads"]["gf"], TOL, "flash gradients")
    wq = grads["blocks"]["l00"]["attn"]["wq"]
    assert float(wq.norm()) > 0.0


@pytest.mark.cuda
def test_flash_kernel_route_refuses_tensors_that_require_grad():
    """Neither flash kernel has a backward: on tensors that require grad the
    kernel route raises instead of returning a result autograd cannot see
    through; under no_grad it launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((2, 64, 64), generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        q.requires_grad_()
        with pytest.raises(NotImplementedError, match=r"ROADMAP A\.11"):
            ops.flash_attention(q, k, v, rep=1)
        with torch.no_grad():
            assert ops.flash_attention(q, k, v, rep=1).shape == q.shape
    cfg = tconfigs.preset_config("gemma3-4b", "tiny").replace(attn_impl="flash")
    params = ttf.init_params(cfg, 0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device="cuda")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.11"):
        make_train_step(cfg, AdamW(), device="cuda")(
            params, {"opt": AdamW().init(params)}, {"inputs": tokens, "labels": tokens}, 0)


def test_remat_block_changes_nothing():
    cfg, params = _port("musicgen-medium")
    batch = _t(_jax_side()["musicgen-medium"]["b32"])
    plain = ttrain_step._value_and_grad(params, cfg, batch)
    remat = ttrain_step._value_and_grad(params, cfg.replace(remat="block"), batch)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(*(jax.tree.leaves(r[2]) for r in (plain, remat))):
        assert torch.equal(a, b)


# -------------------------------------------------------------------- steps


def _port_run(arch, name, params, cfg):
    spec_args = STEPS[arch][name][0]
    spec = None if spec_args is None else tcodec.build(spec_args[0], **spec_args[1])
    opt = AdamW(**OPT)
    step = make_train_step(cfg, opt, dme_spec=spec, seed=SEED, device="cpu")
    state = init_train_state(cfg, opt, params, spec, CLIENTS)
    trail = []
    for i, batch in enumerate(_step_batches(arch, name)):
        params, state, metrics = step(params, state, _t(batch), i)
        trail.append({"params": params, "state": state, "metrics": metrics})
    return trail


@pytest.mark.parametrize("arch,name", [(a, n) for a in ARCHS for n in STEPS[a]])
def test_steps_match_jax(arch, name):
    """3 steps from the same parameters: the plain step (no client axis)
    and the DME step through a deterministic codec (identity; top_k with
    error feedback and its ef buffer)."""
    cfg, params = _port(arch)
    want = _jax_side()[arch]["steps"][name]
    got = _port_run(arch, name, params, cfg)
    for i, (g, w) in enumerate(zip(got, want)):
        what = f"{arch} {name} step {i}"
        _close_tree(g["params"], w["params"], TOL, f"{what} params")
        for moment in ("mu", "nu"):
            _close_tree(g["state"]["opt"][moment], w["state"]["opt"][moment], TOL,
                        f"{what} {moment}")
        assert int(g["state"]["opt"]["step"]) == int(w["state"]["opt"]["step"]) == i + 1
        assert g["state"]["opt"]["step"].dtype == torch.int32
        assert set(g["state"]) == set(w["state"]), what
        if "ef" in w["state"]:
            assert _rel(g["state"]["ef"], w["state"]["ef"]) <= TOL, f"{what} ef"
            assert float(g["state"]["ef"].norm()) > 0.0
        assert set(g["metrics"]) == set(w["metrics"]), what
        for key, value in w["metrics"].items():
            assert abs(float(g["metrics"][key]) - float(value)) <= TOL * max(abs(float(value)),
                                                                             1e-30), f"{what} {key}"


def test_rand_proj_spatial_step_is_its_own_composition():
    """The DME step on the default codec equals, bit for bit, the port's own
    per-client gradients, compressed_mean_tree at fold_in(key(seed), step)
    and AdamW: the step adds nothing to the estimator, and no draw has to be
    injected."""
    cfg, params = _port("musicgen-medium")
    spec = tcodec.build("rand_proj_spatial", k=16, d_block=256, transform="avg")
    opt = AdamW(lr=3e-3, warmup_steps=20)  # the CLI's
    step = make_train_step(cfg, opt, dme_spec=spec, seed=SEED, device="cpu")
    state = init_train_state(cfg, opt, params, spec, CLIENTS)
    for i, batch in enumerate(_step_batches("musicgen-medium", "top_k_ef")[:2]):
        batch = _t(batch)
        new_params, new_state, metrics = step(params, state, batch, i)
        per_client = [ttrain_step._value_and_grad(params, cfg, {k: v[c] for k, v in batch.items()})
                      for c in range(CLIENTS)]
        stacked = jax.tree.map(lambda *g: torch.stack(g), *(pc[2] for pc in per_client))
        key = prand.fold_in(prand.key(SEED, "cpu"), i)
        mean, info, _ = collectives.compressed_mean_tree(spec, key, stacked, device="cpu")
        want_params, want_opt, om = opt.update(mean, state["opt"], params)
        for a, b in zip(jax.tree.leaves(new_params), jax.tree.leaves(want_params)):
            assert torch.equal(a, b)
        for a, b in zip(jax.tree.leaves(new_state["opt"]), jax.tree.leaves(want_opt)):
            assert torch.equal(a, b)
        assert torch.equal(metrics["grad_norm"], om["grad_norm"])
        assert float(metrics["loss"]) == float(torch.stack([pc[0] for pc in per_client]).mean())
        assert metrics["compression_ratio"] == info["full_bytes"] / info["payload_bytes_per_client"]
        assert metrics["compression_ratio"] == 16 * info["d_flat"] / (info["n_chunks"] * 256)
        params, state = new_params, new_state


def test_ownership_and_overlap_steps_are_bitwise_the_plain_exchange():
    cfg, params = _port("gemma3-4b")
    spec = tcodec.build("rand_proj_spatial", k=16, d_block=256, transform="avg")
    opt = AdamW(**OPT)
    state = init_train_state(cfg, opt, params, spec, CLIENTS)
    batch = _t(_step_batches("gemma3-4b", "identity")[0])
    runs = {name: make_train_step(cfg, opt, dme_spec=spec, device="cpu", **kw)(
        params, state, batch, 0) for name, kw in (
            ("sync", {}), ("owners", dict(dme_ownership=3)),
            ("overlap", dict(dme_overlap=True, dme_overlap_tile=512)))}
    for name in ("owners", "overlap"):
        for a, b in zip(jax.tree.leaves(runs[name][0]), jax.tree.leaves(runs["sync"][0])):
            assert torch.equal(a, b), name
    assert runs["owners"][2]["intra_pod_reduction"] > 0
    assert "intra_pod_reduction" not in runs["sync"][2]


def _small_tree(rng):
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": [rng.standard_normal(4).astype(np.float32), np.array(rng.standard_normal(), np.float32)]}


@pytest.mark.parametrize("name", ["adamw_no_clip", "sgdm", "sgdm_momentum"])
def test_optimizers_match_jax_eagerly(name):
    """The optimizers alone on a small tree, JAX run op by op: AdamW without
    clipping and with weight decay, SGDM with and without momentum."""
    jopt, topt = {"adamw_no_clip": (JAdamW(lr=0.1, grad_clip=0.0, weight_decay=0.1, warmup_steps=3),
                                     AdamW(lr=0.1, grad_clip=0.0, weight_decay=0.1, warmup_steps=3)),
                  "sgdm": (JSGDM(lr=0.1), SGDM(lr=0.1)),
                  "sgdm_momentum": (JSGDM(lr=0.1, momentum=0.9), SGDM(lr=0.1, momentum=0.9))}[name]
    rng = np.random.default_rng(2)
    p_np = _small_tree(rng)
    jp, tp = p_np, jax.tree.map(torch.from_numpy, p_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = _small_tree(rng)
        jp, js, jm = jopt.update(g, js, jp)
        tp, ts, tm = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
    _close_tree(tp, jax.tree.map(np.asarray, jp), TOL, name)
    _close_tree(ts, jax.tree.map(np.asarray, js), TOL, name)
    for key in jm:
        assert abs(float(tm[key]) - float(jm[key])) <= TOL * abs(float(jm[key]))


# --------------------------------------------------------------- interop


def test_train_state_carries_across_from_jax():
    res = _jax_side()
    cfg = _cfgs("musicgen-medium")[1]
    for name in ("plain", "top_k_ef"):
        want = res["musicgen-medium"]["steps"][name][-1]["state"]
        got = interop.train_state_from_numpy(cfg, want, "cpu")
        assert set(got) == set(want) and got["opt"]["step"].dtype == torch.int32
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), b)
    state = res["musicgen-medium"]["steps"]["top_k_ef"][-1]["state"]
    with pytest.raises(ValueError, match="opt/mu"):
        interop.train_state_from_numpy(_cfgs("gemma3-4b")[1], state, "cpu")
    with pytest.raises(ValueError, match="ef"):
        interop.train_state_from_numpy(cfg, {**state, "ef": state["ef"][:, :-1]}, "cpu")
    with pytest.raises(ValueError, match="step"):
        interop.train_state_from_numpy(
            cfg, {"opt": {**state["opt"], "step": np.zeros(2, np.int32)}}, "cpu")


# -------------------------------------------------------------------- data


def test_data_pipeline_determinism_and_noniid():
    data = SyntheticLM(vocab_size=128, seq_len=16, batch=2, n_clients=3, seed=4)
    b1, b2 = data.batch_at(10, "cpu"), data.batch_at(10, "cpu")
    assert torch.equal(b1["inputs"], b2["inputs"]) and b1["inputs"].shape == (3, 2, 16)
    assert torch.equal(b1["inputs"][..., 1:], b1["labels"][..., :-1])
    assert b1["inputs"].dtype == torch.int32
    b3 = data.batch_at(11, "cpu")
    assert not torch.equal(b1["inputs"], b3["inputs"])
    assert [s for s, _ in zip(make_batch_iterator(data, 10, "cpu"), range(1))][0][0] == 10
    # non-IID skew shifts client marginals apart
    skew = SyntheticLM(vocab_size=128, seq_len=256, batch=2, n_clients=2, seed=4, non_iid=1.0)
    b = skew.batch_at(0, "cpu")
    h0 = np.bincount(b["inputs"][0].numpy().ravel(), minlength=128)
    h1 = np.bincount(b["inputs"][1].numpy().ravel(), minlength=128)
    overlap = np.minimum(h0, h1).sum() / h0.sum()
    iid = SyntheticLM(vocab_size=128, seq_len=256, batch=2, n_clients=2, seed=4)
    bi = iid.batch_at(0, "cpu")
    g0 = np.bincount(bi["inputs"][0].numpy().ravel(), minlength=128)
    g1 = np.bincount(bi["inputs"][1].numpy().ravel(), minlength=128)
    overlap_iid = np.minimum(g0, g1).sum() / g0.sum()
    assert overlap < overlap_iid


def test_data_pipeline_laws():
    """The stride walk's steps lie in 1-16 where no noise intervenes, about
    15 % of the tokens are noise, and embeddings mode looks tokens up in a
    fixed table."""
    data = SyntheticLM(vocab_size=4096, seq_len=512, batch=32, seed=1)
    toks = data.batch_at(3, "cpu")["inputs"].long()
    steps = (toks[:, 1:] - toks[:, :-1]) % 4096
    walk_share = float(((steps >= 1) & (steps <= 16)).float().mean())
    assert 0.70 < walk_share < 0.745  # both ends of a step walk: 0.85 ** 2 = 0.7225
    emb = SyntheticLM(vocab_size=64, seq_len=8, batch=2, n_clients=2, seed=1, embed_dim=16)
    b = emb.batch_at(0, "cpu")
    tok = SyntheticLM(vocab_size=64, seq_len=8, batch=2, n_clients=2, seed=1).batch_at(0, "cpu")
    assert b["inputs"].shape == (2, 2, 8, 16) and b["inputs"].dtype == torch.float32
    table = prand.normal(prand.key(1 ^ 0xE3BED), (64, 16)) * 0.05
    assert torch.equal(b["inputs"], table[tok["inputs"].long()])


# ------------------------------------------------- checkpoint and supervisor

TINY = tconfigs.preset_config("musicgen-medium", "tiny")
SUP_OPT = AdamW(lr=1e-2, warmup_steps=5)


def _mk_supervisor(tmp, n_clients=2, spec=None):
    spec = spec or tcodec.build("rand_proj_spatial", k=16, d_block=256)

    def make_step(n):
        return make_train_step(TINY, SUP_OPT, dme_spec=spec, device="cpu")

    def make_data(n):
        data = SyntheticLM(vocab_size=TINY.vocab_size, seq_len=32, batch=2, n_clients=n)
        return functools.partial(data.batch_at, device="cpu")

    def init_state():
        params = ttf.init_params(TINY, 0, device="cpu")
        return params, {"opt": SUP_OPT.init(params)}

    return Supervisor(
        make_step=make_step, make_data=make_data, init_state=init_state,
        ckpt_dir=str(tmp), n_clients=n_clients, ckpt_every=5, max_restarts=5,
    )


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.randn(3, 7).bfloat16(), "d": torch.zeros((), dtype=torch.int32)},
            "e": (torch.ones(2, dtype=torch.int64),)}
    ckpt.save(str(tmp_path), 3, tree)
    like = jax.tree.map(torch.zeros_like, tree)
    restored, step = ckpt.restore(str(tmp_path), like)
    assert step == 3
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="leaf"):
        ckpt.restore(str(tmp_path), {"a": like["a"], "z": like["b"], "e": like["e"]})
    # shardings= (ROADMAP A.9), once refused: None leaves keep the plain restore,
    # and a placement tree must match the target's leaves
    placed, _ = ckpt.restore(str(tmp_path), like,
                             shardings=jax.tree.map(lambda _: None, like))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(placed)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shardings has"):
        ckpt.restore(str(tmp_path), like, shardings={"a": None})


def test_checkpoint_keep_n_and_crash_safety(tmp_path):
    tree = {"x": torch.ones(4)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.steps(str(tmp_path)) == [4, 5]
    # a partial tmp dir must be ignored and cleaned
    os.makedirs(tmp_path / "step_000099.tmp_dead", exist_ok=True)
    ckpt.save(str(tmp_path), 6, tree, keep=2)
    assert 99 not in ckpt.steps(str(tmp_path))
    assert not any(".tmp_" in n for n in os.listdir(tmp_path))
    # a step directory without its meta (a crashed writer's) is not a checkpoint
    os.makedirs(tmp_path / "step_000100")
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_save_async_snapshots_before_it_returns(tmp_path):
    x = torch.arange(8, dtype=torch.float32)
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save_async(1, {"x": x})
    x.add_(100.0)  # the train loop changes the tensor in place
    saver.wait()
    restored, _ = ckpt.restore(str(tmp_path), {"x": torch.zeros(8)})
    assert torch.equal(restored["x"], torch.arange(8, dtype=torch.float32))


def test_supervisor_recovers_from_injected_failures(tmp_path):
    sup = _mk_supervisor(tmp_path / "ck")
    plan = FaultPlan(fail_at_steps=(7, 12))
    params, state, hist = sup.run(16, fault_plan=plan, log_every=1, log_fn=lambda *_: None)
    assert int(state["opt"]["step"]) >= 14  # made it to the end through 2 failures
    assert ckpt.latest_step(str(tmp_path / "ck")) == 15


def test_supervisor_resume_matches_uninterrupted_bitwise(tmp_path):
    """Crash-restore reproduces the uninterrupted trajectory bit for bit on
    the CPU (pure-function-of-step data + checkpointed state)."""
    a = _mk_supervisor(tmp_path / "a")
    p_a, s_a, _ = a.run(11, log_fn=lambda *_: None)
    b = _mk_supervisor(tmp_path / "b")
    p_b, s_b, _ = b.run(11, fault_plan=FaultPlan(fail_at_steps=(8,)), log_fn=lambda *_: None)
    for x, y in zip(jax.tree.leaves((p_a, s_a)), jax.tree.leaves((p_b, s_b))):
        assert torch.equal(x, y)


def test_elastic_resize(tmp_path):
    sup = _mk_supervisor(tmp_path / "ck", n_clients=4)
    plan = FaultPlan(resize_at={6: 2})
    params, state, _ = sup.run(10, fault_plan=plan, log_fn=lambda *_: None)
    assert sup.n_clients == 2
    assert int(state["opt"]["step"]) == 10


def test_cli_trains_recovers_resizes_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--arch", "musicgen-medium", "--clients", "3", "--batch", "2",
            "--seq", "16", "--k", "16", "--d-block", "256", "--ckpt-every", "4",
            "--ckpt-dir", str(tmp_path)]
    hist = tlaunch.main(argv + ["--steps", "12", "--inject-failures", "5", "--resize", "8:2"])
    out = capsys.readouterr().out
    assert "step 5 failed (injected node failure at step 5); restoring" in out
    assert "elastic resize 3 -> 2 at step 8" in out
    assert [s for s, _ in hist] == [0, 10] and all(np.isfinite([v for _, v in hist]))
    ck = tmp_path / "musicgen-medium_tiny"
    assert ckpt.latest_step(str(ck)) == 11
    hist = tlaunch.main(argv + ["--steps", "14"])
    assert "resumed from step 11" in capsys.readouterr().out
    assert hist == [] and ckpt.latest_step(str(ck)) == 13


def test_cli_default_arch_takes_a_step(tmp_path, capsys):
    """The CLI's default arch, mamba2-130m (tiny), trains: one DME step."""
    hist = tlaunch.main(["--device", "cpu", "--steps", "1", "--seq", "16",
                         "--ckpt-dir", str(tmp_path)])
    assert "mamba2-130m preset=tiny" in capsys.readouterr().out
    assert [s for s, _ in hist] == [0] and np.isfinite(hist[0][1])


# ---------------------------------------------------------------- refusals


def test_unported_options_raise():
    """Parameters placed over a data / model mesh axis, once refused here,
    train (tests/test_torch_placed.py) but not yet through the GPipe
    schedule, which raises naming its ROADMAP item; the schedule, once refused here, refuses only
    what the JAX package refuses (no ``pipe`` axis) and, in the CLI, a stage
    count that is not the world's; ``dme_impl="shard_map"``, once refused,
    takes the local route without a mesh, as in the JAX package."""
    cfg = _cfgs("musicgen-medium")[1]
    data_mesh = types.SimpleNamespace(axis_names=("pipe", "data"), devices=np.empty((1, 2)))
    with pytest.raises(ValueError, match="needs a mesh with a 'pipe' axis"):
        make_train_step(cfg, AdamW(), device="cpu", pipeline_stages=2)
    with pytest.raises(NotImplementedError, match=r"data or model axis.*ROADMAP A\.9\.4"):
        make_train_step(cfg, AdamW(), device="cpu", mesh=data_mesh, pipeline_stages=1)
    with pytest.raises(ValueError, match="dme_impl"):
        make_train_step(cfg, AdamW(), device="cpu", dme_impl="pmap")
    spec = tcodec.build("rand_k", k=4, d_block=64)
    params = ttf.init_params(cfg, 0, device="cpu")
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, batch=1, n_clients=2,
                        seed=0).batch_at(0, "cpu")
    want = make_train_step(cfg, AdamW(), dme_spec=spec, device="cpu")(
        params, {"opt": AdamW().init(params)}, batch, 0)[0]
    got = make_train_step(cfg, AdamW(), dme_spec=spec, dme_impl="shard_map", device="cpu")(
        params, {"opt": AdamW().init(params)}, batch, 0)[0]
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)))
    with pytest.raises(ValueError, match="2 ranks"):
        tlaunch.main(["--device", "cpu", "--arch", "gemma3-4b", "--pipeline-stages", "2"])


_ENTRY_POINTS = {
    "make_train_step": lambda: make_train_step(TINY, AdamW()),
    "batch_at": lambda: SyntheticLM(vocab_size=16, seq_len=4, batch=1).batch_at(0),
    "cli": lambda: tlaunch.main(["--arch", "musicgen-medium", "--steps", "1"]),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_training_entry_points_need_cuda_without_device(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert repro_torch.resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[name]()
