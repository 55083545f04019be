"""Whole models with Mamba (SSD) layers and the routed MoE FFN: the port
against the JAX package, on the CPU, float32.

Tiny mamba2-130m (2 SSD blocks, chunk 8, tied embedding), tiny
deepseek-moe-16b (a dense prologue, then MoE blocks of 8 experts, top 2,
one shared expert) and tiny jamba-v0.1-52b (two period-8 blocks of 7 Mamba
layers and 1 attention layer, MoE on the odd layers), with parameters from
the init's recipes drawn with numpy and carried across by
``interop.params_from_numpy``:

- at remat by block: the forward's logits, the loss (``loss_fn``'s, written out on the JAX
  side to return its logits from the same trace) and every gradient leaf on a
  token batch of sequence 16 (two SSD chunks; some labels -1, ignored),
  within relative L2 1e-4;
- a prefill of 12-token prompts (logits and every cache leaf: the KV
  caches, the Mamba conv histories and float32 SSM states), then 6 greedy
  decode steps (tokens equal; logits and every cache leaf after each step),
  within rtol 1e-4 / atol 1e-5; the Mamba caches also through
  ``interop.cache_from_numpy``.

The JAX side is one jitted program a step kind an arch (gradients, prefill,
decode), compiled without XLA's costly passes.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import transformer as ttf
from repro_torch.train import make_decode_step, make_prefill_step

ARCHS = ("mamba2-130m", "deepseek-moe-16b", "jamba-v0.1-52b")
BATCH, SEQ, PROMPT, STEPS = 2, 16, 12, 6
TOL, RTOL, ATOL = 1e-4, 1e-4, 1e-5


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


def _cfgs(arch):
    """The tiny preset with remat by block, as the published configs train
    (it changes no number; JAX compiles it faster)."""
    return (jconfigs.reduce_for_smoke(jconfigs.get_config(arch)).replace(remat="block"),
            tconfigs.preset_config(arch, "tiny").replace(remat="block"))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    labels[:, :3] = -1
    return {"inputs": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "labels": labels}


def _init_params(cfg, seed: int):
    """The init's recipes (repro/models/transformer.py ``_init_leaf``) on
    numpy's draws, in the layout both packages share."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        if d.init in ("zeros", "ones"):
            return np.full(d.shape, float(d.init == "ones"), np.float32)
        if d.init == "a_log":
            return np.broadcast_to(np.log(np.linspace(1.0, 16.0, d.shape[-1])),
                                   d.shape).astype(np.float32)
        if d.init == "dt_bias":
            dt = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), d.shape[-1]))
            return np.broadcast_to(np.log(np.expm1(dt)), d.shape).astype(np.float32)
        scale = d.scale / max(1.0, 48.0 ** 0.5) if d.init == "scaled" else d.scale
        return (scale * rng.standard_normal(d.shape)).astype(np.float32)

    return ttf.map_defs(leaf, ttf.param_defs(cfg))


@functools.cache
def _jax_side():
    """Per arch, as numpy: the params, the batch and its logits, loss and
    gradients; the prompts, the prefill's logits and cache, and the greedy
    decode's tokens, logits and caches."""

    def grads(params, cfg, batch):
        def loss_fn(p):  # jtf.loss_fn, written out to return its logits from the one trace
            logits, aux = jtf.forward(p, cfg, batch["inputs"])
            labels = batch["labels"]
            valid = labels >= 0
            logp = jax.nn.log_softmax(logits, axis=-1)
            nll = -jnp.take_along_axis(logp, jnp.where(valid, labels, 0)[..., None], -1)[..., 0]
            ce = jnp.where(valid, nll, 0.0).sum() / jnp.maximum(valid.sum(), 1)
            return ce + cfg.router_aux_weight * aux, logits

        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return logits, loss, g

    def prefill_fresh(params, cfg, prompts):
        return jtf.prefill(params, cfg, jtf.init_cache(cfg, BATCH, PROMPT + STEPS), prompts)

    grads = jax.jit(grads, static_argnums=1)
    prefill = jax.jit(prefill_fresh, static_argnums=1)
    decode = jax.jit(jtf.decode_step, static_argnums=1)
    out = {}
    with _cheap_compiles():
        for i, arch in enumerate(ARCHS):
            cfg = _cfgs(arch)[0]
            params = _init_params(_cfgs(arch)[1], 200 + i)
            batch = _batch(cfg, 40 + i)
            logits, loss, g = grads(params, cfg, batch)
            prompts = np.random.default_rng(50 + i).integers(
                0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
            lg, cache = prefill(params, cfg, prompts)
            res = {"params": params, "batch": batch, "logits": logits, "loss": loss,
                   "grads": g, "prompts": prompts, "prefill_logits": lg, "cache": cache}
            tok = jnp.argmax(lg[:, -1, :cfg.vocab_size], axis=-1)[:, None].astype(jnp.int32)
            toks, step_logits, caches = [tok[:, 0]], [], []
            for j in range(STEPS):
                pos = jnp.full((BATCH, 1), PROMPT + j, jnp.int32)
                lg, cache = decode(params, cfg, cache, tok, pos)
                tok = jnp.argmax(lg[:, -1, :cfg.vocab_size], axis=-1)[:, None].astype(jnp.int32)
                toks.append(tok[:, 0])
                step_logits.append(lg[:, 0])
                caches.append(cache)
            out[arch] = {**res, "tokens": jnp.stack(toks, 1),
                         "step_logits": jnp.stack(step_logits), "step_caches": caches}
    return jax.tree.map(np.asarray, out)


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL, atol=ATOL, err_msg=what)


def _close_caches(got, want, what: str) -> None:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want), what
    for path, leaf in want.items():
        _close(got[path], leaf, f"{what} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_gradients_match_jax(arch):
    want = _jax_side()[arch]
    cfg = _cfgs(arch)[1]
    params = interop.params_from_numpy(cfg, want["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in want["batch"].items()}
    logits, _ = ttf.forward(params, cfg, batch["inputs"])
    assert _rel(logits, want["logits"]) <= TOL
    leaves = [t.requires_grad_() for _, t in _leaves(params)]
    loss, _ = ttf.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(float(loss.detach()) - float(want["loss"])) <= TOL * float(want["loss"])
    want_grads = list(_leaves(want["grads"]))
    assert len(want_grads) == len(grads)
    for (path, ref), g in zip(want_grads, grads):
        g = torch.zeros(ref.shape) if g is None else g
        assert np.isfinite(g.numpy()).all(), path
        assert _rel(g, ref) <= TOL, path


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch):
    want = _jax_side()[arch]
    cfg = _cfgs(arch)[1]
    params = interop.params_from_numpy(cfg, want["params"], "cpu")
    cache = ttf.init_cache(cfg, BATCH, PROMPT + STEPS, device="cpu")
    logits, cache = make_prefill_step(cfg)(params, cache, torch.from_numpy(want["prompts"]))
    _close(logits, want["prefill_logits"], "prefill logits")
    _close_caches(cache, want["cache"], "prefill cache")
    decode = make_decode_step(cfg)
    tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None].int()
    toks, step_logits = [tok[:, 0]], []
    for i in range(STEPS):
        pos = torch.full((BATCH, 1), PROMPT + i, dtype=torch.int32)
        nxt, lg, cache = decode(params, cache, tok, pos)
        _close_caches(cache, want["step_caches"][i], f"step {i} cache")
        tok = nxt[:, None].int()
        toks.append(nxt)
        step_logits.append(lg[:, 0])
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), want["tokens"])
    _close(torch.stack(step_logits), want["step_logits"], "decode logits")


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_mamba_caches_round_trip_through_interop(arch):
    want = _jax_side()[arch]
    cfg = _cfgs(arch)[1]
    cache = interop.cache_from_numpy(cfg, want["cache"], BATCH, PROMPT + STEPS, "cpu")
    like = ttf.init_cache(cfg, BATCH, PROMPT + STEPS, device="meta")
    for (path, got), (_, ref), (_, meta) in zip(_leaves(cache), _leaves(want["cache"]),
                                                 _leaves(like)):
        assert got.dtype == meta.dtype, path  # ssm float32, conv the compute dtype
        _close(got, ref, path)
    assert any(path.endswith("/ssm") for path, _ in _leaves(cache))
