"""The port's serving path (repro_torch.models, train.serve_step) against the
JAX package's, on the CPU, float32.

Tiny gemma3-4b (13 layers: a 5:1 pattern of window-8 and global attention,
GQA 4 over 2, tied embeddings) with the JAX package's ``init_params``
carried across by ``interop.params_from_numpy``, through three prefill
branches: the flash-attention op (``attn_impl="flash"``; the plain version
on the CPU, the oracle on the JAX side), the kv-blocked online softmax
(``attn_kv_block`` 16 < the 24-token prompt) and, in a qwen-style tiny
config with nonzero QKV biases, the dense branch; all on a vocab of 500
padded to 512, which the greedy argmax must skip. For each: the prefill's logits and every cache leaf within rtol
1e-4 / atol 1e-5 of JAX's, then 6 greedy decode steps from prompt 24, past
the 8-slot ring buffer of the windowed layers, with equal tokens and logits
within the same tolerance. Port-only checks: the cache interop refuses a
wrong layout, the bf16 attention casts as JAX's does, ``gqa_repeat_kv``
changes no logits, and every arch's parameter count equals JAX's.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import preset_config as jpreset
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.train import make_decode_step, make_prefill_step

BATCH, PROMPT, STEPS = 2, 24, 6
RTOL, ATOL = 1e-4, 1e-5
# name: (arch, config overrides)
CASES = {
    "gemma-flash": ("gemma3-4b", dict(attn_impl="flash")),
    "gemma-blocked": ("gemma3-4b", dict(attn_impl="blocked", attn_kv_block=16)),
    "qwen-dense-bias": ("qwen1.5-32b", dict(attn_kv_block=32)),
}
VOCAB = 500  # padded to 512: the greedy argmax must skip the padding


def _cfgs(name):
    arch, over = CASES[name]
    over = dict(over, vocab_size=VOCAB)
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


def _with_biases(params, key):
    """QKV biases drawn nonzero, so the bias path does work."""
    blocks = dict(params["blocks"])
    attn = dict(blocks["l00"]["attn"])
    for i, name in enumerate(("bq", "bk", "bv")):
        attn[name] = 0.5 * jax.random.normal(jax.random.fold_in(key, i), attn[name].shape)
    blocks["l00"] = {**blocks["l00"], "attn": attn}
    return {**params, "blocks": blocks}


def _bf16_attention(q, k, v, pos, kpos):
    """The dense and blocked attention on bfloat16 activations."""
    return (jattn.attention_dense(q, k, v, pos, kpos, 8).astype(jnp.float32),
            jattn.attention_blocked(q, k, v, pos, kpos, 8, 16).astype(jnp.float32))


def _bf16_inputs():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19, 24, dtype=np.int32), (2, 5)).copy()
    kpos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    kpos[1, 20:] = -1  # unfilled slots
    return q, k, v, pos, kpos


@functools.cache
def _jax_side():
    """Per case: the params, prompts, prefill logits and cache, and the greedy
    decode's tokens and logits, as numpy; plus the bf16 attention outputs.

    One jitted program per step (prefill, decode step), not one for
    everything: XLA's compile time grows faster than the program, and the
    decode step's program is shared by the two gemma cases, whose decode
    reads neither ``attn_impl`` nor ``attn_kv_block``. ``init_params`` runs
    eagerly on an "rbg" key, which compiles far less than threefry."""
    prompts = np.random.default_rng(3).integers(0, VOCAB, (BATCH, PROMPT)).astype(np.int32)

    def prefill_fresh(params, cfg, prompts):
        return jtf.prefill(params, cfg, jtf.init_cache(cfg, BATCH, PROMPT + STEPS), prompts)

    prefill = jax.jit(prefill_fresh, static_argnums=1)
    decode = jax.jit(jtf.decode_step, static_argnums=1)
    out, by_arch = {}, {}
    with _cheap_compiles():
        for i, name in enumerate(CASES):
            arch = CASES[name][0]
            cfg = _cfgs(name)[0]
            if arch not in by_arch:  # the two gemma cases share their weights
                key = jax.random.key(100 + i, impl="rbg")
                params = jtf.init_params(cfg, key)
                if cfg.qkv_bias:
                    params = _with_biases(params, jax.random.fold_in(key, 1))
                by_arch[arch] = params
            params = by_arch[arch]
            logits, cache = prefill(params, cfg, prompts)
            res = {"params": params, "logits": logits, "cache": cache}
            dcfg = cfg.replace(attn_impl="blocked", attn_kv_block=_cfgs("gemma-blocked")[0].attn_kv_block)
            tok = jnp.argmax(logits[:, -1, :VOCAB], axis=-1)[:, None].astype(jnp.int32)
            toks, step_logits = [tok[:, 0]], []
            for j in range(STEPS):
                pos = jnp.full((BATCH, 1), PROMPT + j, jnp.int32)
                lg, cache = decode(params, dcfg, cache, tok, pos)
                tok = jnp.argmax(lg[:, -1, :VOCAB], axis=-1)[:, None].astype(jnp.int32)
                toks.append(tok[:, 0])
                step_logits.append(lg[:, 0])
            out[name] = {**res, "tokens": jnp.stack(toks, 1), "step_logits": jnp.stack(step_logits)}
        q, k, v, pos, kpos = _bf16_inputs()
        out["bf16"] = jax.jit(_bf16_attention)(q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
                                               v.astype(jnp.bfloat16), pos, kpos)
    return prompts, jax.tree.map(np.asarray, out)


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL, atol=ATOL, err_msg=what)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_greedy_decode_match_jax(name):
    prompts, res = _jax_side()
    want = res[name]
    cfg = _cfgs(name)[1]
    params = interop.params_from_numpy(cfg, want["params"], "cpu")
    cache = ttf.init_cache(cfg, BATCH, PROMPT + STEPS, device="cpu")
    logits, cache = make_prefill_step(cfg)(params, cache, torch.from_numpy(prompts))
    _close(logits, want["logits"], "prefill logits")
    got_leaves = dict(_leaves(cache))
    want_leaves = dict(_leaves(want["cache"]))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, leaf in want_leaves.items():
        _close(got_leaves[path], leaf, f"cache {path}")

    decode = make_decode_step(cfg)
    tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None].int()
    toks, step_logits = [tok[:, 0]], []
    for i in range(STEPS):
        pos = torch.full((BATCH, 1), PROMPT + i, dtype=torch.int32)
        nxt, lg, cache = decode(params, cache, tok, pos)
        tok = nxt[:, None].int()
        toks.append(nxt)
        step_logits.append(lg[:, 0])
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), want["tokens"])
    _close(torch.stack(step_logits), want["step_logits"], "decode logits")


def test_cache_round_trips_through_interop():
    prompts, res = _jax_side()
    cfg = _cfgs("gemma-flash")[1]
    cache = interop.cache_from_numpy(cfg, res["gemma-flash"]["cache"], BATCH, PROMPT + STEPS, "cpu")
    for (path, got), (_, want) in zip(_leaves(cache), _leaves(res["gemma-flash"]["cache"])):
        _close(got, want, path)
    with pytest.raises(ValueError):
        interop.cache_from_numpy(cfg, res["gemma-flash"]["cache"], BATCH, PROMPT, "cpu")
    with pytest.raises(ValueError):
        interop.params_from_numpy(_cfgs("qwen-dense-bias")[1], res["gemma-flash"]["params"], "cpu")


def test_attention_in_bfloat16_casts_as_jax_does():
    """Dense attention rounds P to bf16 before the PV product, the blocked
    one keeps it float32; both return bf16, and unfilled slots drop out."""
    q, k, v, pos, kpos = (torch.from_numpy(a) for a in _bf16_inputs())
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    dense = tattn.attention_dense(q, k, v, pos, kpos, 8)
    blocked = tattn.attention_blocked(q, k, v, pos, kpos, 8, 16)
    want_dense, want_blocked = _jax_side()[1]["bf16"]
    assert dense.dtype == blocked.dtype == torch.bfloat16
    np.testing.assert_allclose(dense.float().numpy(), want_dense, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(blocked.float().numpy(), want_blocked, rtol=1e-2, atol=1e-2)


def test_parameter_counts_match_jax_for_every_arch():
    from repro import configs as jconfigs

    for arch in tconfigs.ARCHS:
        assert tconfigs.get_config(arch).n_params() == jconfigs.get_config(arch).n_params(), arch
    assert tconfigs.get_config("gemma3-4b").n_params() == 3_879_907_840


@pytest.mark.parametrize("attn_impl", ["flash", "blocked"])
def test_gqa_repeat_kv_changes_nothing(attn_impl):
    """Repeating the kv heads to every query head (a layout knob of the JAX
    package) gives the same logits as grouped attention."""
    cfg = tconfigs.preset_config("gemma3-4b", "tiny").replace(attn_impl=attn_impl)
    params = ttf.init_params(cfg, 5, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(6))
    grouped, _ = ttf.forward(params, cfg, tokens)
    repeated, _ = ttf.forward(params, cfg.replace(gqa_repeat_kv=True), tokens)
    torch.testing.assert_close(repeated, grouped, rtol=1e-6, atol=1e-6)
