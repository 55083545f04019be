"""Every architecture through the port, at its tiny preset, on the CPU (the
port's twin of tests/test_archs_smoke.py; no JAX): the parameter tree
against ``param_defs``; one forward with its shapes and finite values; a
training gradient with a finite, positive loss and gradient norm; one
decode step from an empty cache, updated in place; and the greedy logits of
a full forward at position t against 7 decode steps fed tokens (or, for the
embeddings-input stub, embeddings) 0..t through the cache, at the JAX
test's rtol 5e-2 / atol 5e-3.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch import configs
from repro_torch.core import chunking
from repro_torch.models import decode_step, forward, init_cache, init_params, loss_fn, param_defs
from repro_torch.models import transformer

B, S = 2, 32


def _inputs(cfg, g: torch.Generator, b: int, s: int) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        return torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    return torch.randn((b, s, cfg.d_model), generator=g)


@pytest.fixture(scope="module", params=configs.ARCHS)
def arch_setup(request):
    cfg = configs.preset_config(request.param, "tiny")
    return request.param, cfg, init_params(cfg, 0, device="cpu")


def _pairs(params, defs):
    if isinstance(defs, transformer.ParamDef):
        return [(params, defs)]
    if isinstance(defs, dict):
        assert isinstance(params, dict) and set(params) == set(defs)
        return [pair for k in defs for pair in _pairs(params[k], defs[k])]
    assert isinstance(params, tuple) and len(params) == len(defs)
    return [pair for p, d in zip(params, defs) for pair in _pairs(p, d)]


def test_param_tree_matches_defs(arch_setup):
    _, cfg, params = arch_setup
    pairs = _pairs(params, param_defs(cfg))
    for leaf, d in pairs:
        assert tuple(leaf.shape) == d.shape and leaf.dtype == cfg.params_dtype
        assert len(d.axes) == leaf.dim()
    assert sum(leaf.numel() for leaf, _ in pairs) == cfg.n_params()


def test_forward_shapes_no_nans(arch_setup):
    name, cfg, params = arch_setup
    logits, aux = forward(params, cfg, _inputs(cfg, torch.Generator().manual_seed(1), B, S))
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert torch.isfinite(logits).all() and torch.isfinite(aux), name


def test_train_grad_step(arch_setup):
    name, cfg, params = arch_setup
    g = torch.Generator().manual_seed(2)
    batch = {"inputs": _inputs(cfg, g, B, S),
             "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    live = [leaf.detach().requires_grad_() for leaf in chunking.tree_leaves(params)]
    loss, _ = loss_fn(chunking.tree_unflatten(params, live), cfg, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    gnorm = math.sqrt(sum(float((gr.double() ** 2).sum()) for gr in grads if gr is not None))
    loss = float(loss.detach())
    assert math.isfinite(loss) and math.isfinite(gnorm), name
    assert loss > 0 and gnorm > 0, name


def test_decode_step(arch_setup):
    name, cfg, params = arch_setup
    cache = init_cache(cfg, B, seq_len=16, device="cpu")
    before = {id(t) for t in _cache_leaves(cache)}
    if cfg.input_mode == "tokens":
        tok = torch.tensor([[1], [2]], dtype=torch.int32)
    else:
        tok = torch.ones((B, 1, cfg.d_model))
    logits, new_cache = decode_step(params, cfg, cache, tok, torch.full((B, 1), 3, dtype=torch.int32))
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert torch.isfinite(logits).all(), name
    assert new_cache is cache and {id(t) for t in _cache_leaves(new_cache)} == before


def _cache_leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _cache_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _cache_leaves(v)]
    return [tree]


def test_prefill_decode_consistency(arch_setup):
    """Greedy logits from the full forward at position t == decode-step
    logits after feeding inputs 0..t through the cache path."""
    name, cfg, params = arch_setup
    t = 6
    inputs = _inputs(cfg, torch.Generator().manual_seed(3), 1, t + 1)
    full_logits, _ = forward(params, cfg, inputs)
    cache = init_cache(cfg, 1, seq_len=16, device="cpu")
    for i in range(t + 1):
        logits, cache = decode_step(params, cfg, cache, inputs[:, i:i + 1],
                                    torch.full((1, 1), i, dtype=torch.int32))
    torch.testing.assert_close(logits[0, 0], full_logits[0, t], rtol=5e-2, atol=5e-3)
