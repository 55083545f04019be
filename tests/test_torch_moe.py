"""The port's routed MoE FFN (repro_torch.models.moe) against the JAX
package's, on the CPU, float32, on seeded numpy inputs.

For SwiGLU and GeLU experts, with and without shared experts, and with a
capacity factor that drops slots: ``moe_ffn``'s output, its Switch aux loss
and the gradients of a scalar of both with respect to the input and every
weight, within relative L2 1e-5; and the routing as integers, exactly: the
selected experts, the stable sort's order, each slot's position in its
expert's buffer and which slots the capacity keeps. The JAX side is one
jitted program, compiled without XLA's costly passes.
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
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

TOL, TOKENS, AUX_WEIGHT = 1e-5, 64, 3.0
# name -> config overrides of tiny deepseek-moe-16b (8 experts, top 2, d 64)
CASES = {
    "silu": dict(act="silu", n_shared_experts=0),
    "silu_shared": dict(act="silu", n_shared_experts=1),
    "gelu_shared": dict(act="gelu", n_shared_experts=1),
    "gelu": dict(act="gelu", n_shared_experts=0),
    "silu_drops": dict(act="silu", n_shared_experts=1, capacity_factor=0.5),
}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


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


def _cfgs(name):
    over = CASES[name]
    return (jconfigs.reduce_for_smoke(jconfigs.get_config("deepseek-moe-16b")).replace(**over),
            tconfigs.preset_config("deepseek-moe-16b", "tiny").replace(**over))


def _inputs(name: str, seed: int) -> dict:
    cfg = _cfgs(name)[1]
    rng = np.random.default_rng(seed)
    p = ttf.map_defs(lambda d: (0.2 * rng.standard_normal(d.shape)).astype(np.float32),
                     ttf._moe_defs(cfg))
    del p["norm"]  # ffn_layer's; moe_ffn reads the rest
    return {"p": p, "x": rng.standard_normal((TOKENS, cfg.d_model)).astype(np.float32),
            "w": rng.standard_normal((TOKENS, cfg.d_model)).astype(np.float32)}


def _jax_case(cfg, inp):
    def loss(x, p):
        y, aux = jmoe.moe_ffn(x, p, cfg)
        return jnp.sum(y * inp["w"]) + AUX_WEIGHT * aux, (y, aux)

    (_, (y, aux)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        inp["x"], inp["p"])
    # the reference's routing (repro/models/moe.py:32-48), as integers
    probs = jax.nn.softmax(inp["x"] @ inp["p"]["router"], axis=-1)
    _, sel = jax.lax.top_k(probs, cfg.top_k_experts)
    flat_e = sel.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(cfg.n_experts))
    pos_in_e = jnp.arange(flat_e.shape[0]) - starts[sorted_e]
    keep = pos_in_e < jmoe.capacity(cfg, inp["x"].shape[0])
    return {"y": y, "aux": aux, "gx": gx, "gp": gp,
            "routing": {"sel": sel, "order": order, "pos_in_e": pos_in_e, "keep": keep}}


def _flat(tree, path=()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


@functools.cache
def _jax_side():
    inputs = {name: _inputs(name, 30 + i) for i, name in enumerate(CASES)}

    def program(inputs):
        return {name: _jax_case(_cfgs(name)[0], inputs[name]) for name in CASES}

    with _cheap_compiles():
        out = jax.jit(program)(inputs)
    return inputs, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_jax(name):
    inputs, want = _jax_side()
    inp, want = inputs[name], want[name]
    cfg = _cfgs(name)[1]
    x = torch.tensor(inp["x"], requires_grad=True)
    p = interop.tree_from_numpy(inp["p"], device="cpu")
    flat = _flat(p)  # path -> leaf
    for t in flat.values():
        t.requires_grad_()
    y, aux = tmoe.moe_ffn(x, p, cfg)
    loss = (y * torch.tensor(inp["w"])).sum() + AUX_WEIGHT * aux
    # GeLU experts read no w_gate: its gradient is None here, zeros in JAX
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        [x, *flat.values()], torch.autograd.grad(loss, [x, *flat.values()], allow_unused=True))]
    assert _rel(y.detach(), want["y"]) <= TOL
    assert abs(float(aux.detach()) - float(want["aux"])) <= TOL * abs(float(want["aux"]))
    assert _rel(grads[0], want["gx"]) <= TOL
    want_gp = _flat(want["gp"])
    assert set(want_gp) == set(flat)
    for path, g in zip(flat, grads[1:]):
        assert _rel(g, want_gp[path]) <= TOL, path


@pytest.mark.parametrize("name", list(CASES))
def test_moe_routing_matches_jax_exactly(name):
    inputs, want = _jax_side()
    inp, want = inputs[name], want[name]["routing"]
    cfg = _cfgs(name)[1]
    _, _, sel = tmoe.route(torch.tensor(inp["x"]), torch.tensor(inp["p"]["router"]),
                           cfg.top_k_experts)
    order, _, pos_in_e, keep = tmoe.dispatch(sel, cfg.n_experts, tmoe.capacity(cfg, TOKENS))
    np.testing.assert_array_equal(sel.numpy(), want["sel"])
    np.testing.assert_array_equal(order.numpy(), want["order"])
    np.testing.assert_array_equal(pos_in_e.numpy(), want["pos_in_e"])
    np.testing.assert_array_equal(keep.numpy(), want["keep"])
    assert (not keep.all()) == ("drops" in name)  # only the small capacity drops
