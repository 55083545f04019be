"""The port's Mamba2 (SSD) layer (repro_torch.models.mamba) against the JAX
package's, on the CPU, float32, on seeded numpy inputs.

- ``ssd_chunked``'s y and final state within relative L2 1e-5 of JAX's at
  chunk 8 (L = 20, a ragged last chunk) and at the published chunk 256
  (L = 300, two chunks, the second ragged), and its gradients within 1e-5
  of JAX's at chunk 8, where JAX's are finite;
- at chunk 256 with the init's A (up to 16) and dt (up to 0.1), where the
  reference's unmasked exponent overflows and its gradients for dt and
  a_log are NaN (checked), the port's gradients are finite and match (rtol
  1e-4, atol 1e-4 of the leaf's largest entry) a float64 sequential
  recurrence written here, h <- h exp(A dt) + dt B x^T, y = C h + D x,
  which knows nothing of chunks;
- ``_conv_train``'s tap order, on small integers;
- ``mamba_layer`` for both ``mamba_split_proj`` layouts: the forward, a
  prefill's output and cache leaves, then 6 decode steps' outputs and
  cache leaves.

The JAX side is one jitted program, compiled without XLA's costly passes.
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
from repro.models import mamba as jmamba
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttf

TOL = 1e-5
# ssd cases: name -> (batch, length, heads, headdim, state, chunk)
SSD = {"chunk8": (2, 20, 4, 8, 4, 8), "chunk256": (1, 300, 8, 4, 4, 256)}
PREFILL, DECODE = 12, 6


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


def _init_a_dt(h: int):
    """The init's a_log and the dt that its dt_bias gives (softplus of it)."""
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    dt = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), h)).astype(np.float32)
    return a_log, dt


def _ssd_inputs(name: str) -> dict:
    b, l, h, p, n, _ = SSD[name]
    rng = np.random.default_rng(1 + len(name))
    a_log, dt = _init_a_dt(h)
    # the init's dt, jittered per step so its gradient has work to do
    dt = dt * np.exp(0.2 * rng.standard_normal((b, l, h)))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"x": f(b, l, h, p), "dt": dt.astype(np.float32), "a_log": a_log,
            "bb": f(b, l, h, n), "cc": f(b, l, h, n), "dd": f(h),
            "w_y": f(b, l, h, p), "w_h": f(b, h, n, p)}


SSD_ARGS = ("x", "dt", "a_log", "bb", "cc", "dd")


def _cfgs(split: bool):
    over = dict(mamba_split_proj=split)
    return (jconfigs.reduce_for_smoke(jconfigs.get_config("mamba2-130m")).replace(**over),
            tconfigs.preset_config("mamba2-130m", "tiny").replace(**over))


def _layer_params(cfg, seed: int) -> dict:
    """One Mamba layer's parameters: normal weights, norms and biases
    jittered about their init, the init's a_log and dt_bias."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in ttf._mamba_defs(cfg).items():
        if d.init == "a_log":
            out[name] = _init_a_dt(d.shape[0])[0]
        elif d.init == "dt_bias":
            out[name] = np.log(np.expm1(_init_a_dt(d.shape[0])[1])).astype(np.float32)
        elif d.init in ("ones", "zeros"):
            base = 1.0 if d.init == "ones" else 0.0
            out[name] = (base + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        else:
            out[name] = (0.2 * rng.standard_normal(d.shape)).astype(np.float32)
    return out


def _layer_inputs(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32),
            "prompt": rng.standard_normal((2, PREFILL, cfg.d_model)).astype(np.float32),
            "steps": rng.standard_normal((DECODE, 2, 1, cfg.d_model)).astype(np.float32)}


def _jax_ssd(inp, chunk):
    def loss(args):
        y, h = jmamba.ssd_chunked(*args, chunk)
        return jnp.sum(y * inp["w_y"]) + jnp.sum(h * inp["w_h"]), (y, h)

    args = tuple(inp[k] for k in SSD_ARGS)
    (_, (y, h)), grads = jax.value_and_grad(loss, has_aux=True)(args)
    return {"y": y, "h": h, "grads": grads}


def _jax_layer(cfg, p, inp):
    y, _ = jmamba.mamba_layer(inp["x"], p, cfg)
    cache = jmamba.init_mamba_cache(cfg, 2, jnp.float32)
    y_pre, cache = jmamba.mamba_layer(inp["prompt"], p, cfg, cache=cache)

    def step(c, x_i):  # one decode step, traced once
        y_i, c = jmamba.mamba_layer(x_i, p, cfg, cache=c)
        return c, (y_i, c)

    _, (ys, caches) = jax.lax.scan(step, cache, inp["steps"])
    return {"y": y, "y_prefill": y_pre, "y_steps": ys,
            "conv": jnp.concatenate([cache["conv"][None], caches["conv"]]),
            "ssm": jnp.concatenate([cache["ssm"][None], caches["ssm"]])}


@functools.cache
def _jax_side():
    """Every JAX reference of this file as numpy, from one jitted program."""
    rng = np.random.default_rng(5)
    conv = {"xbc": rng.integers(-4, 5, (2, 9, 6)).astype(np.float32),
            "w": rng.integers(-3, 4, (6, 4)).astype(np.float32),
            "b": rng.integers(-2, 3, (6,)).astype(np.float32)}
    ssd = {name: _ssd_inputs(name) for name in SSD}
    layers = {split: (_layer_params(_cfgs(split)[0], 10 + split),
                      _layer_inputs(_cfgs(split)[0], 20 + split)) for split in (False, True)}

    def program(conv, ssd, layers):
        return {"conv": jmamba._conv_train(conv["xbc"], conv["w"], conv["b"]),
                "ssd": {name: _jax_ssd(ssd[name], SSD[name][-1]) for name in SSD},
                "layers": {split: _jax_layer(_cfgs(split)[0], *layers[split])
                           for split in layers}}

    with _cheap_compiles():
        out = jax.jit(program)(conv, ssd, layers)
    return {"conv": conv, "ssd": ssd, "layers": layers}, jax.tree.map(np.asarray, out)


def _t(a, requires_grad=False) -> torch.Tensor:
    return torch.tensor(np.asarray(a)).requires_grad_(requires_grad)


def _port_ssd(inp, chunk):
    args = [_t(inp[k], True) for k in SSD_ARGS]
    y, h = tmamba.ssd_chunked(*args, chunk)
    loss = (y * _t(inp["w_y"])).sum() + (h * _t(inp["w_h"])).sum()
    grads = torch.autograd.grad(loss, args)
    return y.detach(), h.detach(), [g.numpy() for g in grads]


def test_conv_train_tap_order():
    inputs, want = _jax_side()
    c = inputs["conv"]
    got = tmamba._conv_train(_t(c["xbc"]), _t(c["w"]), _t(c["b"]))
    assert _rel(got, want["conv"]) <= 1e-6
    # the taps reversed differ at O(1): the tolerance tells the order
    flipped = tmamba._conv_train(_t(c["xbc"]), _t(c["w"][:, ::-1].copy()), _t(c["b"]))
    assert _rel(flipped, want["conv"]) > 0.1


@pytest.mark.parametrize("name", sorted(SSD))
def test_ssd_forward_matches_jax(name):
    inputs, want = _jax_side()
    y, h, _ = _port_ssd(inputs["ssd"][name], SSD[name][-1])
    assert y.shape == want["ssd"][name]["y"].shape and h.shape == want["ssd"][name]["h"].shape
    assert _rel(y, want["ssd"][name]["y"]) <= TOL
    assert _rel(h, want["ssd"][name]["h"]) <= TOL


def test_ssd_gradients_match_jax_at_chunk_8():
    inputs, want = _jax_side()
    _, _, grads = _port_ssd(inputs["ssd"]["chunk8"], 8)
    for name, got, ref in zip(SSD_ARGS, grads, want["ssd"]["chunk8"]["grads"]):
        assert np.isfinite(ref).all(), name
        assert _rel(got, ref) <= TOL, name


def _sequential_f64(inp) -> tuple:
    """The SSM as its recurrence, one step at a time in float64, with
    autograd: -> (loss, [grads by SSD_ARGS])."""
    args = [torch.tensor(inp[k], dtype=torch.float64, requires_grad=True) for k in SSD_ARGS]
    x, dt, a_log, bb, cc, dd = args
    b, l, h, p = x.shape
    state = torch.zeros((b, h, bb.shape[-1], p), dtype=torch.float64)
    ys = []
    for t in range(l):
        decay = torch.exp(-torch.exp(a_log) * dt[:, t])  # (b, h)
        state = state * decay[..., None, None] + \
            dt[:, t, :, None, None] * bb[:, t, :, :, None] * x[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cc[:, t], state) + dd[None, :, None] * x[:, t])
    y = torch.stack(ys, dim=1)
    loss = (y * torch.tensor(inp["w_y"], dtype=torch.float64)).sum() + \
        (state * torch.tensor(inp["w_h"], dtype=torch.float64)).sum()
    return y.detach(), state.detach(), torch.autograd.grad(loss, args)


def test_ssd_gradients_finite_and_exact_at_chunk_256():
    """The published chunk at the init's A and dt: the port's float32
    gradients against the float64 recurrence."""
    inputs, want = _jax_side()
    inp = inputs["ssd"]["chunk256"]
    # the reference's: its unmasked exp overflows above the diagonal
    jax_finite = {name: bool(np.isfinite(g).all())
                  for name, g in zip(SSD_ARGS, want["ssd"]["chunk256"]["grads"])}
    assert not jax_finite["dt"] and not jax_finite["a_log"]
    y, h, grads = _port_ssd(inp, 256)
    y64, h64, grads64 = _sequential_f64(inp)
    np.testing.assert_allclose(y.numpy(), y64.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h64.numpy(), rtol=1e-4, atol=1e-5)
    for name, got, ref in zip(SSD_ARGS, grads, grads64):
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4, atol=1e-4 * float(ref.abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("split", [False, True], ids=["fused_proj", "split_proj"])
def test_mamba_layer_forward_prefill_decode_match_jax(split):
    inputs, want = _jax_side()
    p_np, inp = inputs["layers"][split]
    want = want["layers"][split]
    cfg = _cfgs(split)[1]
    p = interop.tree_from_numpy(p_np, device="cpu")
    y, none = tmamba.mamba_layer(_t(inp["x"]), p, cfg)
    assert none is None and _rel(y, want["y"]) <= TOL
    cache = tmamba.init_mamba_cache(cfg, 2, torch.float32)
    y_pre, same = tmamba.mamba_layer(_t(inp["prompt"]), p, cfg, cache=cache)
    assert same is cache  # updated in place
    assert _rel(y_pre, want["y_prefill"]) <= TOL
    assert _rel(cache["conv"], want["conv"][0]) <= TOL
    assert _rel(cache["ssm"], want["ssm"][0]) <= TOL
    for i in range(DECODE):
        yi, _ = tmamba.mamba_layer(_t(inp["steps"][i]), p, cfg, cache=cache)
        assert _rel(yi, want["y_steps"][i]) <= TOL, i
        assert _rel(cache["conv"], want["conv"][i + 1]) <= TOL, i
        assert _rel(cache["ssm"], want["ssm"][i + 1]) <= TOL, i
