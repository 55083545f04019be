"""Activation layout hook (port of repro/models/act_sharding.py).

The JAX package re-asserts the canonical (B, S, D) activation layout
(batch over the DP axes, replicated over ``model``) at block boundaries,
the embedding and the head, so that GSPMD does not propagate a
batch-replicated layout from the embedding gather through every layer.
The model code is mesh-agnostic; launchers install the layout:

    act_sharding.set_constraint(sharding.NamedSharding(mesh, (("pod", "data"), None, None)))

In the port a placed activation is this rank's block of that layout: its
batch rows, whole over ``model``, the same on every ``model`` rank. The
placed layers (``dist.sharding.reduce_from`` after each row-parallel
product) hand every (B, S, D) activation back in that layout, so
``constrain`` checks it and moves nothing. ``train.train_step`` installs
the layout around a placed loss and turns it off inside the pipelined loss,
as the JAX package does.
"""
from __future__ import annotations

import contextlib

_SHARDING = None  # dist.sharding.NamedSharding of (B, S, D) activations


def set_constraint(sharding) -> None:
    global _SHARDING
    _SHARDING = sharding


@contextlib.contextmanager
def constraint(sharding):
    global _SHARDING
    prev = _SHARDING
    _SHARDING = sharding
    try:
        yield
    finally:
        _SHARDING = prev


def current():
    """The installed layout (None when nothing is installed)."""
    return _SHARDING


def constrain(x):
    """``x`` at the installed (B, S, D) layout if any: the identity, once
    the layout is checked (batch over DP axes only, nothing over
    ``model``)."""
    if _SHARDING is None or x.ndim != 3:
        return x
    spec = tuple(_SHARDING.spec) + (None,) * (3 - len(_SHARDING.spec))
    if any(e is not None for e in spec[1:]) or "model" in (
            spec[0] if isinstance(spec[0], tuple) else (spec[0],)):
        raise ValueError(f"the port's placed activations are batch-sharded and whole over "
                         f"model; cannot constrain to {_SHARDING.spec}")
    return x
