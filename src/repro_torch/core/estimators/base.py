"""Codec registry and the shared key derivation (port of
repro/core/estimators/base.py).

Each codec module registers a ``Codec`` of plain functions under its name;
the sparsifier configs of ``core.codec`` dispatch through it. The round key
is shared by clients and server, per-client randomness is
``fold_in(key, client_id)`` and per-chunk randomness
``fold_in(client_key, chunk_id)``, over the port's counter-based keys
(core.random), so maps are re-derived, never transmitted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .. import random as prand


@dataclasses.dataclass(frozen=True)
class Codec:
    encode: Callable[..., Any]
    decode: Callable[..., Any]
    # self_decode(spec, key, client_id, arrays) -> (C, d), where ported
    self_decode: Callable[..., Any] | None = None


_REGISTRY: dict[str, Codec] = {}


def register(name: str, codec: Codec) -> None:
    _REGISTRY[name] = codec


def get(name: str) -> Codec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown estimator {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def client_key(key, client_id):
    return prand.fold_in(key, client_id)


def chunk_key(ckey, chunk_id):
    return prand.fold_in(ckey, chunk_id)
