"""Codec registry and the shared key derivation (port of
repro/core/estimators/base.py).

Each codec module registers a ``Codec`` of plain functions under its name;
the sparsifier configs of ``core.codec`` dispatch through it. The round key
is shared by clients and server, per-client randomness is
``fold_in(key, client_id)`` and per-chunk randomness
``fold_in(client_key, chunk_id)``, over the keys of core.random (JAX's
threefry by default), so maps are re-derived, never transmitted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import random as prand


@dataclasses.dataclass(frozen=True)
class Codec:
    encode: Callable[..., Any]
    decode: Callable[..., Any]
    # self_decode(spec, key, client_id, arrays) -> (C, d): the client's own
    # reconstruction of what the server received from it
    self_decode: Callable[..., Any] | None = None
    # draws(spec, key, n, c, client_ids=None, device=None) -> a round's maps
    # stacked (n, 1|C, ...), for codecs whose encode and decode both derive
    # them from the round key: made once, they serve both
    draws: Callable[..., Any] | None = None


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


def draw_keys(key, client_id, n_chunks: int, device, shared: bool = False,
              chunk_offset: int = 0) -> torch.Tensor:
    """One client's draw keys, led by (1,): its client key with shared
    randomness, else (C,) chunk keys by GLOBAL chunk position (chunk_offset
    + local index), so a chunk-slice decode re-derives the full decode's
    draws."""
    ckey = client_key(prand.as_key(key, device), client_id)
    if shared:
        return ckey.unsqueeze(0)
    return chunk_key(ckey, chunk_offset + torch.arange(n_chunks, device=device))


def no_draws(spec, draws) -> None:
    """Refuse draws given to the encode of a codec that draws nothing."""
    if draws is not None:
        raise ValueError(f"{spec.name} draws nothing from the round key; got draws "
                         f"{sorted(draws)}")


# --------------------------------------------------------------------------
# Functional convenience API over a sparsifier config or a Pipeline: thin
# delegation to core.codec (imported lazily: codec imports this module for
# the registry).


def _pipe(spec):
    from .. import codec

    return codec.as_pipeline(spec)


def encode(spec, key, client_id, x_cd, side_info=None):
    return _pipe(spec).encode(key, client_id, x_cd, side_info=side_info)[0]


def decode(spec, key, payloads, n: int, client_ids=None, side_info=None, chunk_offset=0):
    return _pipe(spec).decode(key, payloads, n, client_ids=client_ids, side_info=side_info,
                              chunk_offset=chunk_offset)


def self_decode(spec, key, client_id, payload):
    return _pipe(spec).self_decode(key, client_id, payload)


def encode_all(spec, key, xs, client_ids=None, side_info=None):
    """xs: (n, C, d) -> stacked payloads (leading n)."""
    return _pipe(spec).encode_all(key, xs, client_ids=client_ids, side_info=side_info)[0]


def mean_estimate(spec, key, xs, client_ids=None, side_info=None, device=None):
    """One-shot DME on ``device`` (the card when None): xs (n, C, d) client
    chunks -> (C, d) mean estimate."""
    return _pipe(spec).mean_estimate(key, xs, client_ids=client_ids, side_info=side_info,
                                     device=device)
