"""Self-describing payload container (port of repro/core/codec/payload.py).

A ``Payload`` is what one client transmits for one round: a dict of tensors
plus static ``PayloadMeta`` carrying the budget, the chunk geometry, the
stage stack and a *declared* byte schema. The schema comes from the
pipeline config alone, never from the tensors, so the byte ledger
(``declared_nbytes``) is an independent claim about the wire format that
``check_against_schema`` holds against the tensors' actual bytes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# ArraySpec kinds
VALUES = "values"    # quantizable payload values (vals / top_vals / rand_vals)
INDICES = "indices"  # data-dependent coordinates (top_k / wangni / induced)
SCALES = "scales"    # quantization scales (added by Int8Quant)
AUX = "aux"          # side statistics (e.g. norm_sq for the online R-hat)

# The historical value-array names, for bare-dict payloads that carry no
# schema (Payload.meta is the source of truth whenever present).
LEGACY_VALUE_NAMES = ("vals", "top_vals", "rand_vals")


class ArraySpec(NamedTuple):
    """One payload array's declared wire format (dtype named as in torch)."""

    name: str
    shape: tuple
    dtype: str
    kind: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * getattr(torch, self.dtype).itemsize


@dataclasses.dataclass(frozen=True)
class PayloadMeta:
    """Static, hashable payload description."""

    budget: int                      # per-client k this payload was encoded at
    d_block: int                     # chunk size the budget applies to
    stages: tuple = ()               # stage names, encode order
    schema: tuple = ()               # tuple[ArraySpec, ...]: declared wire format
    staleness: int = 0               # rounds between encode and decode (0 = fresh)
    chunk_budgets: tuple | None = None  # adaptive per-chunk (k_0..k_{C-1})

    @property
    def declared_nbytes(self) -> int:
        """Per-client wire bytes this payload CLAIMS to occupy (the ledger)."""
        return sum(s.nbytes for s in self.schema)

    def array_spec(self, name: str) -> ArraySpec:
        for s in self.schema:
            if s.name == name:
                return s
        raise KeyError(name)

    @property
    def value_names(self) -> tuple:
        return tuple(s.name for s in self.schema if s.kind == VALUES)


@dataclasses.dataclass
class Payload:
    """arrays: name -> tensor (per client, or stacked with a leading client
    axis); meta: static self-description."""

    arrays: dict
    meta: PayloadMeta

    @property
    def nbytes(self) -> int:
        """ACTUAL summed tensor bytes, leading client axis included."""
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def per_client_nbytes(self) -> int:
        """Actual bytes with the leading (client) axis stripped: one client's
        transmission inside a stacked payload."""
        return sum(a[0].numel() * a.element_size() for a in self.arrays.values())

    def __getitem__(self, name: str):
        return self.arrays[name]


def arrays_of(payload) -> dict:
    """Accept a Payload or a bare dict and return the tensor dict."""
    if isinstance(payload, Payload):
        return payload.arrays
    if isinstance(payload, dict):
        return payload
    raise TypeError(f"expected Payload or dict, got {type(payload).__name__}")


def meta_of(payload) -> PayloadMeta | None:
    return payload.meta if isinstance(payload, Payload) else None


def with_staleness(payload: Payload, staleness: int) -> Payload:
    """``payload`` re-tagged with ``meta.staleness = staleness``: the rounds
    between its encode and its decode (0 fresh, 1 admitted into the next
    round's decode). Metadata only: tensors, bytes and schema are unchanged."""
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if not isinstance(payload, Payload):
        raise TypeError(f"expected Payload, got {type(payload).__name__}")
    return Payload(arrays=payload.arrays, meta=dataclasses.replace(payload.meta,
                                                                  staleness=staleness))


def check_against_schema(payload: Payload) -> list[str]:
    """Diff an unstacked payload's tensors against its declared schema; an
    empty list means the ledger is honest."""
    problems = []
    schema = {s.name: s for s in payload.meta.schema}
    for name, arr in payload.arrays.items():
        if name not in schema:
            problems.append(f"array {name!r} not declared in schema")
            continue
        s = schema[name]
        if tuple(arr.shape) != tuple(s.shape):
            problems.append(f"{name}: shape {tuple(arr.shape)} != declared {s.shape}")
        if str(arr.dtype).removeprefix("torch.") != s.dtype:
            problems.append(f"{name}: dtype {arr.dtype} != declared {s.dtype}")
    for name in schema:
        if name not in payload.arrays:
            problems.append(f"declared array {name!r} missing from payload")
    if payload.nbytes != payload.meta.declared_nbytes:
        problems.append(f"nbytes {payload.nbytes} != declared {payload.meta.declared_nbytes}")
    return problems
