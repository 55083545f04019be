"""Stateful stages and the client-held state of the codec pipeline (port of
repro/core/codec/stages.py).

Five stage roles exist; a ``Pipeline`` takes at most one stage of each:

    sparsify  - (C, d_block) chunks -> payload tensors (exactly one;
                codec.sparsifiers)
    quantize  - payload tensors -> smaller payload tensors (codec.quantizers)
    feedback  - the error-feedback residual carried in ClientState.ef
    temporal  - temporal side information (client-held memory, after
                Rand-k-Temporal, Jhunjhunwala et al. 2021)
    code      - entropy-coded wire accounting (codec.entropy.EntropyCode)

``ClientState`` holds what a client carries across rounds: the EF residual
and the temporal memory, each (C, d_block) per client, stacked to (n, C, d)
over a cohort. Where the JAX package maps over a pytree, the port takes
and sets rows by client position (``rows`` / ``with_rows``) and stacks
per-client states (``stack``). The server may mirror the temporal memory:
its updates depend only on transmitted payloads.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from ... import resolve_device


@dataclasses.dataclass
class ClientState:
    """Per-client cross-round state: ``ef`` the error-feedback residual and
    ``memory`` the temporal memory, each a tensor ((C, d) for one client,
    (n, C, d) stacked) or None."""

    ef: torch.Tensor | None = None
    memory: torch.Tensor | None = None

    def _map(self, fn) -> "ClientState":
        return ClientState(*(None if t is None else fn(t) for t in (self.ef, self.memory)))

    def client(self, i: int) -> "ClientState":
        """Row ``i`` of a stacked state: one client's state."""
        return self._map(lambda t: t[i])

    def rows(self, positions) -> "ClientState":
        """The stacked rows at ``positions`` (a list of client positions)."""
        return self._map(lambda t: t[torch.as_tensor(positions, device=t.device)])

    def with_rows(self, positions, rows: "ClientState") -> "ClientState":
        """A new stacked state with the rows at ``positions`` replaced by the
        stacked ``rows``; the other rows carry over, ``self`` is unchanged."""
        def put(t, new):
            if t is None:
                return None
            return t.index_copy(0, torch.as_tensor(positions, device=t.device), new)

        return ClientState(put(self.ef, rows.ef), put(self.memory, rows.memory))

    @staticmethod
    def stack(states: list) -> "ClientState":
        """Per-client states -> one stacked state."""
        def st(name):
            parts = [getattr(s, name) for s in states]
            return None if parts[0] is None else torch.stack(parts)

        return ClientState(st("ef"), st("memory"))


@dataclasses.dataclass(frozen=True)
class ErrorFeedback:
    """Error feedback: the client adds its residual to the input before
    encoding and keeps ``input - self_decode(payload)`` as the next residual,
    so mass a (semi-)biased codec drops is sent again until it lands. One
    residual row per client, so EF composes with heterogeneous budgets and
    partial participation (non-participants' rows carry over)."""

    role: ClassVar[str] = "feedback"
    name: ClassVar[str] = "error_feedback"

    def client_state(self, n_chunks: int, d_block: int, device=None):
        return torch.zeros((n_chunks, d_block), dtype=torch.float32,
                           device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class Temporal:
    """Temporal side information.

    ``per_client=True`` is Rand-k-Temporal: client i encodes ``x_i - m_i``
    against its own memory, and both sides advance ``m_i' = m_i + eta *
    self_decode(payload_i)``. With Rand-k and ``eta = k/d`` (the default)
    that sets the transmitted coordinates to their fresh values. The server
    adds back the survivors' mean memory, which keeps the decode unbiased.
    ``per_client=False`` is the broadcast variant (the server's previous
    estimate as everyone's side information); it holds no client state."""

    role: ClassVar[str] = "temporal"
    name: ClassVar[str] = "temporal"

    per_client: bool = True
    eta: float | None = None  # None -> budget / d_block (coordinate replacement)

    def client_state(self, n_chunks: int, d_block: int, device=None):
        if not self.per_client:
            return None
        return torch.zeros((n_chunks, d_block), dtype=torch.float32,
                           device=resolve_device(device))

    def resolve_eta(self, budget: int, d_block: int) -> float:
        return self.eta if self.eta is not None else budget / d_block
