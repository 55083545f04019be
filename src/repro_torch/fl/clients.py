"""Client-side population model for federated rounds (port of
repro/fl/clients.py; host numpy, the same ids as the JAX package's).

A ``Cohort`` describes everything about the client population that is NOT the
task: how many clients exist, what fraction the server samples each round
(partial participation), how often a sampled client fails to report (dropout/
straggler), and each client's communication budget k_i (heterogeneous-budget
cohorts are decoded per budget group, docs/DESIGN.md §8.3).

Sampling is host-side numpy (deterministic in (seed, round)) because the set
of participants must be CONCRETE: payload stacks are shaped by who reports,
and the decode re-derives each survivor's randomness from its actual client
id (``client_ids`` in the codec pipeline).

Client-held cross-round state (error-feedback residuals, per-client temporal
memories) lives in a stacked ``codec.ClientState`` created by
``Cohort.init_state`` on the run's device: one row per client, taken and set
by the round driver (``ClientState.rows`` / ``with_rows``) as participation
dictates.

Data partition helpers implement the two non-IID schemes used by the paper's
§5 tasks and by Jhunjhunwala et al. 2021: label-band (label-sorted contiguous
shards, paper App. D) and Dirichlet(alpha) class mixtures (the standard FL
heterogeneity knob).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Participation:
    """One round's sampling outcome: who was asked, who reported."""

    sampled: np.ndarray    # ids the server selected this round
    survivors: np.ndarray  # subset that actually reported (post dropout)

    @property
    def n_sampled(self) -> int:
        return len(self.sampled)

    @property
    def n_survivors(self) -> int:
        return len(self.survivors)

    @property
    def stragglers(self) -> np.ndarray:
        """Sampled clients that missed the round's reporting deadline.

        The sync driver drops them (their randomness never enters the
        decode); the async driver (``RoundConfig(async_rounds=True)``) treats
        them as LATE — they still encode this round's vectors, and their
        payloads are admitted into the next round's decode at staleness 1.
        """
        return np.setdiff1d(self.sampled, self.survivors)


@dataclasses.dataclass(frozen=True)
class Cohort:
    n_clients: int
    participation: float = 1.0          # fraction sampled per round
    dropout: float = 0.0                # P(sampled client fails to report)
    budgets: tuple[int, ...] | None = None  # per-client k_i; None => spec.k

    def __post_init__(self):
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError("dropout must be in [0, 1)")
        if self.budgets is not None and len(self.budgets) != self.n_clients:
            raise ValueError("budgets must have one entry per client")

    def sample_round(self, seed: int, t: int) -> Participation:
        """Deterministic (seed, t) participation draw; >= 1 survivor always.

        Dropout keeps at least one reporter so a round is never empty — a
        fully-silent round would have no payloads to decode and the driver
        simply reuses the previous model state, which is equivalent.
        """
        rng = np.random.default_rng(np.random.SeedSequence([seed, t, 0xF1]))
        n_sampled = max(1, int(round(self.participation * self.n_clients)))
        sampled = np.sort(rng.choice(self.n_clients, n_sampled, replace=False))
        if self.dropout <= 0.0:
            return Participation(sampled=sampled, survivors=sampled)
        alive = rng.random(n_sampled) >= self.dropout
        if not alive.any():
            alive[rng.integers(n_sampled)] = True
        return Participation(sampled=sampled, survivors=sampled[alive])

    def init_state(self, pipe, n_chunks: int, device=None):
        """Stacked per-client ``codec.ClientState`` for this cohort (EF
        residual rows + temporal memories) on ``device``, or None for
        stateless pipelines.

        This is where client-held state lives in the simulation: row i IS
        client i's state, and doubles as the server's mirror (temporal memory
        updates are deterministic functions of transmitted payloads, so both
        sides agree — docs/DESIGN.md §8.2)."""
        from ..core.codec import as_pipeline

        return as_pipeline(pipe).init_client_state(self.n_clients, n_chunks, device=device)

    def budget_groups(self, ids: np.ndarray, default_k: int):
        """Group client ids by their budget k_i -> [(k, ids_with_that_k), ...].

        Correlation is exploited within a group (one joint decode per k); the
        group means are then combined weighted by group size, which is exactly
        the overall participants' mean in expectation.
        """
        if self.budgets is None:
            return [(default_k, np.asarray(ids))]
        ks = np.asarray([self.budgets[i] for i in ids])
        return [(int(k), np.asarray(ids)[ks == k]) for k in sorted(set(ks.tolist()))]


# ------------------------------------------------------------- data partition


def band_assignment(labels: np.ndarray, n_clients: int) -> list[np.ndarray]:
    """Label-sorted contiguous shards (paper App. D): client i gets the i-th
    band of the label-sorted sample order — maximal label skew."""
    order = np.argsort(labels, kind="stable")
    return [np.sort(s) for s in np.array_split(order, n_clients)]


def dirichlet_assignment(
    labels: np.ndarray, n_clients: int, alpha: float, seed: int = 0
) -> list[np.ndarray]:
    """Dirichlet(alpha) non-IID split: each client draws a class mixture
    p_i ~ Dir(alpha) and samples (without replacement, balanced sizes) from
    the classes accordingly. Small alpha => near-single-class clients."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD1]))
    classes = np.unique(labels)
    by_class = {c: rng.permutation(np.flatnonzero(labels == c)) for c in classes}
    used = {c: 0 for c in classes}
    per_client = len(labels) // n_clients
    out = []
    for i in range(n_clients):
        mix = rng.dirichlet(np.full(len(classes), alpha))
        want = np.floor(mix * per_client).astype(int)
        want[rng.integers(len(classes))] += per_client - want.sum()
        take: list[np.ndarray] = []
        short = 0
        for c, w in zip(classes, want):
            pool = by_class[c]
            got = pool[used[c]: used[c] + w]
            used[c] += len(got)
            short += w - len(got)
            take.append(got)
        # backfill exhausted classes from whatever remains, round-robin
        while short > 0:
            for c in classes:
                if short == 0:
                    break
                pool = by_class[c]
                if used[c] < len(pool):
                    take.append(pool[used[c]: used[c] + 1])
                    used[c] += 1
                    short -= 1
        out.append(np.sort(np.concatenate(take)))
    return out


def partition(
    x: np.ndarray,
    labels: np.ndarray,
    n_clients: int,
    scheme: str = "iid",
    alpha: float = 0.3,
    seed: int = 0,
) -> np.ndarray:
    """Shard samples into (n_clients, m, ...) by the named scheme.

    Shards are trimmed to the minimum per-client count so the result stacks.
    """
    if scheme == "iid":
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x11D]))
        order = rng.permutation(len(x))
        shards = np.array_split(order, n_clients)
    elif scheme == "band":
        shards = band_assignment(labels, n_clients)
    elif scheme == "dirichlet":
        shards = dirichlet_assignment(labels, n_clients, alpha, seed)
    else:
        raise ValueError(f"unknown partition scheme {scheme!r}")
    m = min(len(s) for s in shards)
    return np.stack([x[s[:m]] for s in shards])
