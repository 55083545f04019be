"""Hierarchical (per-pod) aggregation: clients -> pods -> one global mean
(port of repro/runtime/hierarchy.py).

A ``PodPlan`` assigns clients to pods; each pod's server runs the SAME
correlation-aware sub-decode the flat path runs (``fl.server`` pipeline
resolution and online rho tracking, ``fl.rounds._decode_round``) but sees
only its cohort's payloads and carries its OWN online R estimate. The
cross-pod combine is then a d-sized weighted mean of decoded estimates
(``combine_records``), with cross-pod traffic modelled and ledgered by
``runtime.comms``.

Exactness contract: at one pod, or with ``RoundConfig(hierarchy="flat")``,
the hierarchical driver is BITWISE the single-process flat path: a 1-pod
plan restricts nothing (``restrict`` keeps the survivors array exactly),
the single pod's ``ServerState`` receives the same ``ema_update`` sequence
the flat state would, and ``combine_records`` returns a sole contributing
pod's decode unscaled (no combine arithmetic to reassociate floats
through). Chunk ownership composes INSIDE each pod: the pod's sub-decode
forwards ``RoundConfig.ownership`` unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fl import server as server_lib
from .comms import CrossPodExchange
from .launch import RuntimeContext


@dataclasses.dataclass(frozen=True)
class PodPlan:
    """Clients -> pods, contiguous ceil blocks (the ``ChunkOwnership``
    idiom): pod p owns clients [p*cpp, min((p+1)*cpp, n_clients))."""

    n_clients: int
    n_pods: int

    def __post_init__(self):
        if self.n_pods < 1:
            raise ValueError(f"n_pods must be >= 1, got {self.n_pods}")
        if self.n_clients < self.n_pods:
            raise ValueError(f"need at least one client per pod: {self.n_clients} clients "
                             f"< {self.n_pods} pods")

    @property
    def clients_per_pod(self) -> int:
        return -(-self.n_clients // self.n_pods)  # ceil

    def slice_for(self, pod: int) -> tuple[int, int]:
        if not 0 <= pod < self.n_pods:
            raise ValueError(f"pod {pod} out of range [0, {self.n_pods})")
        lo = pod * self.clients_per_pod
        return lo, min(lo + self.clients_per_pod, self.n_clients)

    def pod_of(self, client: int) -> int:
        if not 0 <= client < self.n_clients:
            raise ValueError(f"client {client} out of range [0, {self.n_clients})")
        return client // self.clients_per_pod

    def clients_of(self, pod: int) -> np.ndarray:
        lo, hi = self.slice_for(pod)
        return np.arange(lo, hi)

    def restrict(self, ids: np.ndarray, pod: int) -> np.ndarray:
        """``ids`` filtered to pod ``pod``, ORDER PRESERVED: a 1-pod restrict
        returns the survivors array exactly as the flat path sees it."""
        ids = np.asarray(ids)
        lo, hi = self.slice_for(pod)
        return ids[(ids >= lo) & (ids < hi)]


class HierarchicalAggregator:
    """Per-pod server states and the cross-pod exchange for one run.

    One instance per ``run_rounds`` call (mirrors the flat path's single
    ``ServerState``). ``pod_states[p]`` is pod p's server: its online rho
    EMA advances only on rounds where pod p's cohort contributed. The
    GLOBAL ``ServerState`` (owned by the round driver) keeps only
    ``prev_mean``: the broadcast temporal side information is the COMBINED
    estimate every client receives, so it lives above the pods.

    Multi-process: ``ctx`` names this process; it decodes only
    ``owned_pods`` and learns the other pods' records via ``exchange``.
    Every process therefore holds identical combined results each round:
    there is no root, which is what makes the 2-process and 1-process runs
    bitwise comparable.
    """

    def __init__(self, plan: PodPlan, ctx: RuntimeContext | None = None):
        self.plan = plan
        self.ctx = ctx
        self.pod_states = [server_lib.ServerState() for _ in range(plan.n_pods)]
        self.exchange = CrossPodExchange(ctx)

    @property
    def owned_pods(self) -> range:
        if self.ctx is None:
            return range(self.plan.n_pods)
        return self.ctx.pods_owned(self.plan.n_pods)

    def owns_client(self, client: int) -> bool:
        return self.plan.pod_of(client) in self.owned_pods

    def owned_clients(self) -> np.ndarray:
        """All client ids of this process's pods, ascending (owned pods are
        a contiguous range of contiguous blocks)."""
        pods = self.owned_pods
        if len(pods) == 0:
            return np.arange(0)
        lo, _ = self.plan.slice_for(pods[0])
        _, hi = self.plan.slice_for(pods[-1])
        return np.arange(lo, hi)


def combine_records(records: dict, key: str = "mean", count_key: str = "n"):
    """Cross-pod combine: client-count-weighted mean of per-pod decodes.

    ``records``: {pod: {key: (C, d_block) tensor or ndarray | None,
    count_key: int}}, every estimate on one device. Pods with count 0 (or a
    None estimate) contribute nothing. Returns (combined (C, d_block) tensor
    | None, n_total, per-pod weights dict).

    Summation runs in ASCENDING pod order in float32, each weight rounded
    to float32 first (numpy's ``a * np.float32(w)``, which the JAX package
    computes), so every process, whatever subset of pods it decoded
    locally, reduces the exchanged records identically, bit for bit. A sole
    contributing pod short-circuits: its decode is returned UNSCALED (no
    ``*(n/n)`` round-trip), which makes the 1-pod hierarchy bitwise the
    flat path.
    """
    live = [(p, r) for p, r in sorted(records.items())
            if r.get(count_key, 0) > 0 and r.get(key) is not None]
    n_total = int(sum(r[count_key] for _, r in live))
    if not live:
        return None, 0, {}
    if len(live) == 1:
        p, r = live[0]
        return torch.as_tensor(r[key]), n_total, {p: 1.0}
    combined = None
    weights = {}
    for p, r in live:
        w = r[count_key] / n_total
        weights[p] = w
        term = torch.as_tensor(r[key]) * float(np.float32(w))
        combined = term if combined is None else combined + term
    return combined, n_total, weights


def combine_rho(records: dict) -> float | None:
    """Client-count-weighted mean of the pods' per-round rho measurements.
    None when no pod measured."""
    parts = [(r["rho"], r["n"]) for r in records.values()
             if r.get("rho") is not None and r.get("n", 0) > 0]
    if not parts:
        return None
    if len(parts) == 1:
        # no ``*n/n`` float round-trip: the sole pod's measurement must hit
        # the History bitwise as the flat path's
        return float(parts[0][0])
    wsum = sum(n for _, n in parts)
    return float(sum(rho * n for rho, n in parts) / wsum)
