"""Server-side round state: online correlation tracking + temporal decoding
(port of repro/fl/server.py).

1. **Online cross-client correlation tracking**: the Rand-Proj-Spatial(Opt)
   transform needs the true correlation R (paper Eq. 7), which no real
   server knows. After each decode every participant's unbiased
   contribution is rebuilt with the pipeline's ``self_decode`` (the
   server's view of client i), ``core.correlation.r_exact`` is applied to
   that decoded history, and an EMA is tracked across rounds. Compression
   noise inflates the denominator sum ||x_hat_i||^2 by each codec's known
   second-moment factor (``codec.Sparsifier.self_decode_norm_inflation``),
   rescaled out before the EMA; the residual bias is small and toward 0.

2. **The practical Rand-Proj-Spatial(wavg) variant**: ``transform="wavg"``
   resolves per round to Opt(r_value=R_ema) once the tracker warms up, and
   to the paper's Avg before (``resolve_pipeline``, which rewrites the
   pipeline's sparsifier stage before any decode runs).

3. **Temporal-correlation decoding**: the server's previous estimate is
   everyone's side information (broadcast variant); per-client memories
   live in ``codec.ClientState`` and are driven by ``fl.rounds``.

4. **Stale-payload admission** (async rounds): ``admit_stale`` re-weights
   an admitted staleness-1 group's decode into the fresh survivors' mean by
   client count.

5. **Sharded-decode accounting** (``RoundConfig(ownership=True)``):
   ``intra_pod_reduction`` reads the all-gather vs chunk-ownership
   server-side traffic ratio off a ``dist.collectives`` info dict.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import correlation
from ..core.codec import Payload, as_pipeline


@dataclasses.dataclass
class ServerState:
    """Mutable per-run server state threaded through rounds."""

    round: int = 0
    prev_mean: torch.Tensor | None = None  # (C, d_block) last decoded chunks
    r_ema: float | None = None             # EMA of the online R estimate
    r_history: list = dataclasses.field(default_factory=list)


def resolve_pipeline(pipe, state: ServerState, n_eff: int):
    """Round-level resolution of the practical wavg variant.

    wavg -> Opt(R_ema) once correlation history exists, else Avg. R is
    re-expressed for the round's participant count: the tracker holds rho
    directly (see ema_update) and scales back by this round's n_eff - 1.
    Sparsifiers without a ``transform`` field (rand_k, top_k, ...) pass
    through untouched.
    """
    pipe = as_pipeline(pipe)
    if n_eff < 2:
        # singleton decode: no cross-client correlation to exploit, and the
        # avg/opt interpolations are undefined at n=1 (rho = R/(n-1))
        return pipe.replace_sparsifier(
            _ignore_missing=True, transform="one", r_value=None
        )
    if pipe.transform != "wavg":
        return pipe
    if state.r_ema is None:
        return pipe.replace_sparsifier(transform="avg")
    r = float(np.clip(state.r_ema, 0.0, 1.0)) * (n_eff - 1.0)
    return pipe.replace_sparsifier(transform="opt", r_value=r)


# the pre-pipeline name; accepts a spec or a pipeline, returns a Pipeline
resolve_spec = resolve_pipeline


def side_info_for(state: ServerState, temporal: bool):
    """Previous-round estimate as broadcast side information (None round 0)."""
    if not temporal or state.prev_mean is None:
        return None
    return state.prev_mean


def measure_rho(pipe, key, payloads, ids, *, draws=None) -> float | None:
    """One group's rho = R/(n-1) measurement from this round's payloads.

    Rebuilds each participant's unbiased contribution with the pipeline's
    self_decode, one client after another (the JAX package vmaps it), and
    measures r_exact over the stack. Returns rho in [0, 1], or None when
    the codec has no per-client reconstruction or n < 2. ``draws``
    (stacked, (n, 1|C, ...)) replaces the port's own draws. One host read
    (``float(r_exact)``). The cross-round EMA is ``ema_update``.
    """
    pipe = as_pipeline(pipe)
    if not pipe.sparsifier.supports_self_decode:
        return None
    n = len(ids)
    if n < 2:
        return None
    recon = torch.stack([
        pipe.self_decode(
            key, int(cid), Payload({name: v[i] for name, v in payloads.arrays.items()},
                                   payloads.meta),
            draws=None if draws is None else {name: v[i] for name, v in draws.items()})
        for i, cid in enumerate(ids)
    ])  # (n, C, d)
    # de-inflate the denominator by each codec's exact second-moment factor
    # E||self_decode||^2 / ||x||^2 (d/k for the Rand-k / SRHT family, the
    # density-corrected factor for SparseProj's with-replacement rows, 1.0
    # for identity / top_k), as the sparsifier declares it
    scale = pipe.sparsifier.self_decode_norm_inflation
    r_round = float(correlation.r_exact(recon)) * scale
    return float(np.clip(r_round / (n - 1.0), 0.0, 1.0))


def ema_update(state: ServerState, rho_round: float, gamma: float = 0.3) -> None:
    """Advance the cross-round tracker by exactly one EMA step."""
    state.r_ema = (
        rho_round if state.r_ema is None
        else (1.0 - gamma) * state.r_ema + gamma * rho_round
    )
    state.r_history.append(rho_round)


def admit_stale(fresh_mean, n_fresh: int, stale_mean, n_stale: int,
                stale_weight: float = 1.0):
    """Combine the fresh survivors' decode with an admitted stale group's
    (async rounds, staleness-1 aggregation). Client-count weighting with
    ``stale_weight`` per stale client:

        (n_fresh * fresh + w * n_stale * stale) / (n_fresh + w * n_stale)
    """
    w = stale_weight * n_stale
    return (n_fresh * fresh_mean + w * stale_mean) / (n_fresh + w)


def intra_pod_reduction(info: dict) -> float | None:
    """allgather/ownership server-side traffic ratio of a decode, the
    server-policy view of ``dist.collectives.intra_pod_reduction``."""
    from ..dist import collectives

    return collectives.intra_pod_reduction(info)


def commit_round(state: ServerState, mean_chunks) -> None:
    """Store the decoded mean as next round's temporal side information."""
    state.prev_mean = mean_chunks
    state.round += 1
