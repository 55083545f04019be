"""The federated round driver: encode -> ledger -> decode -> task step (port
of repro/fl/rounds.py).

One ``run_rounds`` call plays ``n_rounds`` of

    1. clients compute their round vectors          (task.client_vectors)
    2. the server samples participants; some drop   (cohort.sample_round)
    3. survivors chunk + encode through the codec pipeline, optionally
       against side information: the server's previous estimate (broadcast
       temporal) or each client's own memory in ClientState (per-client
       Rand-k-Temporal)                             (core.codec)
    4. every transmitted payload byte is ledgered straight off the payload's
       self-described schema; with a ``code`` stage the parallel
       ``History.coded_bytes`` column ledgers the EXACT entropy-coded stream
       length of the same traffic
    5. the server decodes the survivors' mean, renormalising by who actually
       reported, with their actual client ids, per budget group
    6. the server updates its correlation tracker and temporal state
    7. the task advances                            (task.step)

``spec`` may be a ``codec.Pipeline`` or a bare sparsifier config. Budget
groups are decoded independently (the group's budget rides in each
payload's meta); EF residual rows live per client in ``ClientState.ef`` and
follow their own k_i.

Backends: "local" drives the pipeline directly, on the task's device;
"gspmd" and "shard_map" route steps 3-5 through ``dist.collectives`` on
``cfg.mesh`` (a ``DeviceMesh``), the same math with the payloads crossing
ranks. Every rank runs the same driver with the same seed, so every rank
holds every client's vector and the same ``History``. On "shard_map" a rank
hands the collective its own clients' rows (n_clients must divide over the
client axes; otherwise the round takes the "gspmd" route). Per-client
temporal memories compose with both: the collectives move deltas against
each client's memory, and the server mirrors the memory updates.

Hierarchical aggregation (``RoundConfig(hierarchy="hier", pods=P)``,
``runtime/``): each pod's server decodes only its cohort against its own
``ServerState`` (in async mode also its stale group), the pods' records
cross the runtime's processes (``runtime.comms.CrossPodExchange``) and are
combined in ascending pod order, and ``History.dcn_bytes`` ledgers the
modelled cross-pod bytes. Bitwise the flat path at one pod; with
``cfg.runtime`` naming several processes each decodes only the pods it
owns, and every process holds the same History.

Async rounds (``RoundConfig(async_rounds=True)``): the server decodes
whoever reported by the deadline and moves on. Stragglers' encodes (of THIS
round's vectors) complete late; their encode inputs are buffered and the
payloads admitted into the NEXT round's decode at staleness 1: the stale
group is decoded with its own round key and side information, tagged
``payload.meta.staleness = 1``, ledgered at arrival, and combined with the
fresh survivors' mean re-weighted by client count (``cfg.stale_weight`` per
stale client). With ``dropout=0`` the async driver is bit-identical to the
sync one: the buffer never fills.

Overlapped decode (``RoundConfig(overlap=True)``): steps 3-5 stream the
chunk axis through ``dist.collectives.streamed_mean``'s double buffer,
bit-identical to the synchronous path; it needs a stateless,
chunk-streamable pipeline.

Sharded server decode (``RoundConfig(ownership=True)``): step 5 runs
owner-partitioned (``dist.collectives.sharded_decode``: the same slices and
offsets a mesh's owners would decode, here one after another), and
``History.intra_pod_bytes`` ledgers the modelled server-side receive
traffic, which the ownership route strictly reduces at n_owners >= 2
whenever remote payload bytes exceed the decoded vector's d bytes.

On the card the driver reads the device four times a round, all the JAX
package's own semantics: the two ``float(mse)`` of the History, the
task's metric and, when tracked, the wavg tracker's ``float(r_exact)``
(and the previous estimate's chunk mass under ``adaptive_budgets``).
Nothing else reads a tensor on the host: spans, markers and the ledgers
take Python ints.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import obs, resolve_device
from ..core import chunking, correlation
from ..core import random as prand
from ..core.codec import (
    ClientState,
    adaptive_chunk_budgets,
    as_pipeline,
    coded_payload_nbytes,
    with_staleness,
)
from ..dist import collectives
from . import server as server_lib
from .clients import Cohort, Participation
from .tasks import Task


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    n_rounds: int = 20
    seed: int = 0
    temporal: bool = False      # broadcast temporal: decode deltas vs prev estimate
    track_r: bool | None = None  # default: only for transform="wavg"
    r_gamma: float = 0.3
    backend: str = "local"      # local | gspmd | shard_map
    mesh: Any = None            # a DeviceMesh, required for gspmd / shard_map
    client_axes: tuple = ("pod",)
    async_rounds: bool = False  # staleness-1 buffered aggregation
    staleness: int = 1          # max admitted payload age; 0 = drop late payloads
    stale_weight: float = 1.0   # per-client weight of an admitted stale payload
    overlap: bool = False       # double-buffered chunk streaming in the decode
    overlap_tile: int = 1       # chunks per stream tile
    ownership: bool = False     # sharded server decode (chunk ownership)
    # per-chunk adaptive budgets: rewrite each round's chunk budget vector
    # from the previous estimate's per-chunk norm mass (rand_k only, local
    # backend, flat hierarchy, sync rounds)
    adaptive_budgets: bool = False
    # logical owner shards on local/gspmd (0 = one owner on local, the mesh's
    # client shards on gspmd); the shard_map backend always uses the mesh's
    # client shards (the all_to_all routing must match the ranks)
    n_owners: int = 0
    # hierarchical (per-pod) aggregation: "hier" decodes pod-local (each
    # pod's server sees only its cohort, carries its own online R estimate)
    # then combines d-sized estimates across pods. Bitwise "flat" at pods=1.
    hierarchy: str = "flat"     # flat | hier
    pods: int = 1               # pod count under hierarchy="hier"
    # runtime.RuntimeContext for multi-process execution (None = all pods
    # decoded in this process; ignored under hierarchy="flat")
    runtime: Any = None


@dataclasses.dataclass
class _StaleBuffer:
    """Round t's straggler encodes, waiting for admission at round t+1.

    The simulation stores the encode INPUTS (round key, chunk rows, side
    information / temporal-memory snapshot) rather than the arrays that
    crossed the wire: encode is deterministic in them, so the admitted
    payload is re-derived bit-exactly at decode time.
    """

    key: Any            # the round key the stragglers encoded with
    ids: np.ndarray     # straggler client ids
    xs_rows: Any        # (m, C, d_block) their round-t chunk rows
    side: Any           # broadcast side info they encoded against (or None)
    mem_rows: Any       # per-client temporal memory snapshot rows (or None)


@dataclasses.dataclass
class History:
    """Per-round trajectory + ledger. Lists are length n_rounds."""

    metric: list = dataclasses.field(default_factory=list)
    mse: list = dataclasses.field(default_factory=list)      # vs survivors' true mean
    mse_pop: list = dataclasses.field(default_factory=list)  # vs ALL clients' mean
    bytes: list = dataclasses.field(default_factory=list)    # transmitted this round
    # EXACT entropy-coded wire bytes of the same traffic: equal to ``bytes``
    # when the pipeline carries no code stage; stale arrivals are ledgered
    # at raw size (the straggler's coded length belongs to ITS encode round)
    coded_bytes: list = dataclasses.field(default_factory=list)
    n_survivors: list = dataclasses.field(default_factory=list)
    n_sampled: list = dataclasses.field(default_factory=list)
    n_stale: list = dataclasses.field(default_factory=list)  # late payloads admitted
    # late-ARRIVAL bytes (subset of ``bytes``): every late payload that lands
    # is ledgered, admitted into the decode or superseded by a fresh report
    stale_bytes: list = dataclasses.field(default_factory=list)
    # modelled server-side receive traffic of the round's decode, summed over
    # shards (dist.collectives.intra_pod_traffic)
    intra_pod_bytes: list = dataclasses.field(default_factory=list)
    # modelled cross-pod traffic of the hierarchical route (runtime.comms.
    # cross_pod_traffic); all zeros under hierarchy="flat"
    dcn_bytes: list = dataclasses.field(default_factory=list)
    rho_hat: list = dataclasses.field(default_factory=list)  # tracker output (or nan)
    client_state: Any = None  # final stacked ClientState (None if stateless)

    @property
    def total_bytes(self) -> int:
        return int(np.sum(self.bytes))

    @property
    def total_coded_bytes(self) -> int:
        return int(np.sum(self.coded_bytes)) if self.coded_bytes else 0

    @property
    def total_intra_pod_bytes(self) -> int:
        return int(np.sum(self.intra_pod_bytes)) if self.intra_pod_bytes else 0

    @property
    def total_dcn_bytes(self) -> int:
        return int(np.sum(self.dcn_bytes)) if self.dcn_bytes else 0

    @property
    def total_stale_bytes(self) -> int:
        return int(np.sum(self.stale_bytes)) if self.stale_bytes else 0

    def bytes_to_target(self, target: float, key: str = "metric",
                        bytes_key: str = "bytes") -> int | None:
        """Cumulative bytes when the metric first reaches <= target.

        ``bytes_key="coded_bytes"`` accumulates the entropy-coded ledger
        instead of the raw schema bytes."""
        vals, cum = getattr(self, key), np.cumsum(getattr(self, bytes_key))
        for v, b in zip(vals, cum):
            if v is not None and not np.isnan(v) and v <= target:
                return int(b)
        return None

    _RECORD_KEYS = ("metric", "mse", "mse_pop", "bytes", "coded_bytes",
                    "n_survivors", "n_sampled", "n_stale", "stale_bytes",
                    "intra_pod_bytes", "dcn_bytes", "rho_hat")

    def round_records(self) -> list:
        """The trajectory as one dict per round (the ``--metrics-json``
        export): every parallel History list keyed by name, plus the round
        index."""
        return [
            {"round": t, **{k: getattr(self, k)[t] for k in self._RECORD_KEYS}}
            for t in range(len(self.mse))
        ]


def _should_track(pipe, cfg) -> bool:
    return cfg.track_r if cfg.track_r is not None else pipe.transform == "wavg"


def _all_rows(ids, n: int) -> bool:
    """True when ``ids`` (sorted) names every one of the ``n`` rows."""
    return len(ids) == n and np.array_equal(np.asarray(ids), np.arange(n))


def _rows(x: torch.Tensor, ids) -> torch.Tensor:
    """x's rows at ``ids``; x itself (no copy) when ids name every row."""
    if _all_rows(ids, x.shape[0]):
        return x
    return x[torch.as_tensor(np.asarray(ids), device=x.device)]


def _take_state(cstate: ClientState, ids) -> ClientState:
    """The stacked ClientState rows of clients ``ids``."""
    rows = cstate.ef if cstate.ef is not None else cstate.memory
    return cstate if _all_rows(ids, rows.shape[0]) else cstate.rows(np.asarray(ids))


def _put_state(cstate: ClientState, ids, new: ClientState) -> ClientState:
    """``cstate`` with the rows of clients ``ids`` replaced by ``new``."""
    rows = cstate.ef if cstate.ef is not None else cstate.memory
    return new if _all_rows(ids, rows.shape[0]) else cstate.with_rows(np.asarray(ids), new)


def _group_local(pipe_g, key, xs_chunks, ids_g, side, mem_snapshot, cstate,
                 overlap=False, overlap_tile=1, plan=None):
    """One budget group on the local backend. Returns (group mean, updated
    full ClientState, stacked payloads for the tracker; None on the
    overlapped path, which never holds the whole payload stack).

    ``plan`` (ChunkOwnership): run the server decode owner-partitioned, the
    same slices and offsets a mesh's owners would decode."""
    # guard: payload_nbytes builds a PayloadMeta (the disabled path stays free)
    group_bytes = (
        pipe_g.payload_nbytes(xs_chunks.shape[1]) * len(ids_g)
        if obs.enabled() else 0
    )
    # the clients' maps, made once for the encode and the decode (and for
    # every tile of the stream)
    draws = pipe_g.sparsifier.round_draws(key, len(ids_g), xs_chunks.shape[1],
                                          client_ids=ids_g, device=xs_chunks.device)
    if overlap:
        # stateless by construction (run_rounds validates): stream the chunk
        # axis through the dist layer's double buffer, bit-identical. Encode
        # and decode interleave tile by tile, so the timeline gets ONE
        # owner_decode span for the stream and a zero-duration client_encode
        # marker carrying the group's ledger bytes.
        obs.marker("fl", "client_encode", track="client_encode",
                   bytes=group_bytes, clients=len(ids_g), overlap=True)
        _mark_quantize(pipe_g)
        with obs.span("fl", "owner_decode", track="owner_decode",
                      clients=len(ids_g), overlap=True):
            dec, _ = collectives.streamed_mean(
                pipe_g, key, _rows(xs_chunks, ids_g), len(ids_g), client_ids=ids_g,
                side_info=side, tile=overlap_tile, ownership=plan, draws=draws,
            )
        return dec, cstate, None
    st_g = None if cstate is None else _take_state(cstate, ids_g)
    with obs.span("fl", "client_encode", track="client_encode",
                  bytes=group_bytes, clients=len(ids_g), k=pipe_g.k):
        payloads, st_new = pipe_g.encode_all(
            key, _rows(xs_chunks, ids_g), client_ids=ids_g, side_info=side, states=st_g,
            draws=draws,
        )
    _mark_quantize(pipe_g)
    if st_new is not None:
        cstate = _put_state(cstate, ids_g, st_new)
    dec_side = side
    if mem_snapshot is not None:
        # per-client temporal: the server adds back the SURVIVORS' mean
        # memory (its mirror of the clients' side information)
        dec_side = _rows(mem_snapshot, ids_g).mean(0)
    with obs.span("fl", "owner_decode", track="owner_decode",
                  clients=len(ids_g), sharded=plan is not None):
        if plan is not None:
            dec = collectives.sharded_decode(
                pipe_g, key, payloads, len(ids_g), plan, client_ids=ids_g, draws=draws
            )
            if dec_side is not None:
                dec = dec + dec_side
        else:
            dec = pipe_g.decode(
                key, payloads, len(ids_g), client_ids=ids_g, side_info=dec_side, draws=draws
            )
    return dec, cstate, payloads


def _mark_quantize(pipe_g):
    """Attribution marker for the quantize stage: its time is part of the
    client encode, so the timeline names the stage with a zero-duration
    event instead of claiming a separate duration."""
    if obs.enabled():
        q = pipe_g.quantizer
        obs.marker("fl", "quantize", track="quantize",
                   stage="none" if q is None else q.name)


def _ownership_arg(cfg):
    """The ``ownership=`` value forwarded to dist.collectives. On shard_map
    the MESH defines the owners (the all_to_all routing must match the
    ranks, so ``n_owners`` is ignored there); on local/gspmd an explicit
    ``n_owners`` sets the logical owner count, else the plan derives from
    the mesh client axes (one owner on local)."""
    if not cfg.ownership:
        return None
    if cfg.backend == "shard_map":
        return True
    return cfg.n_owners if cfg.n_owners else True


def _group_dist(pipe_g, key, xs_chunks, ids_g, side, mem_snapshot, cstate, cfg):
    """One budget group through dist.collectives (gspmd / shard_map).

    Per-client temporal memories compose here the same way the stale decode
    composes everywhere: the collectives move DELTAS (each client's chunk
    rows minus its own memory row, the exact subtraction the local encode
    performs), and the server mirrors the deterministic ClientState updates
    by re-running ``encode_all`` on its side (same key / ids / side /
    residual => identical payloads => identical memory and EF updates). The
    collective's own ``ef_next`` is ignored in that case: the mirror
    computes both new buffers in one pass.

    On shard_map the collective takes this rank's rows and gives back this
    rank's residual rows; the driver keeps every client's state on every
    rank (it reports them all), so it gathers the new rows after the
    exchange, which itself never sends a residual.

    Returns (group mean, updated state, bytes, intra-pod bytes, delta)."""
    if mem_snapshot is not None:
        delta = xs_chunks - mem_snapshot  # per-client side info, row-wise
    elif side is not None:
        delta = xs_chunks - side[None]
    else:
        delta = xs_chunks
    ef_arr = cstate.ef if (cstate is not None and pipe_g.has_ef) else None
    n_total = xs_chunks.shape[0]
    shard_map = cfg.backend == "shard_map"
    if shard_map:
        if cfg.mesh is None:
            raise ValueError("backend='shard_map' needs cfg.mesh")
        n_shards, shard = collectives.client_shard(cfg.mesh, cfg.client_axes)
        shard_map = n_total % n_shards == 0
    if shard_map:
        n_local = n_total // n_shards
        lo, hi = shard * n_local, (shard + 1) * n_local
        mean_tree, info, ef_next = collectives.compressed_mean_tree_shardmap(
            pipe_g, key, {"x": delta[lo:hi]}, cfg.mesh, client_axes=cfg.client_axes,
            participants=ids_g, ef_chunks=None if ef_arr is None else ef_arr[lo:hi],
            overlap=cfg.overlap, overlap_tile=cfg.overlap_tile,
            ownership=_ownership_arg(cfg), device=xs_chunks.device,
        )
        if ef_next is not None and mem_snapshot is None:
            ef_next = collectives.gather_clients(ef_next, cfg.mesh, cfg.client_axes)
    else:
        mean_tree, info, ef_next = collectives.compressed_mean_tree(
            pipe_g, key, {"x": delta}, collectives.dme_shardings(cfg.mesh, cfg.client_axes),
            participants=ids_g, ef_chunks=ef_arr, overlap=cfg.overlap,
            overlap_tile=cfg.overlap_tile, ownership=_ownership_arg(cfg),
            device=xs_chunks.device,
        )
    if mem_snapshot is not None:
        # mirror the clients' deterministic state transition server-side
        # (memory AND ef rows advance together inside encode_all)
        _, st_new = pipe_g.encode_all(
            key, _rows(xs_chunks, ids_g), client_ids=ids_g, states=_take_state(cstate, ids_g)
        )
        cstate = _put_state(cstate, ids_g, st_new)
    elif ef_next is not None:
        cstate = ClientState(ef=ef_next, memory=cstate.memory)
    mean_g = mean_tree["x"]
    if mem_snapshot is not None:
        mean_g = mean_g + _rows(mem_snapshot, ids_g).mean(0)
    elif side is not None:
        mean_g = mean_g + side
    # the dist paths encode, route and decode inside one collectives call,
    # so the phases get attribution markers here, bytes off the collectives'
    # exact ledger
    obs.marker("fl", "client_encode", track="client_encode",
               bytes=info["bytes_sent"], clients=len(ids_g), backend=cfg.backend)
    _mark_quantize(pipe_g)
    obs.marker("fl", "owner_decode", track="owner_decode",
               clients=len(ids_g), backend=cfg.backend)
    return mean_g, cstate, info["bytes_sent"], info["intra_pod_bytes"], delta


def _rederive_payloads(pipe_g, key, xs_chunks, side, ids_g, cstate):
    """Re-derive the group's transmitted payloads server-side (same key / ids
    / side / residual => identical payloads: encode is deterministic in
    them). Costs one extra encode of the group's survivors. Used where the
    payload stack never materialised: the overlapped path, for the tracker
    and the coded-bytes ledger. The side information is subtracted from the
    group's rows only, never from the whole cohort's chunks."""
    enc_in = _rows(xs_chunks, ids_g)
    if side is not None:
        enc_in = enc_in - side[None]
    if pipe_g.has_ef and cstate is not None and cstate.ef is not None:
        # ``cstate`` is the PRE-update state (the residual the clients added
        # before encoding), so the re-derived payloads match what was sent.
        enc_in = enc_in + _rows(cstate.ef, ids_g)
    payloads, _ = pipe_g.encode_all(key, enc_in, client_ids=ids_g)
    return payloads


def _measure_rho_dist(pipe_g, key, xs_chunks, side, ids_g, cstate):
    payloads = _rederive_payloads(pipe_g, key, xs_chunks, side, ids_g, cstate)
    return server_lib.measure_rho(pipe_g, key, payloads, ids_g)


def _side_and_memory(pipe, cfg, state_srv, cstate):
    """Round-start snapshot of the side information the clients encode
    against: (broadcast side info | None, per-client memory snapshot | None).
    Taken BEFORE any state row updates so straggler encodes (async mode) see
    exactly what an on-time encode would have."""
    if pipe.has_client_temporal:
        return None, cstate.memory
    if cfg.temporal or (pipe.temporal_stage is not None):
        return server_lib.side_info_for(state_srv, temporal=True), None
    return None, None


def _decode_round(pipe, key, xs_chunks, part, cohort, state_srv, cfg, cstate,
                  side, mem_snapshot):
    """Budget-grouped encode/decode over the survivors.

    Returns (mean_chunks, bytes_sent, coded_sent, intra_pod, rho_round,
    cstate). ``coded_sent`` is the exact entropy-coded wire ledger of the
    same payloads: equal to ``bytes_sent`` when the pipeline carries no
    code stage, else the summed per-client coded stream lengths
    (re-derived server-side where the payload stack never materialised)."""
    groups = cohort.budget_groups(part.survivors, pipe.k)
    track = _should_track(pipe, cfg)
    n_eff = part.n_survivors
    n_chunks = xs_chunks.shape[1]
    plan = None
    if cfg.ownership and cfg.backend == "local":
        plan = collectives.ownership_plan(
            _ownership_arg(cfg), n_chunks, max(1, cfg.n_owners)
        )
    # per-chunk adaptive budgets: the previous estimate's per-chunk norm mass
    # sets this round's budget vector (round 0 has no estimate => uniform,
    # i.e. chunk_budgets stays unset); one host read of (C,) floats
    chunk_mass = None
    if cfg.adaptive_budgets and state_srv.prev_mean is not None:
        chunk_mass = state_srv.prev_mean.square().sum(-1).cpu().numpy()

    mean_chunks, bytes_sent, coded_sent, intra_pod, rho_parts = (
        None, 0, 0, 0, [])
    for k_g, ids_g in groups:
        if len(ids_g) == 0:
            continue
        pre_state = cstate
        pipe_g = server_lib.resolve_pipeline(
            pipe.with_budget(k_g), state_srv, len(ids_g)
        )
        if chunk_mass is not None:
            pipe_g = pipe_g.replace_sparsifier(
                chunk_budgets=adaptive_chunk_budgets(
                    chunk_mass, k_g, pipe.d_block)
            )
        if cfg.backend == "local":
            dec, cstate, payloads = _group_local(
                pipe_g, key, xs_chunks, ids_g, side, mem_snapshot, cstate,
                overlap=cfg.overlap, overlap_tile=cfg.overlap_tile, plan=plan,
            )
            raw_g = pipe_g.payload_nbytes(n_chunks) * len(ids_g)
            intra_pod += collectives.intra_pod_traffic(
                pipe_g, len(ids_g), n_chunks,
                plan.n_shards if plan is not None else 1, plan=plan,
            )["intra_pod_bytes"]
            enc_rows, enc_side = xs_chunks, side
        else:
            dec, cstate, raw_g, intra_g, enc_rows = _group_dist(
                pipe_g, key, xs_chunks, ids_g, side, mem_snapshot, cstate, cfg
            )
            payloads, enc_side = None, None
            intra_pod += intra_g
        bytes_sent += raw_g
        if pipe_g.code_stage is None:
            coded_sent += raw_g
        else:
            pl = payloads if payloads is not None else _rederive_payloads(
                pipe_g, key, enc_rows, enc_side, ids_g, pre_state)
            coded_sent += coded_payload_nbytes(pipe_g, pl)
        if not track:
            rho_g = None
        elif payloads is not None:
            rho_g = server_lib.measure_rho(pipe_g, key, payloads, ids_g)
        else:
            rho_g = _measure_rho_dist(pipe_g, key, enc_rows, enc_side, ids_g, pre_state)
        w = len(ids_g) / n_eff
        mean_chunks = dec * w if mean_chunks is None else mean_chunks + dec * w
        if rho_g is not None:
            rho_parts.append((rho_g, len(ids_g)))

    # one EMA step per ROUND: combine the groups' measurements weighted by
    # participant count (more clients => tighter estimate)
    rho_round = None
    if rho_parts:
        wsum = sum(w for _, w in rho_parts)
        rho_round = sum(r * w for r, w in rho_parts) / wsum
        server_lib.ema_update(state_srv, rho_round, gamma=cfg.r_gamma)
    return mean_chunks, bytes_sent, coded_sent, intra_pod, rho_round, cstate


def _stale_arrival_bytes(pipe, buf: _StaleBuffer, cohort, n_chunks: int) -> int:
    """Wire bytes of ALL late arrivals in ``buf``: every payload that lands
    is ledgered, whether the decode admits it or a fresh report supersedes
    it (the transmission happened either way)."""
    return sum(
        pipe.with_budget(k_g).payload_nbytes(n_chunks) * len(ids_g)
        for k_g, ids_g in cohort.budget_groups(buf.ids, pipe.k)
    )


def _decode_stale(pipe, buf: _StaleBuffer, admit: np.ndarray, cohort,
                  state_srv):
    """Admit round t-1's late payloads into this round's decode.

    Re-derives the admitted stragglers' payloads from the buffered encode
    inputs (their OWN round key / side information), tags them
    ``staleness=1``, and decodes per budget group exactly like a fresh
    group. Returns the stale mean (C, d_block).
    """
    pos = {int(i): j for j, i in enumerate(buf.ids)}
    n_adm = len(admit)
    mean = None
    for k_g, ids_g in cohort.budget_groups(admit, pipe.k):
        if len(ids_g) == 0:
            continue
        pipe_g = server_lib.resolve_pipeline(
            pipe.with_budget(k_g), state_srv, len(ids_g)
        )
        sel = np.asarray([pos[int(i)] for i in ids_g])
        st_g = None
        if buf.mem_rows is not None:
            # per-client temporal: each straggler encoded against its OWN
            # memory snapshot (ClientState row at its encode time)
            st_g = ClientState(ef=None, memory=_rows(buf.mem_rows, sel))
        payloads, _ = pipe_g.encode_all(
            buf.key, _rows(buf.xs_rows, sel), client_ids=ids_g, side_info=buf.side,
            states=st_g,
        )
        payloads = with_staleness(payloads, 1)
        dec_side = buf.side
        if buf.mem_rows is not None:
            dec_side = _rows(buf.mem_rows, sel).mean(0)
        dec = pipe_g.decode(
            buf.key, payloads, len(ids_g), client_ids=ids_g, side_info=dec_side
        )
        w = len(ids_g) / n_adm
        mean = dec * w if mean is None else mean + dec * w
    return mean


def _hier_round(pipe, rkey, xs_chunks, part, cohort, hier, cfg, cstate, side,
                mem_snapshot, stale_buf, n_chunks):
    """One hierarchical round: per OWNED pod, a pod-local fresh sub-decode
    against that pod's own ``ServerState`` (followed by that pod's stale
    sub-decode in async mode), then the cross-pod record exchange and the
    deterministic ascending-pod combine.

    Every process runs this with the same global inputs (task vectors,
    participation and stale buffer are deterministic replicas) but decodes
    only its owned pods; after ``exchange`` all processes hold identical
    records and reduce them identically: there is no root process. A pod's
    record carries its decode as a tensor on the round's device; only the
    cross-process exchange takes it through the host, bit for bit.

    Returns (mean_chunks, nbytes, coded, intra_pod, dcn_info, rho_round,
    cstate, n_stale)."""
    from ..runtime import comms as comms_lib
    from ..runtime import hierarchy as hier_lib

    plan = hier.plan
    admit = np.asarray([], dtype=part.survivors.dtype)
    if cfg.async_rounds and stale_buf is not None and cfg.staleness >= 1:
        admit = np.setdiff1d(stale_buf.ids, part.survivors)

    owned = {}
    for p in hier.owned_pods:
        part_p = Participation(sampled=plan.restrict(part.sampled, p),
                               survivors=plan.restrict(part.survivors, p))
        rec = {"n": part_p.n_survivors, "mean": None, "bytes": 0, "coded": 0,
               "intra": 0, "rho": None, "n_admit": 0, "stale_mean": None}
        if part_p.n_survivors:
            with obs.span("fl", f"pod{p}", track=f"pod{p}", pod=p,
                          survivors=part_p.n_survivors):
                dec, nb, coded_p, intra, rho_p, cstate = _decode_round(
                    pipe, rkey, xs_chunks, part_p, cohort, hier.pod_states[p], cfg, cstate,
                    side, mem_snapshot,
                )
            obs.count("runtime", "pod.decodes", pod=p)
            rec.update(mean=dec, bytes=int(nb), coded=int(coded_p), intra=int(intra),
                       rho=rho_p)
        admit_p = plan.restrict(admit, p)
        if len(admit_p):
            stale_p = _decode_stale(pipe, stale_buf, admit_p, cohort, hier.pod_states[p])
            rec.update(n_admit=int(len(admit_p)), stale_mean=stale_p)
        owned[p] = rec

    records = hier.exchange.exchange(owned)
    # remote pods' wire bytes still land on this process's trace, so the
    # byte-equality gate (trace sum == History ledger) holds per process
    owned_set = set(hier.owned_pods)
    remote_bytes = sum(r["bytes"] for q, r in records.items() if q not in owned_set)
    obs.marker("fl", "client_encode", track="client_encode",
               bytes=int(remote_bytes), remote=True, hierarchy="hier")

    mean_chunks, _, _ = hier_lib.combine_records(records)
    nbytes = sum(r["bytes"] for r in records.values())
    coded = sum(r["coded"] for r in records.values())
    intra = sum(r["intra"] for r in records.values())
    rho_round = hier_lib.combine_rho(records)

    stale_mean, n_stale, _ = hier_lib.combine_records(records, key="stale_mean",
                                                      count_key="n_admit")
    stale_pods = sum(1 for q, r in records.items() if q != 0 and r["n_admit"] > 0)
    dcn_info = comms_lib.cross_pod_traffic(
        pipe, cohort, part.survivors, plan, n_chunks, stale_pods=stale_pods,
        hierarchy="hier",
    )
    if n_stale:
        mean_chunks = server_lib.admit_stale(
            mean_chunks, part.n_survivors, stale_mean, n_stale, cfg.stale_weight,
        )
    return mean_chunks, nbytes, coded, intra, dcn_info, rho_round, cstate, n_stale


def _advance_straggler_state(pipe, key, xs_chunks, stragglers, cohort, cstate):
    """Async mode: stragglers DID encode this round (late), so their
    client-held temporal memories advance exactly as a survivor's would;
    the server mirrors the update when the payload arrives next round."""
    if cstate is None or not pipe.has_client_temporal:
        return cstate
    for k_g, ids_g in cohort.budget_groups(stragglers, pipe.k):
        if len(ids_g) == 0:
            continue
        _, st_new = pipe.with_budget(k_g).encode_all(
            key, _rows(xs_chunks, ids_g), client_ids=ids_g,
            states=_take_state(cstate, ids_g)
        )
        if st_new is not None:
            cstate = _put_state(cstate, ids_g, st_new)
    return cstate


def _validate_cfg(pipe, cfg):
    if cfg.async_rounds:
        if cfg.staleness not in (0, 1):
            raise ValueError(
                f"async rounds support staleness 0 (drop late payloads) or 1 "
                f"(admit next round); got {cfg.staleness}"
            )
        if pipe.has_ef:
            raise ValueError(
                "error feedback does not compose with async rounds: the EF "
                "residual is defined by what the server RECEIVED, which is "
                "unknown while a payload is still in flight — drop the "
                "ErrorFeedback stage or run sync rounds"
            )
    if cfg.overlap:
        if pipe.stateful:
            raise ValueError(
                "overlap=True requires a stateless pipeline: EF residuals "
                "and temporal-memory updates are round-synchronous (they "
                "need the whole payload before the next round encodes)"
            )
        collectives.check_streamable(pipe)
    if cfg.ownership:
        # per-client temporal composes: the mean-memory add-back is
        # position-wise (each owner adds its slice) and the memory update
        # runs client-local from full payloads, exactly as without ownership
        collectives.check_shardable(pipe)
        if cfg.n_owners < 0:
            raise ValueError(f"n_owners must be >= 0, got {cfg.n_owners}")
    if cfg.adaptive_budgets:
        if getattr(pipe.sparsifier, "name", None) != "rand_k":
            raise ValueError(
                "adaptive_budgets rewrites rand_k's chunk_budgets vector; "
                f"the {getattr(pipe.sparsifier, 'name', '?')!r} sparsifier "
                "has no per-chunk budget mechanism"
            )
        if cfg.backend != "local" or cfg.hierarchy != "flat":
            raise ValueError(
                "adaptive_budgets requires backend='local' and "
                "hierarchy='flat': the per-round budget vector depends on "
                "the server's previous estimate, which the dist/hier routes "
                "do not rebroadcast to the encode side"
            )
        if cfg.async_rounds:
            raise ValueError(
                "adaptive_budgets does not compose with async rounds: a "
                "stale payload was encoded under the PREVIOUS round's budget "
                "vector, which the admitting round no longer holds"
            )
        if cfg.overlap or cfg.ownership:
            raise ValueError(
                "adaptive_budgets packs one flat value row per client "
                "(non-streamable, non-shardable); drop overlap/ownership"
            )
    if cfg.hierarchy not in ("flat", "hier"):
        raise ValueError(f"hierarchy must be 'flat' or 'hier', got "
                         f"{cfg.hierarchy!r}")
    if cfg.hierarchy == "hier":
        if cfg.pods < 1:
            raise ValueError(f"pods must be >= 1, got {cfg.pods}")
        if cfg.backend != "local":
            raise ValueError(
                "hierarchy='hier' requires backend='local': each pod's "
                "sub-decode drives the pipeline directly (the dist backends "
                "model ONE pod's mesh; cross-pod transport is "
                "runtime.comms)"
            )
    if cfg.backend not in ("local", "gspmd", "shard_map"):
        raise ValueError(f"unknown backend {cfg.backend!r}")


def _chunk_rows(vecs: torch.Tensor, d_block: int) -> torch.Tensor:
    """(n, dim) client vectors -> (n, C, d_block) chunks, each row padded as
    ``chunking.chunk`` pads; a view of ``vecs`` when no padding is needed."""
    n, dim = vecs.shape
    pad = chunking.num_chunks(dim, d_block) * d_block - dim
    if pad:
        vecs = torch.nn.functional.pad(vecs, (0, pad))
    return vecs.reshape(n, -1, d_block)


def run_rounds(task: Task, spec, cohort: Cohort | None = None,
               cfg: RoundConfig = RoundConfig(), *, device=None):
    """Drive ``cfg.n_rounds`` federated rounds of ``task`` under ``spec`` (a
    codec Pipeline or sparsifier config), on ``device`` (the card when
    None), where the task's data must live.

    Returns (final task state, History). The recorded per-round ``mse`` is
    against the SURVIVORS' true mean, the quantity the estimator targets
    once stragglers are dropped; ``mse_pop`` is against ALL clients'
    current-round mean (the quantity FL ultimately wants), which is where
    admitting a late payload instead of dropping it shows up.

    Async mode (``cfg.async_rounds``): stragglers encode late; their
    payloads are buffered and admitted into the next round's decode at
    staleness 1 (``cfg.staleness=0`` drops them, the pure-scheduling
    ablation). With ``cohort.dropout == 0`` async output is bit-identical
    to sync.
    """
    pipe = as_pipeline(spec)
    cohort = cohort or Cohort(n_clients=task.n_clients)
    if cohort.n_clients != task.n_clients:
        raise ValueError("cohort and task disagree on n_clients")
    _validate_cfg(pipe, cfg)
    dev = resolve_device(device)
    if task.device.type != dev.type:
        raise ValueError(f"the task's data live on {task.device}, the rounds would run on "
                         f"{dev}; build the task with get_task(..., device={str(dev)!r})")

    key = prand.key(cfg.seed, dev)
    state = task.init(key)
    state_srv = server_lib.ServerState()
    hist = History()
    n_chunks = chunking.num_chunks(task.dim, pipe.d_block)
    cstate = cohort.init_state(pipe, n_chunks, device=dev)
    stale_buf: _StaleBuffer | None = None

    hier = None
    if cfg.hierarchy == "hier":
        # runtime.hierarchy imports fl.server, so the module edge points
        # runtime -> fl at import time, fl -> runtime only at call time
        from ..runtime import hierarchy as hier_lib

        hier = hier_lib.HierarchicalAggregator(
            hier_lib.PodPlan(cohort.n_clients, cfg.pods), ctx=cfg.runtime
        )

    for t in range(cfg.n_rounds):
        tr = obs.current_tracer()
        if tr is not None:
            tr.set_round(t)
        round_span = obs.span("fl", "round", track="round")
        rsp = round_span.__enter__()
        rkey = prand.fold_in(key, t)
        vecs = task.client_vectors(state, rkey)  # (n, dim)
        part = cohort.sample_round(cfg.seed, t)
        xs_chunks = _chunk_rows(vecs, pipe.d_block)
        del vecs
        side, mem_snapshot = _side_and_memory(pipe, cfg, state_srv, cstate)

        if hier is not None:
            (mean_chunks, nbytes, coded, intra_pod, dcn_info, rho_round,
             cstate, n_stale) = _hier_round(
                pipe, rkey, xs_chunks, part, cohort, hier, cfg, cstate,
                side, mem_snapshot, stale_buf, n_chunks,
            )
            dcn = dcn_info["dcn_bytes"]
        else:
            (mean_chunks, nbytes, coded, intra_pod, rho_round,
             cstate) = _decode_round(
                pipe, rkey, xs_chunks, part, cohort, state_srv, cfg, cstate,
                side, mem_snapshot,
            )
            dcn = 0
        # intra-pod and DCN traffic are modelled tier quantities, deliberately
        # keyed ``bytes_intra_pod`` / ``bytes_dcn`` so they never enter the
        # wire-ledger sum
        obs.marker("fl", "payload_route", track="payload_route",
                   bytes_intra_pod=intra_pod, bytes_dcn=dcn,
                   backend=cfg.backend)

        # ---- staleness-1 admission: last round's late payloads land now.
        # EVERY arrival is ledgered (it crossed the wire), but a client that
        # ALSO reported fresh this round supersedes its own stale payload,
        # so only the non-superseded set enters the decode. (Hierarchical
        # rounds already decoded and combined the admitted groups per pod
        # inside ``_hier_round``; only the arrival ledger lands here.)
        with obs.span("fl", "stale_admission", track="stale_admission") as ssp:
            stale_nbytes = 0
            if hier is None:
                n_stale = 0
            if cfg.async_rounds and stale_buf is not None and cfg.staleness >= 1:
                stale_nbytes = _stale_arrival_bytes(pipe, stale_buf, cohort,
                                                    n_chunks)
                nbytes += stale_nbytes
                # stale arrivals enter the coded ledger at raw size (see the
                # History.coded_bytes comment)
                coded += stale_nbytes
                admit = (np.setdiff1d(stale_buf.ids, part.survivors) if hier is None
                         else ())
                if len(admit):
                    stale_mean = _decode_stale(
                        pipe, stale_buf, admit, cohort, state_srv
                    )
                    n_stale = len(admit)
                    mean_chunks = server_lib.admit_stale(
                        mean_chunks, part.n_survivors, stale_mean,
                        n_stale, cfg.stale_weight,
                    )
                    del stale_mean
            # the admitted buffer's rows are dead from here on
            stale_buf = None
            ssp["bytes"] = stale_nbytes
            ssp["admitted"] = n_stale

        # ---- this round's stragglers encode NOW (overlapping the server's
        # decode above); buffer their encode inputs for admission at t+1.
        # staleness=0 drops late payloads entirely: no buffer, and no state
        # advance either (a payload the server never sees must not move the
        # memory mirror), exactly the sync drop semantics.
        if cfg.async_rounds and cfg.staleness >= 1 and len(part.stragglers):
            stale_buf = _StaleBuffer(
                key=rkey, ids=part.stragglers, xs_rows=_rows(xs_chunks, part.stragglers),
                side=side,
                mem_rows=None if mem_snapshot is None else _rows(mem_snapshot,
                                                                 part.stragglers),
            )
            # hierarchical multi-process: a process mirrors only its owned
            # pods' client rows (pod ownership is static, so the other rows'
            # encodes happen elsewhere)
            strag_adv = part.stragglers
            if hier is not None:
                strag_adv = strag_adv[np.isin(strag_adv, hier.owned_clients())]
            cstate = _advance_straggler_state(
                pipe, rkey, xs_chunks, strag_adv, cohort, cstate
            )

        pop_mean = xs_chunks.mean(0)
        true_mean = (pop_mean if _all_rows(part.survivors, task.n_clients)
                     else _rows(xs_chunks, part.survivors).mean(0))
        hist.mse.append(float(correlation.mse(mean_chunks, true_mean)))
        hist.mse_pop.append(float(correlation.mse(mean_chunks, pop_mean)))
        del true_mean, pop_mean
        hist.bytes.append(int(nbytes))
        hist.coded_bytes.append(int(coded))
        hist.n_survivors.append(part.n_survivors)
        hist.n_sampled.append(part.n_sampled)
        hist.n_stale.append(n_stale)
        hist.stale_bytes.append(int(stale_nbytes))
        hist.intra_pod_bytes.append(int(intra_pod))
        hist.dcn_bytes.append(int(dcn))
        hist.rho_hat.append(float("nan") if rho_round is None else rho_round)
        del xs_chunks

        with obs.span("fl", "temporal_update", track="temporal_update",
                      temporal=bool(cfg.temporal or pipe.temporal_stage)):
            server_lib.commit_round(state_srv, mean_chunks)
        mean = chunking.unchunk(mean_chunks, task.dim)
        state = task.step(state, mean)
        hist.metric.append(
            float("nan") if task.metric is None else task.metric(state)
        )
        rsp["mse"] = hist.mse[-1]
        rsp["wire_bytes"] = nbytes
        # coded ledger rides the round summary under its own key so the
        # trace's exact ``bytes`` sum (client_encode/stale_admission only)
        # stays untouched
        rsp["bytes_coded"] = int(coded)
        rsp["survivors"] = part.n_survivors
        round_span.__exit__(None, None, None)

    tr = obs.current_tracer()
    if tr is not None:
        tr.set_round(None)
    hist.client_state = cstate
    return state, hist
