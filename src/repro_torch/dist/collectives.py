"""Compressed-mean collective: the paper's DME as a cross-client gradient
exchange (port of repro/dist/collectives.py, local route).

``compressed_mean_tree`` flattens each client's tree, chunks it to
``d_block``, runs the pipeline's encode at every client, decodes the
cross-client mean once at the "server" and restores the tree. Only payloads
are notionally transmitted; ``info`` carries the byte accounting, read off
the pipeline's declared ledger.

Partial participation (``participants``): only the named clients encode;
the decode re-derives THEIR maps and normalises by how many reported.

Error feedback (a pipeline with an ``ErrorFeedback`` stage): each
participant encodes its chunks plus its residual row of ``ef_chunks`` and
keeps ``x - self_decode(payload)`` as the next residual; non-participants'
rows carry over.

Overlapped stream (``overlap=True``, ``streamed_mean``): the chunk axis
streams through a double buffer, the encode of tile c+1 issued before the
decode of tile c, so on the card the next tile's encode is queued while the
previous tile decodes. Bit-identical to the synchronous path; it needs a
``chunk_streamable`` pipeline and raises otherwise.

Sharded server decode (``ownership=``, ``sharded_decode``): a
``dist.sharding.ChunkOwnership`` plan gives each owner a contiguous slice
of the chunk grid; each owner decodes only its slice at its global chunk
offset, and the slices are concatenated. In one process the owners are
logical and run one after another: the partition changes no numbers, and
``info`` reports the modelled ``intra_pod_bytes`` columns at the plan's
shard count. Bit-identical to the whole decode for every
``decode_shardable`` pipeline (within float tolerance for the gram
decode's online R-hat).

The GSPMD ``shardings`` and the shard_map route are ROADMAP A.9 and raise
NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs, resolve_device
from ..core import chunking
from ..core.codec import Payload, as_pipeline
from ..core.codec.payload import arrays_of, meta_of
from . import sharding as shard_lib


def _chunk_clients(tree, d_block: int):
    """Per-client flatten + chunk; tree leaves carry a leading client axis n.

    -> (chunks (n, C, d_block), restore_fn for one client's (C, d_block), n,
    d_flat).
    The chunk tensor is allocated once and every leaf copied into it, in
    ravel_pytree order."""
    leaves = chunking.tree_leaves(tree)
    n = leaves[0].shape[0]
    d_flat = sum(leaf[0].numel() for leaf in leaves)
    n_chunks = chunking.num_chunks(d_flat, d_block)
    flat = torch.zeros((n, n_chunks * d_block), dtype=chunking.flat_dtype(leaves),
                       device=leaves[0].device)
    off = 0
    for leaf in leaves:
        size = leaf[0].numel()
        flat[:, off:off + size] = leaf.reshape(n, size)
        off += size
    unravel = chunking.unraveler(tree, lead=1)

    def restore(xc_hat: torch.Tensor):
        return unravel(chunking.unchunk(xc_hat, d_flat))

    return flat.reshape(n, n_chunks, d_block), restore, n, d_flat


def _info(pipe, n: int, d_flat: int, n_chunks: int, n_total: int | None = None,
          n_shards: int = 1, plan=None) -> dict:
    # declared ledger from the payload schema, held against the actual
    # tensor bytes by codec.check_against_schema
    per_client = pipe.payload_nbytes(n_chunks)
    return {
        "n_clients": n,
        "n_total": n if n_total is None else n_total,
        "n_chunks": n_chunks,
        "d_flat": d_flat,
        "d_block": pipe.d_block,
        "full_bytes": d_flat * 4,  # uncompressed float32 exchange baseline
        "payload_bytes_per_client": per_client,
        "bytes_sent": per_client * n,
        **intra_pod_traffic(pipe, n, n_chunks, n_shards, plan=plan),
    }


def intra_pod_traffic(pipe, n: int, n_chunks: int, n_shards: int, plan=None) -> dict:
    """Modelled server-side (intra-pod) RECEIVE bytes of one decode, summed
    over all shards: the quantity the sharded decode exists to cut.

    - ``intra_pod_bytes_allgather``: the replicated decode all-gathers every
      remote client's full payload to every shard:
      ``n_shards * n_remote * payload_nbytes(n_chunks)``.
    - ``intra_pod_bytes_ownership``: the ownership route delivers each shard
      only its owned chunk slice, then assembles decoded means (d_block
      float32 bytes a chunk) with one all-gather:
      ``n_shards * n_remote * payload_nbytes(chunks_per_owner)
      + n_shards * (n_shards - 1) * chunks_per_owner * d_block * 4``.
    - ``intra_pod_bytes``: the column for the route taken (``ownership``
      when a plan is in force, else ``allgather``).

    ``n_remote = n - n/n_shards`` is the clients whose payloads must cross a
    shard boundary to reach one given shard. At ``n_shards == 1`` all
    columns are 0. The ownership column counts the PADDED slice width.
    """
    if n_shards <= 1:
        return {
            "n_shards": max(1, n_shards),
            "intra_pod_bytes_allgather": 0,
            "intra_pod_bytes_ownership": 0,
            "intra_pod_bytes": 0,
        }
    n_remote = n - n / n_shards
    allgather = n_shards * n_remote * pipe.payload_nbytes(n_chunks)
    eff = plan if plan is not None else shard_lib.chunk_ownership(n_chunks, n_shards)
    cpo = eff.chunks_per_owner
    ownership = (
        n_shards * n_remote * pipe.payload_nbytes(cpo)
        + n_shards * (n_shards - 1) * cpo * pipe.d_block * 4
    )
    return {
        "n_shards": n_shards,
        "intra_pod_bytes_allgather": int(round(allgather)),
        "intra_pod_bytes_ownership": int(round(ownership)),
        "intra_pod_bytes": int(round(ownership if plan is not None else allgather)),
    }


def intra_pod_reduction(info: dict) -> float | None:
    """allgather/ownership server-side traffic ratio from an ``info`` dict
    (``compressed_mean_tree`` or ``intra_pod_traffic``). > 1 means the
    sharded decode receives fewer bytes than the replicated all-gather
    decode. None when the decode ran on a single shard."""
    own = info.get("intra_pod_bytes_ownership", 0)
    ag = info.get("intra_pod_bytes_allgather", 0)
    if not own or not ag:
        return None
    return ag / own


def ownership_plan(ownership, n_chunks: int, n_shards: int):
    """Normalise the ``ownership=`` argument: None/False -> no plan;
    True -> plan over ``n_shards``; int -> plan over that many shards;
    a ``ChunkOwnership`` -> validated pass-through."""
    if ownership is None or ownership is False:
        return None
    if isinstance(ownership, shard_lib.ChunkOwnership):
        if ownership.n_chunks != n_chunks:
            raise ValueError(
                f"ownership plan covers {ownership.n_chunks} chunks but the "
                f"payload grid has {n_chunks}"
            )
        return ownership
    if ownership is True:
        return shard_lib.chunk_ownership(n_chunks, max(1, n_shards))
    return shard_lib.chunk_ownership(n_chunks, int(ownership))


def _participant_ids(participants, n_total: int) -> np.ndarray:
    """Normalise a participation mask/index list to a concrete id array."""
    p = np.asarray(participants)
    if p.dtype == bool:
        p = np.flatnonzero(p)
    if p.size == 0:
        raise ValueError("participation mask selects zero clients")
    if p.max() >= n_total or p.min() < 0:
        raise ValueError(f"participant id out of range [0, {n_total})")
    return p.astype(np.int64)


def check_streamable(pipe) -> None:
    """Raise unless ``pipe`` may stream the chunk axis (``overlap=True``),
    naming the offending stage so the caller knows what to change."""
    offender = pipe.non_streamable_stage
    if offender is not None:
        stage, reason = offender
        raise ValueError(
            "overlap=True needs a chunk-streamable pipeline (per-chunk "
            "randomness independent of chunk position), but stage "
            f"{type(stage).__name__} of {pipe.describe()!r} {reason}. "
            "Run it with overlap=False instead."
        )


def check_shardable(pipe) -> None:
    """Raise unless ``pipe`` may decode owner-sliced (``ownership=``),
    naming the offending stage. Weaker than ``check_streamable``: clients
    always encode full vectors, only the DECODE must be chunk-local."""
    offender = pipe.non_shardable_stage
    if offender is not None:
        stage, reason = offender
        raise ValueError(
            "ownership= needs a decode-shardable pipeline (per-chunk decode "
            "reading only its own payload rows), but stage "
            f"{type(stage).__name__} of {pipe.describe()!r} {reason}. "
            "Run it without ownership instead."
        )


def stream_tiles(n_chunks: int, tile: int = 1, ownership=None) -> list:
    """Chunk-axis tiling for the double-buffered stream: [(lo, hi), ...].

    With an ``ownership`` plan the tiling is OWNER-LOCAL: tiles never span
    an owner boundary, so each tile's decode runs wholly on one owner and
    ``overlap=`` composes with the sharded decode. Owner slices are
    contiguous and ascending, so the tiles still cover [0, n_chunks) in
    order.
    """
    if tile < 1:
        raise ValueError(f"overlap_tile must be >= 1, got {tile}")
    if ownership is None:
        return [(lo, min(lo + tile, n_chunks)) for lo in range(0, n_chunks, tile)]
    tiles = []
    for s in range(ownership.n_shards):
        lo, hi = ownership.slice_for(s)
        tiles.extend((l0, min(l0 + tile, hi)) for l0 in range(lo, hi, tile))
    return tiles


def _chunk_slice(payloads, lo: int, hi: int):
    """Chunks [lo, hi) of a stacked payload (leaves (n, C, ...)); the meta
    rides along unchanged."""
    arrays = {name: v[:, lo:hi] for name, v in arrays_of(payloads).items()}
    meta = meta_of(payloads)
    return arrays if meta is None else Payload(arrays, meta)


def _draws_slice(draws, lo: int, hi: int):
    """Chunks [lo, hi) of stacked draws (leaves (n, 1|C, ...)): a shared
    draw (lead 1) serves every chunk and is kept whole."""
    if draws is None:
        return None
    return {name: v if v.shape[1] == 1 else v[:, lo:hi] for name, v in draws.items()}


def sharded_decode(pipe, key, payloads, n: int, plan, *, client_ids=None, draws=None,
                   bank=None):
    """Owner-partitioned server decode of a stacked payload (leading client
    axis): decode each owner's chunk slice at its global offset and
    concatenate, one owner after another. The JAX package pads the slices
    to one width so that it can vmap over the owners; a loop needs no
    padding, and a fully padded tail owner (an empty slice) is skipped.

    Bit-identical to ``pipe.decode_payload(key, payloads, n)`` for every
    ``decode_shardable`` pipeline: per-chunk decode reads only its own
    payload rows, and position-keyed randomness is re-derived from the
    GLOBAL chunk id via ``chunk_offset``. Sole float-level exception:
    ``rand_proj_spatial(r_mode='est', decode_method='gram')``, whose R-hat
    matmuls associate differently per slice width. ``draws`` (stacked, lead
    1 or C) and ``bank`` are the JAX package's, carried across."""
    check_shardable(pipe)
    outs = [
        pipe.decode_payload(key, _chunk_slice(payloads, lo, hi), n, client_ids=client_ids,
                            chunk_offset=lo, draws=_draws_slice(draws, lo, hi), bank=bank)
        for lo, hi in plan.slices if hi > lo
    ]
    return torch.cat(outs, dim=0)


def _double_buffer(tiles, produce, consume) -> list:
    """The overlap idiom, in one place: ``produce(tile c+1)`` is issued
    BEFORE ``consume`` of tile c, so the next tile's encode is on the stream
    while the previous tile's payload decodes. Returns ``[consume(tile,
    produce(tile)) for tile in tiles]`` evaluated in that staggered order."""
    outs: list = []
    in_flight = None
    for t in tiles:
        entry = produce(t)
        if in_flight is not None:
            outs.append(consume(*in_flight))
        in_flight = (t, entry)
    outs.append(consume(*in_flight))
    return outs


def _self_decode_all(pipe, key, client_ids, n: int, payloads, draws):
    """Each client's self_decode of its row of a stacked payload, one client
    at a time (a generator, so one reconstruction is alive at a time)."""
    ids = range(n) if client_ids is None else [int(i) for i in client_ids]
    meta = meta_of(payloads)
    for i, cid in enumerate(ids):
        yield pipe.self_decode(
            key, cid, Payload({name: v[i] for name, v in payloads.arrays.items()}, meta),
            draws=None if draws is None else {name: v[i] for name, v in draws.items()})


def streamed_mean(pipe, key, x, n, *, client_ids=None, side_info=None, tile: int = 1,
                  need_self: bool = False, ownership=None, draws=None, bank=None):
    """Double-buffered chunk streaming: encode tile c+1 while tile c decodes.

    ``x``: (n, C, d_block) chunks (EF residual already added by the
    caller); ``side_info``: (C, d_block) broadcast side information, whose
    tile slice is subtracted before the encode and added back after the
    decode, exactly as ``Pipeline.encode`` / ``decode`` would.

    ``ownership`` (a ``ChunkOwnership`` plan) makes the tile iteration
    OWNER-LOCAL: tiles never span an owner's slice and each tile decodes at
    its global chunk offset, so the stream is exactly the decode an owner
    shard would run.

    Returns (mean (C, d_block), self_dec (n, C, d_block) | None). For
    chunk-streamable pipelines (validated here) the result is BIT-identical
    to the synchronous encode_all -> decode_payload: tiles only reorder
    work, never the numbers. ``draws`` (stacked) and ``bank`` are the JAX
    package's, carried across."""
    check_streamable(pipe)
    if ownership is not None:
        check_shardable(pipe)

    def produce(t):
        lo, hi = t
        x_tile = x[:, lo:hi]
        if side_info is not None:
            x_tile = x_tile - side_info[None, lo:hi]
        payloads, _ = pipe.encode_all(key, x_tile, client_ids=client_ids,
                                      draws=_draws_slice(draws, lo, hi))
        return payloads

    def consume(t, payloads):
        lo, hi = t
        d_tile = _draws_slice(draws, lo, hi)
        dec = pipe.decode_payload(key, payloads, n, client_ids=client_ids, chunk_offset=lo,
                                  draws=d_tile, bank=bank)
        if side_info is not None:
            dec = dec + side_info[lo:hi]
        self_dec = None
        if need_self:
            self_dec = torch.stack(list(_self_decode_all(pipe, key, client_ids, n, payloads,
                                                         d_tile)))
        return dec, self_dec

    drained = _double_buffer(stream_tiles(x.shape[1], tile, ownership), produce, consume)
    mean = torch.cat([d for d, _ in drained], dim=0)
    self_dec = torch.cat([s for _, s in drained], dim=1) if need_self else None
    return mean, self_dec


def compressed_mean_tree(spec, key, tree, shardings=None, ef_chunks=None, participants=None,
                         overlap=False, overlap_tile=1, ownership=None, *, draws=None,
                         bank=None, device=None):
    """Cross-client compressed mean of a tree, on ``device``.

    tree leaves: (n_clients, ...). Returns (mean_tree, info, ef_next): the
    mean drops the client axis, info is the byte accounting, and ef_next is
    the updated (n_clients, C, d_block) residual, None unless the pipeline
    has an ErrorFeedback stage. ``ef_chunks`` (n_clients, C, d_block) holds
    the residuals going in (zeros when None); it is not changed.

    ``participants``: index array / bool mask of reporting clients; only
    their residual rows move. ``overlap`` / ``overlap_tile``: stream the
    chunk axis (``streamed_mean``). ``ownership``: True / shard count /
    ``ChunkOwnership`` plan, decode owner-partitioned (``sharded_decode``).
    ``draws`` (stacked (n, 1|C, ...), for the participants) and ``bank``
    replace the port's own draws and eigenvalue bank."""
    if shardings is not None:
        raise NotImplementedError("shardings= is not ported yet (ROADMAP A.9 dist/)")
    pipe = as_pipeline(spec)
    dev = resolve_device(device)
    tree = chunking.tree_unflatten(tree, [leaf.to(dev) for leaf in chunking.tree_leaves(tree)])
    chunks, restore, n_total, d_flat = _chunk_clients(tree, pipe.d_block)
    n_chunks = chunks.shape[1]
    plan = ownership_plan(ownership, n_chunks, 1)
    if plan is not None:
        check_shardable(pipe)
    if participants is None:
        ids, x, n = None, chunks, n_total
    else:
        ids = _participant_ids(participants, n_total)
        ids_t = torch.as_tensor(ids, device=dev)
        x, n = chunks[ids_t], len(ids)
    if pipe.has_ef:
        ef_chunks = torch.zeros_like(chunks) if ef_chunks is None else ef_chunks.to(dev)
        x = x + (ef_chunks if ids is None else ef_chunks[ids_t])
    if overlap:
        mean_chunks, self_dec = streamed_mean(pipe, key, x, n, client_ids=ids,
                                              tile=overlap_tile, need_self=pipe.has_ef,
                                              ownership=plan, draws=draws, bank=bank)
        if pipe.has_ef:
            x -= self_dec
    else:
        if draws is None:  # the clients' maps, made once for the encode and the decode
            draws = pipe.sparsifier.round_draws(key, n, n_chunks, client_ids=ids, device=dev)
        # host-time spans on the round-phase tracks (attribution only: the
        # byte annotations stay with the fl driver, which owns the ledger)
        with obs.span("dist", "client_encode", track="client_encode", clients=n):
            payloads, _ = pipe.encode_all(key, x, client_ids=ids, draws=draws)
        with obs.span("dist", "owner_decode", track="owner_decode", clients=n,
                      sharded=plan is not None):
            if plan is not None:
                mean_chunks = sharded_decode(pipe, key, payloads, n, plan, client_ids=ids,
                                             draws=draws, bank=bank)
            else:
                mean_chunks = pipe.decode_payload(key, payloads, n, client_ids=ids,
                                                  draws=draws, bank=bank)
        if pipe.has_ef:
            # x is this call's own tensor: it becomes the residual in place
            for i, rec in enumerate(_self_decode_all(pipe, key, ids, n, payloads, draws)):
                x[i] -= rec
    ef_next = None
    if pipe.has_ef:
        ef_next = x if ids is None else ef_chunks.index_copy(0, ids_t, x)
    n_shards = plan.n_shards if plan is not None else 1
    return restore(mean_chunks), _info(pipe, n, d_flat, n_chunks, n_total=n_total,
                                       n_shards=n_shards, plan=plan), ef_next
