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

The mesh routes run over ``torch.distributed``, one rank a mesh shard:

- ``compressed_mean_tree(shardings=dme_shardings(mesh))``, the GSPMD route:
  every rank holds the whole client tree (the global view a GSPMD program
  sees) and encodes the clients of its share (ceil-split, so any n works);
  payloads are gathered, and every rank decodes the same mean, replicated
  or split by owner (``ownership=``).
- ``compressed_mean_tree_shardmap``, the explicit-collective route: the
  tree holds THIS rank's ``n_local`` clients (rank r holds clients
  ``r*n_local ...``), so n = ``n_local * shards``. Payloads cross the wire
  by an all-gather (payload-sized traffic: the point of the estimator), or,
  with ``ownership=``, each chunk's payloads go only to its owner by an
  all-to-all, the owner decodes its slice at its global chunk offset, and
  one all-gather of the decoded means assembles the mean. EF residual rows
  never leave their rank.

Both give the local route's mean bitwise: the gathered client stack is in
global client order, which is the order the decode adds clients in. A
gloo group's payloads are copied to the host before each call and back
after, counted as ``dist/host_staged_bytes``; an NCCL group passes device
tensors. ``psum_scatter_mean`` is the cross-pod count-weighted mean on a
reduce-scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .. import obs, resolve_device
from ..core import chunking
from ..core.codec import Payload, as_pipeline
from ..core.codec.payload import arrays_of, meta_of
from . import sharding as shard_lib



@dataclasses.dataclass(frozen=True)
class DmeShardings:
    """The GSPMD route's placement: the client axis of the chunk and payload
    stacks lives on the mesh's ``client_axes``."""

    mesh: Any
    client_axes: tuple


def dme_shardings(mesh, client_axes=("pod",)) -> DmeShardings | None:
    if mesh is None:
        return None
    names = shard_lib.mesh_axis_sizes(mesh)
    axes = tuple(a for a in client_axes if a in names)
    if not axes:
        return None
    return DmeShardings(mesh=mesh, client_axes=axes)


def client_shards(mesh, client_axes) -> int:
    """The extent of ``client_axes`` on ``mesh``: its client shards."""
    sizes = shard_lib.mesh_axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in client_axes if a in sizes], dtype=np.int64))



def client_shard(mesh, client_axes=("pod",)) -> tuple:
    """(the client axes' shard count, this rank's shard): the rows of the
    global client axis this rank holds on the shard_map route are
    ``shard * n_local ...``."""
    _, n_shards, shard = _client_group(mesh, client_axes)
    return n_shards, shard


def gather_clients(rows: torch.Tensor, mesh, client_axes=("pod",)) -> torch.Tensor:
    """Every rank's ``rows`` (n_local, ...), stacked in global client order
    (n_local * shards, ...), on every rank of the client axes."""
    group, n_shards, _ = _client_group(mesh, client_axes)
    return _start_gather(group, rows, [rows.shape[0]] * n_shards)()

def _client_group(mesh, client_axes) -> tuple:
    """(process group, shard count, this rank's shard) of the mesh's client
    axes: one axis's group, or the group of several flattened in mesh order
    (shard = the row-major index over them)."""
    sizes = shard_lib.mesh_axis_sizes(mesh)
    axes = [a for a in sizes if a in client_axes]
    if not axes:
        raise ValueError(f"the mesh {tuple(sizes)} has none of the client axes {client_axes}")
    live = [a for a in axes if sizes[a] > 1] or axes[:1]
    group = (mesh.get_group(live[0]) if len(live) == 1
             else mesh[tuple(live)]._flatten().get_group())
    return group, client_shards(mesh, axes), dist.get_rank(group)

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



# ------------------------------------------------------------ the transport

# a gloo group's payloads are staged through the host
_to_wire, _from_wire = shard_lib.to_wire, shard_lib.from_wire


def _start_gather(group, rows: torch.Tensor, counts: list):
    """Start gathering every rank's rows, rank q giving ``counts[q]`` (padded
    to the largest for the call) -> finish(): the (sum(counts), ...) stack in
    rank order, on ``rows``' device."""
    dev, m = rows.device, max(counts)
    if rows.shape[0] < m:
        rows = torch.cat([rows, rows.new_zeros((m - rows.shape[0],) + rows.shape[1:])])
    send = _to_wire(group, rows)
    out = send.new_empty((len(counts) * m,) + tuple(send.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    work = gather(out, send, group=group, async_op=True)

    def finish():
        work.wait()
        got = out if min(counts) == m else torch.cat(
            [out[q * m:q * m + c] for q, c in enumerate(counts)])
        return _from_wire(got, dev)

    return finish


def _start_route(group, packed: torch.Tensor, widths: list, counts: list, shard: int):
    """Start routing chunk columns to their owners: ``packed`` (m, sum(widths),
    B) holds owner q's ``widths[q]`` columns, owner-major -> finish(): this
    owner's columns from every rank, (sum(counts), widths[shard], B) in rank
    order. One all_to_all, its splits uneven where the ranks' rows or the
    owners' widths are."""
    dev, (m, _, b) = packed.device, packed.shape
    bounds = np.cumsum([0] + list(widths))
    send = _to_wire(group, torch.cat(
        [packed[:, lo:hi].reshape(-1) for lo, hi in zip(bounds[:-1], bounds[1:])]))
    mine = widths[shard]
    out_splits = [c * mine * b for c in counts]
    out = send.new_empty(sum(out_splits))
    work = dist.all_to_all_single(out, send, out_splits, [m * w * b for w in widths],
                                  group=group, async_op=True)

    def finish():
        work.wait()
        return _from_wire(out, dev).reshape(sum(counts), mine, b)

    return finish


def _wire_specs(pipe, n_cols: int, lead: int) -> list:
    """[(name, dtype, shape after the first ``lead`` dims)] of a stacked
    payload of ``n_cols`` chunks, from its declared schema (lead 1: a
    client's arrays; lead 2: a chunk's)."""
    return [(a.name, getattr(torch, a.dtype), tuple(a.shape[lead - 1:]))
            for a in pipe.payload_schema(n_cols)]


def _pack(arrays: dict, specs: list, lead: int) -> torch.Tensor:
    """A stacked payload's arrays as one uint8 tensor: each array's bytes
    after its first ``lead`` dims, side by side in schema order."""
    parts = []
    for name, _, rest in specs:
        v = arrays[name].contiguous()
        parts.append(v.reshape(tuple(v.shape[:lead]) + (int(np.prod(rest, dtype=np.int64)),))
                     .view(torch.uint8))
    return torch.cat(parts, dim=-1)


def _unpack(packed: torch.Tensor, specs: list, lead: int) -> dict:
    out, off = {}, 0
    for name, dtype, rest in specs:
        nb = int(np.prod(rest, dtype=np.int64)) * dtype.itemsize
        out[name] = (packed[..., off:off + nb].contiguous().view(dtype)
                     .reshape(tuple(packed.shape[:lead]) + rest))
        off += nb
    return out


def _draws_cols(draws, cols: np.ndarray, lo: int, hi: int):
    """The stacked draws of chunk columns ``cols`` (contiguous [lo, hi) when
    ``cols`` is None); a shared draw (lead 1) is kept whole."""
    if draws is None or cols is None:
        return _draws_slice(draws, lo, hi)
    idx = torch.as_tensor(cols)
    return {name: v if v.shape[1] == 1 else v[:, idx.to(v.device)] for name, v in draws.items()}


def _mesh_mean(pipe, key, x, rows: list, group, shard: int, *, dec_ids=None, route=None,
               plan=None, overlap=False, tile: int = 1, need_self=False, draws=None,
               bank=None):
    """The mesh routes' exchange, run by every rank of ``group`` (this one
    shard ``shard``).

    ``x`` (m, C, d_block): the encode inputs (EF residual added) of this
    rank's clients, ``rows[shard]``; ``rows``: every rank's client ids, so
    the gathered stack is the clients in rank order. ``dec_ids``: the ids
    the decode averages, in the local route's order (None: 0..n-1); the
    stack is put in that order, the order the decode adds clients in.
    ``route`` (a ChunkOwnership over the group's ranks): each chunk's
    payloads go only to its owner, which decodes its slice at its global
    chunk offset; one gather of the decoded means. Otherwise every rank
    gathers every payload and decodes the whole grid, owner-partitioned on
    a logical ``plan`` if given. ``overlap``: stream the chunk axis in tiles
    of ``tile`` (owner-major columns under ``route``), each tile's transfer
    in flight while the next one encodes. ``draws`` (stacked, the decode's
    clients) replace the round's own.

    -> (the mean (C, d_block), the same on every rank; the self-decodes of
    x's rows (m, C, d_block) when ``need_self``, else None)."""
    n_chunks, dev = x.shape[1], x.device
    ids, counts = rows[shard], [len(r) for r in rows]
    stack_ids = np.concatenate(rows)
    order = stack_ids if dec_ids is None else np.asarray(dec_ids)
    n = len(order)
    where = {int(c): i for i, c in enumerate(order)}
    perm = None
    if not np.array_equal(stack_ids, order):
        at = {int(c): i for i, c in enumerate(stack_ids)}
        perm = torch.as_tensor([at[int(c)] for c in order], device=dev)
    if draws is None:  # the clients' maps, made once a round, for every tile
        draws = pipe.sparsifier.round_draws(key, n, n_chunks, client_ids=dec_ids, device=dev)
    my_draws = None if draws is None else {
        name: v[torch.as_tensor([where[int(c)] for c in ids], dtype=torch.long,
                                device=v.device)] for name, v in draws.items()}
    lead = 1 if route is None else 2
    if route is None:
        tiles = stream_tiles(n_chunks, tile, plan) if overlap else [(0, n_chunks)]
    else:
        cpo = route.chunks_per_owner
        tiles = stream_tiles(cpo, tile) if overlap else [(0, cpo)]

    def columns(t):
        """(cols | None for the contiguous [lo, hi), widths by owner | None)."""
        if route is None:
            return None, None
        spans = [(lo + t[0], max(lo + t[0], min(lo + t[1], hi))) for lo, hi in route.slices]
        cols = np.concatenate([np.arange(a, b) for a, b in spans])
        return (None if np.array_equal(cols, np.arange(n_chunks)) else cols,
                [b - a for a, b in spans])

    def produce(t):
        cols, widths = columns(t)
        lo, hi = (t if route is None else (0, n_chunks))
        x_t = x[:, lo:hi] if cols is None else x[:, torch.as_tensor(cols, device=dev)]
        d_t = _draws_cols(my_draws, cols, lo, hi)
        specs = _wire_specs(pipe, x_t.shape[1], lead)
        if len(ids):
            payloads, _ = pipe.encode_all(key, x_t, client_ids=ids, draws=d_t)
            arrays = payloads.arrays
        else:  # a rank whose share is empty still takes part in the calls
            payloads = None
            arrays = {name: torch.empty((0,) + shape, dtype=dtype, device=dev)
                      for name, dtype, shape in _wire_specs(pipe, x_t.shape[1], 1)}
        packed = _pack(arrays, specs, lead)
        finish = (_start_gather(group, packed, counts) if route is None
                  else _start_route(group, packed, widths, counts, shard))
        return payloads, d_t, finish, x_t.shape[1]

    def consume(t, entry):
        payloads, d_t, finish, n_cols = entry
        meta = pipe.payload_meta(n_cols)
        got = _unpack(finish(), _wire_specs(pipe, n_cols, lead), lead)
        if perm is not None:
            got = {name: v[perm] for name, v in got.items()}
        if route is None:
            stack = Payload(got, meta)
            if plan is not None and not overlap:
                mean_t = sharded_decode(pipe, key, stack, n, plan, client_ids=dec_ids,
                                        draws=draws, bank=bank)
            else:
                mean_t = pipe.decode_payload(key, stack, n, client_ids=dec_ids,
                                             chunk_offset=t[0],
                                             draws=_draws_slice(draws, *t), bank=bank)
        else:
            lo = route.slice_for(shard)[0] + t[0]
            width = got[next(iter(got))].shape[1]
            mean_t = x.new_zeros((0, x.shape[2])) if width == 0 else pipe.decode_payload(
                key, Payload(got, meta), n, client_ids=dec_ids, chunk_offset=lo,
                draws=_draws_slice(draws, lo, lo + width), bank=bank)
        self_t = None
        if need_self:
            self_t = (torch.stack(list(_self_decode_all(pipe, key, ids, len(ids), payloads,
                                                        d_t)))
                      if len(ids) else x.new_zeros((0, n_cols, x.shape[2])))
        return mean_t, self_t

    drained = _double_buffer(tiles, produce, consume)
    mean = torch.cat([m for m, _ in drained], dim=0)
    if route is not None:  # the owners' decoded slices (a tail's padded), gathered once
        mean = _start_gather(group, mean, [route.chunks_per_owner] * len(counts))()[:n_chunks]
    self_dec = None
    if need_self:
        self_dec = torch.cat([s for _, s in drained], dim=1)
        cols = [columns(t)[0] for t in tiles]
        if route is not None and any(c is not None for c in cols):
            # the tiles saw owner-major columns: put them back in chunk order
            col_order = np.concatenate([np.arange(n_chunks) if c is None else c for c in cols])
            self_dec = self_dec[:, torch.as_tensor(np.argsort(col_order, kind="stable"),
                                                   device=dev)]
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
    replace the port's own draws and eigenvalue bank.

    ``shardings`` (``dme_shardings(mesh)``): the GSPMD route, run by every
    rank of the mesh's client axes, each holding the whole tree. Rank r
    encodes the r-th ceil-split share of the reporting clients, the payloads
    are gathered, and the decode is replicated, or routed to its owners when
    ``ownership`` makes one owner a rank (else the plan's owners are
    logical, as on the local route). The mean, info and ef_next are the
    local route's, bitwise, on every rank; the residual rows are gathered
    from the ranks that encoded them."""
    pipe = as_pipeline(spec)
    dev = resolve_device(device)
    tree = chunking.tree_unflatten(tree, [leaf.to(dev) for leaf in chunking.tree_leaves(tree)])
    chunks, restore, n_total, d_flat = _chunk_clients(tree, pipe.d_block)
    n_chunks = chunks.shape[1]
    n_mesh = 1 if shardings is None else client_shards(shardings.mesh, shardings.client_axes)
    plan = ownership_plan(ownership, n_chunks, n_mesh)
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
    if draws is None and shardings is None:
        # the clients' maps, made once for the encode, the decode and the
        # self-decode (and for every tile of the stream)
        draws = pipe.sparsifier.round_draws(key, n, n_chunks, client_ids=ids, device=dev)
    if shardings is not None:
        if overlap:
            check_streamable(pipe)
        group, n_shards, shard = _client_group(shardings.mesh, shardings.client_axes)
        share = -(-n // n_shards)
        bounds = [(min(r * share, n), min((r + 1) * share, n)) for r in range(n_shards)]
        stack_ids = np.arange(n_total) if ids is None else ids
        rows = [stack_ids[lo:hi] for lo, hi in bounds]
        lo, hi = bounds[shard]
        routed = plan is not None and plan.n_shards == n_shards
        with obs.span("dist", "payload_route", track="payload_route", backend="gspmd",
                      shards=n_shards):
            mean_chunks, self_dec = _mesh_mean(
                pipe, key, x[lo:hi], rows, group, shard, dec_ids=ids,
                route=plan if routed else None, plan=None if routed else plan,
                overlap=overlap, tile=overlap_tile, need_self=pipe.has_ef, draws=draws,
                bank=bank)
            if pipe.has_ef:  # each rank's residual rows, gathered in share order
                x = _start_gather(group, x[lo:hi] - self_dec, [len(r) for r in rows])()
    elif overlap:
        mean_chunks, self_dec = streamed_mean(pipe, key, x, n, client_ids=ids,
                                              tile=overlap_tile, need_self=pipe.has_ef,
                                              ownership=plan, draws=draws, bank=bank)
        if pipe.has_ef:
            x -= self_dec
    else:
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
    n_shards = plan.n_shards if plan is not None else n_mesh
    return restore(mean_chunks), _info(pipe, n, d_flat, n_chunks, n_total=n_total,
                                       n_shards=n_shards, plan=plan), ef_next


def compressed_mean_tree_shardmap(spec, key, grads, mesh, param_pspecs=None, client_axes=("pod",),
                                  ef_chunks=None, participants=None, overlap=False,
                                  overlap_tile=1, ownership=None, *, bank=None, device=None):
    """The explicit-collective route, run by every rank of the mesh's
    ``client_axes``: ``grads`` leaves (n_local, ...) hold THIS rank's
    clients, global ids ``shard * n_local ...``, so n = n_local * shards.

    Each rank encodes its clients; the payloads are all-gathered (the only
    payload-sized cross-client traffic) and every rank decodes the same
    mean. ``ownership`` (True / ``ChunkOwnership`` with one owner a rank):
    each chunk's payloads go only to its owner (an all_to_all), the owner
    decodes its slice at its global chunk offset, and one all_gather of the
    decoded means assembles the mean. ``overlap``: the chunk axis streams in
    tiles (owner-major columns under ``ownership``), each tile's transfer in
    flight while the next one encodes.

    ``participants``: global ids / mask of the reporting clients; only they
    encode and enter the decode, with their ids, and only their residual
    rows move. Error feedback: ``ef_chunks`` (n_local, C, d_block) are this
    rank's residual rows and ``ef_next`` comes back the same: residual rows
    never leave their rank. ``param_pspecs`` is taken for the JAX
    signature's sake and not read (nor does the JAX body read it): ``grads``
    hold each client's whole gradient, also where the parameters are placed
    over ``data`` / ``model`` (``train.train_step``).

    Returns (mean tree, the same on every rank; info; ef_next | None), the
    mean and residuals bitwise the local route's."""
    pipe = as_pipeline(spec)
    dev = resolve_device(device)
    grads = chunking.tree_unflatten(grads, [leaf.to(dev) for leaf in chunking.tree_leaves(grads)])
    group, n_shards, shard = _client_group(mesh, client_axes)
    chunks, restore, n_local, d_flat = _chunk_clients(grads, pipe.d_block)
    n_chunks, n = chunks.shape[1], n_local * n_shards
    if overlap:
        check_streamable(pipe)
    plan = ownership_plan(ownership, n_chunks, n_shards)
    if plan is not None:
        if plan.n_shards != n_shards:
            raise ValueError(
                f"ownership plan has {plan.n_shards} owners but the mesh client axes "
                f"{tuple(client_axes)} hold {n_shards} shards")
        check_shardable(pipe)
    part_ids = None if participants is None else _participant_ids(participants, n)
    reporting = np.ones(n, bool)
    if part_ids is not None:
        reporting[:] = False
        reporting[part_ids] = True
    rows = [np.flatnonzero(reporting[q * n_local:(q + 1) * n_local]) + q * n_local
            for q in range(n_shards)]
    mine = torch.as_tensor(rows[shard] - shard * n_local, device=dev)
    all_local = len(rows[shard]) == n_local
    x = chunks if all_local else chunks[mine]
    if pipe.has_ef:
        ef_local = torch.zeros_like(chunks) if ef_chunks is None else ef_chunks.to(dev)
        x = x + (ef_local if all_local else ef_local[mine])
    with obs.span("dist", "payload_route", track="payload_route", backend="shard_map",
                  shards=n_shards):
        mean_chunks, self_dec = _mesh_mean(
            pipe, key, x, rows, group, shard, dec_ids=part_ids, route=plan,
            overlap=overlap, tile=overlap_tile, need_self=pipe.has_ef, bank=bank)
    ef_next = None
    if pipe.has_ef:
        # x is this call's own tensor: it becomes the residual in place; the
        # clients that did not report keep theirs
        x -= self_dec
        ef_next = x if all_local else ef_local.index_copy(0, mine, x)
    n_eff = n if part_ids is None else len(part_ids)
    return restore(mean_chunks), _info(pipe, n_eff, d_flat, n_chunks, n_total=n,
                                       n_shards=n_shards, plan=plan), ef_next


def psum_scatter_mean(tiles, counts, mesh, axis: str = "pod"):
    """Count-weighted mean of per-pod tiles on a reduce-scatter: the
    cross-pod combine of the hierarchical decode as a device collective.

    ``tiles`` is (P, C, d_block), row p pod p's decoded estimate, and
    ``counts`` (P,) its contributing client counts (0 marks an absent pod);
    each rank of mesh ``axis`` contributes its own row, ``counts[p] *
    tiles[p]``. A reduce-scatter sums the weighted rows and leaves each rank
    1/P of the chunk axis (padded to a multiple of P), an all_reduce sums
    the counts, and one all_gather of the normalised slices replicates

        sum_p counts[p] * tiles[p] / sum_p counts[p]    (C, d_block)

    on every rank. ``counts`` must sum to > 0. The reduction adds in the
    backend's order, so the result matches the plain weighted mean within
    float rounding, not bitwise."""
    n_shards = shard_lib.mesh_axis_sizes(mesh)[axis]
    tiles = torch.as_tensor(tiles)
    counts = torch.as_tensor(counts, dtype=tiles.dtype, device=tiles.device)
    if tiles.ndim != 3 or tiles.shape[0] != n_shards:
        raise ValueError(f"tiles must be (n_shards={n_shards}, C, d_block), got "
                         f"{tuple(tiles.shape)}")
    if tuple(counts.shape) != (n_shards,):
        raise ValueError(f"counts must be ({n_shards},), got {tuple(counts.shape)}")
    group = mesh.get_group(axis)
    p = dist.get_rank(group)
    n_chunks = tiles.shape[1]
    pad = (-n_chunks) % n_shards
    contrib = counts[p] * tiles[p]
    if pad:
        contrib = torch.cat([contrib, contrib.new_zeros((pad, contrib.shape[1]))])
    send = _to_wire(group, contrib)
    part = send.new_empty((send.shape[0] // n_shards, send.shape[1]))
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(part, send, group=group)
    total = _to_wire(group, counts[p].reshape(1).clone())
    dist.all_reduce(total, group=group)
    full = _start_gather(group, part / total, [part.shape[0]] * n_shards)()
    return _from_wire(full[:n_chunks], tiles.device)
