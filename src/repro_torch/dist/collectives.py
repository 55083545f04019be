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

The GSPMD ``shardings``, the overlapped stream and the ownership-sharded
decode are still to port and raise NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import chunking
from ..core.codec import Payload, as_pipeline


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


def _info(pipe, n: int, d_flat: int, n_chunks: int, n_total: int | None = None) -> dict:
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
        # one shard: nothing crosses a shard boundary on the local route
        "n_shards": 1,
        "intra_pod_bytes_allgather": 0,
        "intra_pod_bytes_ownership": 0,
        "intra_pod_bytes": 0,
    }


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
    their residual rows move. ``draws`` (stacked (n, 1|C, ...), for the
    participants) and ``bank`` replace the port's own draws and eigenvalue
    bank."""
    if shardings is not None:
        raise NotImplementedError("shardings= is not ported yet (ROADMAP A.9 dist/)")
    if overlap:
        raise NotImplementedError("overlap=True is not ported yet (ROADMAP A.7/A.9)")
    if ownership:
        raise NotImplementedError("ownership= is not ported yet (ROADMAP A.7/A.9)")
    del overlap_tile
    pipe = as_pipeline(spec)
    dev = resolve_device(device)
    tree = chunking.tree_unflatten(tree, [leaf.to(dev) for leaf in chunking.tree_leaves(tree)])
    chunks, restore, n_total, d_flat = _chunk_clients(tree, pipe.d_block)
    n_chunks = chunks.shape[1]
    if participants is None:
        ids, x, n = None, chunks, n_total
    else:
        ids = _participant_ids(participants, n_total)
        ids_t = torch.as_tensor(ids, device=dev)
        x, n = chunks[ids_t], len(ids)
    if pipe.has_ef:
        ef_chunks = torch.zeros_like(chunks) if ef_chunks is None else ef_chunks.to(dev)
        x = x + (ef_chunks if ids is None else ef_chunks[ids_t])
    payloads, _ = pipe.encode_all(key, x, client_ids=ids, draws=draws)
    mean_chunks = pipe.decode_payload(key, payloads, n, client_ids=ids, draws=draws, bank=bank)
    ef_next = None
    if pipe.has_ef:
        # x is this call's own tensor: it becomes the residual in place
        for i, cid in enumerate(range(n) if ids is None else ids.tolist()):
            x[i] -= pipe.self_decode(
                key, cid, Payload({name: v[i] for name, v in payloads.arrays.items()},
                                  payloads.meta),
                draws=None if draws is None else {name: v[i] for name, v in draws.items()})
        ef_next = x if ids is None else ef_chunks.index_copy(0, ids_t, x)
    return restore(mean_chunks), _info(pipe, n, d_flat, n_chunks, n_total=n_total), ef_next
