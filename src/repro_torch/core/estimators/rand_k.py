"""Rand-k sparsification (Konecny & Richtarik 2018), the paper's baseline;
port of repro/core/estimators/rand_k.py.

Each client sends k of its d coordinates, a uniform k-subset re-derived from
the round key (core.random.subset), so only the k values travel. Decode:
x_hat = (1/n)(d/k) sum_i scatter(vals_i). MSE (paper Eq. 1):
(1/n^2)(d/k - 1) sum_i ||x_i||^2.

Every function takes ``draws={"rows": ...}``: stacked (n, 1|C, k) for the
decode, one client's (1|C, k) for the encode and ``self_decode``, so the JAX
package's indices can be carried across (repro_torch.interop). With
``chunk_budgets`` the rows are each draw's full order, width d, and chunk c
takes its first k_c.

The client sum is an in-place scatter-add in client order: each client's
rows are distinct, so every element takes at most one add a client, and the
bits are those of ``kref.client_sum`` over the clients' scatters on every
device.
"""
from __future__ import annotations

import torch

from ... import resolve_device
from ...kernels import ref as kref
from .. import random as prand
from . import base


def _checked_rows(rows: torch.Tensor, lead: tuple, width: int) -> torch.Tensor:
    if tuple(rows.shape) != lead + (width,):
        raise ValueError(f"rows must be {lead + (width,)} (leading n, then 1 with shared "
                         f"randomness or C per chunk), got {tuple(rows.shape)}")
    return rows.long()


def _draw(spec, key, client_id, n_chunks: int, chunk_offset: int, width: int, device):
    """(1|C, width) rows of one client: one draw for every chunk with shared
    randomness, else one a chunk (base.draw_keys)."""
    keys = base.draw_keys(key, client_id, n_chunks, device, spec.shared_randomness,
                          chunk_offset)
    return prand.subset(keys, spec.d_block, width)


def _indices(spec, key, client_id, n_chunks: int, chunk_offset=0, rows=None, device=None):
    """(1|C, k) int64 coordinate choices of one client; ``rows`` replaces the draw."""
    lead = 1 if spec.shared_randomness else n_chunks
    if rows is not None:
        return _checked_rows(rows, (lead,), spec.k)
    return _draw(spec, key, client_id, n_chunks, chunk_offset, spec.k, resolve_device(device))


def rows_of(spec, key, n: int, n_chunks: int, client_ids=None, chunk_offset=0,
            draws=None, device=None) -> torch.Tensor:
    """(n, 1|C, k) rows of every client, drawn one client at a time (the hash
    temporaries stay one client's), or the given ``draws``."""
    lead = (n, 1 if spec.shared_randomness else n_chunks)
    if draws is not None:
        return _checked_rows(draws["rows"], lead, spec.k)
    device = resolve_device(device)
    rows = torch.empty(lead + (spec.k,), dtype=torch.int64, device=device)
    for i, cid in enumerate(_ids(n, client_ids)):
        rows[i] = _draw(spec, key, cid, n_chunks, chunk_offset, spec.k, device)
    return rows


def _budgeted_indices(spec, key, client_id, n_chunks: int, order=None, device=None) -> list:
    """Per-chunk index tensors ``[(k_0,), ..., (k_{C-1},)]`` for adaptive
    ``chunk_budgets``: chunk c takes the first k_c entries of its draw's full
    order (``order`` (1|C, d) replaces it), so the draw at budget k_c is the
    uniform-budget draw truncated or extended."""
    budgets = spec.chunk_budgets
    if len(budgets) != n_chunks:
        raise ValueError(f"chunk_budgets has {len(budgets)} entries but the vector has "
                         f"{n_chunks} chunks")
    lead = 1 if spec.shared_randomness else n_chunks
    if order is None:
        order = _draw(spec, key, client_id, n_chunks, 0, spec.d_block, resolve_device(device))
    order = _checked_rows(order, (lead,), spec.d_block)
    return [order[0 if spec.shared_randomness else ci, :b] for ci, b in enumerate(budgets)]


def _budget_offsets(budgets) -> list:
    offs = [0]
    for b in budgets:
        offs.append(offs[-1] + b)
    return offs


def _budgeted_scatter(spec, key, vals_flat, ids, orders=None) -> torch.Tensor:
    """(n, sum k_c) flat values -> (n, C, d) per-client unbiased estimates,
    each chunk scaled by its OWN d/k_c. ``orders``: (n, 1|C, d) or None."""
    budgets = spec.chunk_budgets
    offs = _budget_offsets(budgets)
    d = spec.d_block
    out = []
    for i, cid in enumerate(ids):
        v = vals_flat[i]
        idxs = _budgeted_indices(spec, key, cid, len(budgets),
                                 None if orders is None else orders[i], v.device)
        out.append(torch.stack([
            (d / b) * kref.srht_scatter_ref(v[offs[ci]:offs[ci + 1]], idxs[ci], d)
            for ci, b in enumerate(budgets)
        ]))
    return torch.stack(out)


def round_draws(spec, key, n: int, n_chunks: int, client_ids=None, device=None):
    """{"rows": (n, 1|C, k)} of every client, for the encode and the decode
    of one round; None with ``chunk_budgets`` (those draw where they use)."""
    if spec.chunk_budgets is not None:
        return None
    return {"rows": rows_of(spec, key, n, n_chunks, client_ids, device=device)}


def _ids(n: int, client_ids) -> list:
    return list(range(n)) if client_ids is None else [int(i) for i in client_ids]


def encode(spec, key, client_id, x_cd: torch.Tensor, draws: dict | None = None) -> dict:
    """One client's (C, d) chunks -> {"vals": (C, k)}, or (sum k_c,) with
    ``chunk_budgets``. ``draws``: this client's {"rows": (1|C, k or d)}."""
    c = x_cd.shape[0]
    rows = None if draws is None else draws["rows"]
    if spec.chunk_budgets is not None:
        idxs = _budgeted_indices(spec, key, client_id, c, rows, x_cd.device)
        return {"vals": torch.cat([x_cd[ci, idxs[ci]] for ci in range(c)])}
    idx = _indices(spec, key, client_id, c, rows=rows, device=x_cd.device)
    if spec.shared_randomness:
        return {"vals": x_cd[:, idx[0]]}
    return {"vals": torch.gather(x_cd, -1, idx)}


def scatter_sum(vals: torch.Tensor, rows: torch.Tensor, d: int) -> torch.Tensor:
    """sum_i scatter(vals_i) in client order: vals (n, C, k), rows (n, 1|C, k)
    distinct within a row. -> (C, d)"""
    n, c, k = vals.shape
    s = torch.zeros((c, d), dtype=vals.dtype, device=vals.device)
    for i in range(n):
        s.scatter_add_(-1, rows[i].expand(c, k), vals[i])
    return s


def hit_counts(rows: torch.Tensor, c: int, d: int) -> torch.Tensor:
    """M_j, the number of clients whose rows hold coordinate j: (C, d) float32."""
    n, _, k = rows.shape
    return scatter_sum(torch.ones((), device=rows.device).expand(n, c, k), rows, d)


def scatter_sum_and_counts(spec, key, vals, n, client_ids=None, chunk_offset=0, draws=None):
    """Rand-k / Rand-k-Spatial decode plumbing: vals (n, C, k) -> (sum (C, d),
    counts (C, d)). ``client_ids`` overrides the 0..n-1 ids (partial
    participation); ``chunk_offset`` is the global position of vals' first
    chunk."""
    c = vals.shape[1]
    rows = rows_of(spec, key, n, c, client_ids, chunk_offset, draws, vals.device)
    return scatter_sum(vals, rows, spec.d_block), hit_counts(rows, c, spec.d_block)


def decode(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None):
    vals = payloads["vals"]
    if spec.chunk_budgets is not None:
        if chunk_offset:
            raise ValueError("adaptive chunk_budgets decode is not shardable "
                             "(chunk_offset must be 0)")
        orders = None if draws is None else draws["rows"]
        return kref.client_sum(_budgeted_scatter(spec, key, vals, _ids(n, client_ids),
                                                 orders)) / n
    rows = rows_of(spec, key, n, vals.shape[1], client_ids, chunk_offset, draws, vals.device)
    return (spec.d_block / (spec.k * n)) * scatter_sum(vals, rows, spec.d_block)


def self_decode(spec, key, client_id, payload, draws=None):
    """Unbiased per-client reconstruction (d/k) scatter(vals): what the server
    attributes to this client. ``draws``: this client's {"rows": ...}."""
    vals = payload["vals"]
    rows = None if draws is None else draws["rows"]
    if spec.chunk_budgets is not None:
        orders = None if rows is None else rows[None]
        return _budgeted_scatter(spec, key, vals[None], [client_id], orders)[0]
    idx = _indices(spec, key, client_id, vals.shape[0], rows=rows, device=vals.device)
    return (spec.d_block / spec.k) * kref.srht_scatter_ref(vals, idx, spec.d_block)


CODEC = base.Codec(encode=encode, decode=decode, self_decode=self_decode, draws=round_draws)
base.register("rand_k", CODEC)
