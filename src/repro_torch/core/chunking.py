"""Blockwise application of the estimators to framework-scale vectors (port
of repro/core/chunking.py).

A tree of tensors (nested dicts, lists and tuples) is flattened, zero-padded
to a multiple of ``d_block`` and cut into (C, d_block) chunks. The flatten
order is JAX's ``ravel_pytree`` order: dict entries in SORTED key order
(``torch.utils._pytree`` would use insertion order), lists and tuples in
order. That order decides which coordinates share a chunk, so the port's
compressed mean of a multi-leaf tree equals the JAX package's only with it.
"""
from __future__ import annotations

import torch


def num_chunks(d_flat: int, d_block: int) -> int:
    return -(-d_flat // d_block)


def chunk(x: torch.Tensor, d_block: int) -> torch.Tensor:
    """(d_flat,) -> (C, d_block), zero-padding the tail."""
    (d_flat,) = x.shape
    pad = num_chunks(d_flat, d_block) * d_block - d_flat
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(-1, d_block)


def unchunk(xc: torch.Tensor, d_flat: int) -> torch.Tensor:
    """(C, d_block) -> (d_flat,), dropping the pad."""
    return xc.reshape(-1)[:d_flat]


def tree_leaves(tree) -> list:
    """Leaves in ravel_pytree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(tree, leaves: list):
    """A tree shaped like ``tree`` whose leaves, in ``tree_leaves`` order,
    are ``leaves``; dicts keep their own key order."""
    return _build(tree, iter(leaves))


def _build(node, it):
    # a module function, not a closure that calls itself: such a closure is
    # a reference cycle, and it kept ``leaves`` (a step's gradients: GBs on
    # the card) alive until the cyclic collector ran
    if isinstance(node, dict):
        new = {k: _build(node[k], it) for k in sorted(node)}
        return {k: new[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(sub, it) for sub in node)
    if node is None:
        return None
    return next(it)


def flat_dtype(leaves: list) -> torch.dtype:
    """The one dtype ravel_pytree promotes the leaves to."""
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    return dtype


def unraveler(tree, lead: int = 0):
    """-> unravel(flat) rebuilding ``tree`` from a flat vector, each leaf
    cast back to its dtype; ``lead`` leading (client) axes of every leaf
    are not part of the flat vector."""
    specs = [(leaf.shape[lead:], leaf.dtype) for leaf in tree_leaves(tree)]

    def unravel(flat_hat: torch.Tensor):
        out, off = [], 0
        for shape, dt in specs:
            size = shape.numel()
            out.append(flat_hat[off:off + size].reshape(shape).to(dt))
            off += size
        return tree_unflatten(tree, out)

    return unravel


def flatten_tree(tree):
    """tree -> (flat (d,), unravel_fn), leaves promoted to one dtype as
    ravel_pytree does."""
    leaves = tree_leaves(tree)
    dtype = flat_dtype(leaves)
    return torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves]), unraveler(tree)


def tree_chunk(tree, d_block: int):
    """tree -> ((C, d_block) chunks, restore_fn)."""
    flat, unravel = flatten_tree(tree)
    d_flat = flat.shape[0]

    def restore(xc_hat: torch.Tensor):
        return unravel(unchunk(xc_hat, d_flat))

    return chunk(flat, d_block), restore
