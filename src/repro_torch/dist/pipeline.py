"""Layer-pipelined application over a mesh axis, the GPipe schedule (port of
repro/dist/pipeline.py).

``partition_blocks`` regroups a stacked-blocks parameter tree (n_blocks, ...)
into (n_stages, blocks_per_stage, ...); ``pipeline_apply`` runs the staged
blocks over microbatches on the ranks of the mesh's ``pipe`` axis: rank s
applies stage s's blocks, activations hop from stage s to s+1, and the last
stage's outputs go to every rank. The result is the serial composition's:
the bubble wastes compute and reorders no arithmetic.

Autograd runs through the schedule, and every rank's backward makes the same
collective calls in the same order:

- a hop is ``_Hop``: its forward sends to s+1 and receives from s-1, its
  backward sends the cotangent to s-1 and receives s+1's, both directions
  posted together (``dist.batch_isend_irecv``), so neither gloo nor NCCL
  waits on a cycle. Every rank runs every step of the schedule (stage 0
  selects its microbatch over the hop's output with ``torch.where``), so
  each hop's output reaches the loss on every rank and the hops' backwards
  form one chain, pair for pair across the ranks;
- the output is the last stage's, broadcast (``_FromLast``). Every rank
  computes the same loss from it, so the backward hands the last stage its
  own cotangent and the other stages zeros: the output's gradient is counted
  once, not once a rank;
- the input is every rank's (``_FromFirst``): its gradient is stage 0's,
  broadcast, so what runs before the pipeline (an embedding, a prologue)
  gets the serial gradient on every rank.

Each rank's gradient of ``staged`` is its own stage's and zero elsewhere; a
sum over the ``pipe`` group (``reduce_stage_grads``) adds zeros to it, so
it is exact. Tensors cross the wire as bytes; a gloo group has no device
path, so a card tensor is staged through the host and counted as
``dist/host_staged_bytes``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import chunking
from . import collectives
from . import sharding as shard_lib


def _tree_map(fn, tree):
    return chunking.tree_unflatten(tree, [fn(leaf) for leaf in chunking.tree_leaves(tree)])


def partition_blocks(tree, n_stages: int):
    """(n_blocks, ...) stacked params -> (n_stages, n_blocks//n_stages, ...)
    (views)."""

    def one(leaf):
        nb = leaf.shape[0]
        if nb % n_stages:
            raise ValueError(f"n_blocks={nb} not divisible by n_stages={n_stages}")
        return leaf.reshape((n_stages, nb // n_stages) + tuple(leaf.shape[1:]))

    return _tree_map(one, tree)


class _Axis:
    """The ``pipe`` axis of a mesh as this rank sees it."""

    def __init__(self, mesh, axis: str):
        self.n = shard_lib.mesh_axis_sizes(mesh)[axis]
        self.group = mesh.get_group(axis)
        self.stage = dist.get_rank(self.group)

    def global_rank(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)


def _to_bytes(ax: _Axis, t: torch.Tensor) -> torch.Tensor:
    return collectives._to_wire(ax.group, t).contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return collectives._from_wire(buf.view(like.dtype).reshape(like.shape), like.device)


def _wire_device(ax: _Axis, t: torch.Tensor) -> torch.device:
    return torch.device("cpu") if dist.get_backend(ax.group) == "gloo" else t.device


def _shift(ax: _Axis, t: torch.Tensor, step: int) -> torch.Tensor:
    """Send ``t`` to stage + step and receive from stage - step; a stage with
    no sender gets zeros."""
    dst, src = ax.stage + step, ax.stage - step
    ops, buf = [], None
    if 0 <= dst < ax.n:
        ops.append(dist.P2POp(dist.isend, _to_bytes(ax, t), ax.global_rank(dst), ax.group))
    if 0 <= src < ax.n:
        buf = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                          device=_wire_device(ax, t))
        ops.append(dist.P2POp(dist.irecv, buf, ax.global_rank(src), ax.group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return torch.zeros_like(t) if buf is None else _from_bytes(buf, t)


def _broadcast(ax: _Axis, t: torch.Tensor, src: int) -> torch.Tensor:
    """Stage ``src``'s ``t`` on every stage (a new tensor)."""
    buf = (_to_bytes(ax, t).clone() if ax.stage == src else
           torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                       device=_wire_device(ax, t)))
    dist.broadcast(buf, src=ax.global_rank(src), group=ax.group)
    return _from_bytes(buf, t)


class _Hop(torch.autograd.Function):
    """Activations one stage on: forward s -> s+1, backward s+1 -> s."""

    @staticmethod
    def forward(ctx, h, ax):
        ctx.ax = ax
        return _shift(ax, h.detach(), +1)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.ax, g.contiguous(), -1), None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every stage; the cotangent of the replicated
    loss goes back to the last stage once."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return _broadcast(ax, t.detach(), ax.n - 1)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.ax.stage == ctx.ax.n - 1 else torch.zeros_like(g)), None


class _FromFirst(torch.autograd.Function):
    """Every stage's copy of the input; its gradient is stage 0's on every
    stage."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return t.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return _broadcast(ctx.ax, g.contiguous(), 0), None


def pipeline_apply(stage_fn, staged, x, mesh, axis: str = "pipe"):
    """Apply staged blocks to microbatches x: (m, microbatch, ...).

    stage_fn(stage_params, h) applies one stage's blocks to activations h of
    shape x.shape[1:]. staged leaves: (n_stages, ...); this rank uses only
    its own stage's slice. Returns (m, microbatch, ...), the serial
    composition of all stages, on every rank of the axis.
    """
    ax = _Axis(mesh, axis)
    m = x.shape[0]
    params = _tree_map(lambda leaf: leaf[ax.stage], staged)
    first = torch.tensor(ax.stage == 0, device=x.device)
    xs = _FromFirst.apply(x, ax).unbind(0)
    state = torch.zeros_like(xs[0])
    outs = [None] * m
    n_steps = m + ax.n - 1  # pipeline depth: fill + drain bubble
    for t in range(n_steps):
        # stage 0 takes microbatch t; later stages take the hop
        h = stage_fn(params, torch.where(first, xs[min(t, m - 1)], state))
        if t >= ax.n - 1:  # the last stage retires microbatch t - (n_stages - 1)
            outs[t - (ax.n - 1)] = h
        if t < n_steps - 1:
            state = _Hop.apply(h, ax)
    return _FromLast.apply(torch.stack(outs), ax)


def reduce_stage_grads(grads: list, mesh, axis: str = "pipe") -> list:
    """Sum the stage-sliced gradients ``grads`` over the ``axis`` group (one
    call): each is its stage's on one rank and zero on the others, so the
    sum is exact, and every rank ends with every stage's."""
    ax = _Axis(mesh, axis)
    if not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    wire = collectives._to_wire(ax.group, flat)
    dist.all_reduce(wire, group=ax.group)
    flat = collectives._from_wire(wire, flat.device)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape))
        at += g.numel()
    return out
