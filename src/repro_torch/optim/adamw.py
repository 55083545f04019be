"""Optimizers over trees of tensors (port of repro/optim/adamw.py).

States are trees mirroring the parameters (dicts, lists, tuples of
tensors) plus an int32 ``step`` tensor. ``update`` is functional, as in the
JAX package: it returns new parameter and state trees and changes no tensor
it is given, so a snapshot of the old state (a checkpoint, a comparison
from the same state) stays valid. Leaves are visited in ``ravel_pytree``
order (``core.chunking.tree_leaves``), so the global norm sums them in the
JAX package's order.

Placed trees (``shardings=``, a ``dist.sharding.NamedSharding`` tree like
the parameters): every leaf is this rank's shard, the update is
elementwise on the shards, and the global norm is the whole tree's: each
leaf's squares are summed on its shard, counted by one replica of each
shard, and summed over the mesh before the leaves are added in order.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import chunking


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure; a tree like the first."""
    columns = zip(*(chunking.tree_leaves(t) for t in trees))
    return chunking.tree_unflatten(trees[0], [fn(*leaves) for leaves in columns])


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares, leaf by leaf in order;
    of the whole tree whose shards ``tree`` holds under ``shardings``."""
    leaves = chunking.tree_leaves(tree)
    sums = [torch.sum(x.float() ** 2) for x in leaves]
    if shardings is not None:
        from ..dist import sharding as shard_lib

        specs = [s.spec for s in chunking.tree_leaves(shardings)]
        pl = shard_lib.Placement(chunking.tree_leaves(shardings)[0].mesh)
        mine = torch.stack([v if pl.is_leader(spec) else torch.zeros_like(v)
                            for v, spec in zip(sums, specs)])
        sums = list(pl.all_reduce(mine, tuple(pl.sizes)).unbind(0))
    total = 0
    for v in sums:
        total = total + v
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float, shardings=None):
    """-> (tree scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(tree, shardings)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _map(lambda g: g * scale.to(g.dtype), tree), norm


def _zeros_like(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _step0(params) -> torch.Tensor:
    leaves = chunking.tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def init(self, params) -> dict:
        return {"mu": _zeros_like(params), "nu": _zeros_like(params), "step": _step0(params)}

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup to ``lr``: float32 ``lr * min(1, (step + 1) / warmup)``."""
        warm = torch.clamp((step + 1) / max(self.warmup_steps, 1), max=1.0)
        return self.lr * warm

    def update(self, grads, state: dict, params, shardings=None):
        """-> (new params, new state, {"grad_norm", "lr"}); ``shardings``:
        the trees hold this rank's shards (module docstring)."""
        step = state["step"] + 1
        if self.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, self.grad_clip, shardings)
        else:
            gnorm = global_norm(grads, shardings)
        b1, b2 = self.b1, self.b2
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["mu"], grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state["nu"], grads)
        lr = self.schedule(step)
        # the bias corrections in float32, as the JAX package computes them
        stepf = step.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

        def upd(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new_params = _map(upd, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "step": step}, {"grad_norm": gnorm, "lr": lr}


@dataclasses.dataclass(frozen=True)
class SGDM:
    lr: float = 0.1
    momentum: float = 0.0

    def init(self, params) -> dict:
        if self.momentum == 0.0:
            return {"step": _step0(params)}
        return {"m": _zeros_like(params), "step": _step0(params)}

    def update(self, grads, state: dict, params, shardings=None):
        step = state["step"] + 1
        gnorm = global_norm(grads, shardings)
        if self.momentum == 0.0:
            new_params = _map(lambda p, g: (p.float() - self.lr * g.float()).to(p.dtype),
                              params, grads)
            return new_params, {"step": step}, {"grad_norm": gnorm, "lr": self.lr}
        m = _map(lambda mm, g: self.momentum * mm + g.float(), state["m"], grads)
        new_params = _map(lambda p, mm: (p.float() - self.lr * mm).to(p.dtype), params, m)
        return new_params, {"m": m, "step": step}, {"grad_norm": gnorm, "lr": self.lr}
