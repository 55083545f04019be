"""Serving steps (port of repro/train/serve_step.py): prefill (fills the
cache) and single-token greedy decode. Serving carries no compressed mean.

With ``mesh=`` whose ``data`` or ``model`` axis is larger than 1 the steps
run placed (ROADMAP A.9.2): ``params`` are this rank's shards under
``param_shardings`` (default ``dist.sharding.param_shardings(cfg,
mesh)``), the tokens and the cache this rank's rows of the batch (split
over the DP axes) and the cache's shards (``cache_shardings``: kv heads,
conv channels and SSM heads over ``model``). Each call gathers the FSDP
shards over ``data`` and runs the model under a ``dist.sharding.Placement``
(every layer kind on its ``model`` shard; the flash kernel on the rank's
own heads at prefill); the logits come back whole over the vocab, for this
rank's rows.
"""
from __future__ import annotations

import contextlib

import torch

from ..core import chunking
from ..dist import sharding as shard_lib
from ..models import act_sharding, transformer


def placed_call(cfg, mesh=None, param_shardings=None):
    """-> run(params): a context manager giving the parameters the model
    reads (this rank's ``model`` shards, whole over ``data``) with the
    placement installed; the parameters themselves without a placed mesh."""
    sizes = {} if mesh is None else shard_lib.mesh_axis_sizes(mesh)
    if sizes.get("data", 1) == 1 and sizes.get("model", 1) == 1:
        return contextlib.nullcontext
    specs = [s.spec for s in chunking.tree_leaves(
        param_shardings or shard_lib.param_shardings(cfg, mesh))]
    pl = shard_lib.Placement(mesh)
    dp = pl.batch_axes
    layout = shard_lib.NamedSharding(mesh, (dp[0] if len(dp) == 1 else dp, None, None))

    @contextlib.contextmanager
    def run(params):
        work = pl.full_many(chunking.tree_leaves(params), specs, "data")
        with shard_lib.placing(pl), act_sharding.constraint(layout):
            yield chunking.tree_unflatten(params, work)

    return run


def make_decode_step(cfg, mesh=None, param_shardings=None):
    run = placed_call(cfg, mesh, param_shardings)

    def decode_step(params, cache, tokens, positions):
        with run(params) as p:
            logits, cache = transformer.decode_step(p, cfg, cache, tokens, positions)
        next_token = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)
        return next_token, logits, cache

    return decode_step


def make_prefill_step(cfg, mesh=None, param_shardings=None):
    run = placed_call(cfg, mesh, param_shardings)

    def prefill(params, cache, tokens):
        with run(params) as p:
            return transformer.prefill(p, cfg, cache, tokens)

    return prefill
