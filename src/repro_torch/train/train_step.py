"""Training step factory (port of repro/train/train_step.py): loss ->
per-client grads -> (compressed) mean -> optimizer.

Two modes:
  - dme_spec=None: the plain step, one gradient of the whole batch and the
    optimizer (the uncompressed baseline).
  - dme_spec=<codec Pipeline | sparsifier config>: the batch carries a
    leading client axis. Each client's gradient is taken by its own
    backward (the JAX package vmaps the clients) and copied into stacked
    (n, ...) leaves; the cross-client mean is the paper's estimator via
    ``dist.collectives.compressed_mean_tree`` on the local route, keyed by
    ``fold_in(key(seed), step)`` of ``core.random``, the JAX package's key.

Error feedback (an ErrorFeedback stage in the pipeline, Top-k-style biased
codecs): a per-client residual buffer lives in train_state["ef"], added to
the gradient before encoding and rebuilt from the pipeline's self-decode
after.

With ``mesh=`` (a ``DeviceMesh``) the exchange runs over the ranks of its
client axes: ``dme_impl="shard_map"`` gives each rank its own clients (rank
r takes the batch's clients ``r*n_local ...``; their losses and metrics are
gathered, so every rank reports the all-client means), ``"gspmd"`` has
every rank compute every client's gradient and encode its share, and
``"auto"`` takes shard_map when the clients divide over the client axes,
else gspmd. Without ``data`` / ``model`` axes larger than 1 every rank
holds the whole parameters and the update is bitwise the mesh-less step's.

Placed parameters (ROADMAP A.9.2): with a ``data`` or ``model`` axis
larger than 1, ``params`` and the optimizer state hold this rank's shards
under ``param_shardings`` (default ``dist.sharding.param_shardings(cfg,
mesh)``; ``init_params(..., shardings=)`` or ``shard_tree`` makes them)
and the batch is the whole batch, the same on every rank. A rank takes
its ``data`` rows of each client (the plain step: its rows over the DP
axes), gathers the FSDP shards over ``data`` (the parameters are then
split over ``model`` alone) and runs the loss and its backward under a
``dist.sharding.Placement``: every layer kind computes on its ``model``
shard, the loss divides by the whole batch's label count and the MoE
routing keeps the whole batch's capacity, drops and aux loss. Each
client's gradient is then made whole on every rank (summed over ``data``,
gathered over ``model``), as the JAX package's shard_map replicates it;
the compressed mean runs over the client axes as above, and each rank
updates its own shards (AdamW's global norm is the whole tree's). The
update is the mesh-less step's within float rounding (the row-parallel and
over-``data`` sums add in another order).

``pipeline_stages=N`` runs the block stack layer-pipelined over the mesh's
``pipe`` axis (GPipe, ``dist.pipeline``) inside the loss
(``_pipelined_loss``): each rank applies its stage's blocks, the
embedding, prologue, epilogue and head run on every rank, and after each
backward the block gradients are summed over the ``pipe`` group (each is
its stage's on one rank and zero on the others). Every rank then holds the
whole gradient and applies the same update. With a codec each client's
loss is pipelined, then the clients' gradients are exchanged. The schedule
over placed parameters is not ported yet (it raises; ROADMAP A.9.4).

A step is functional: it returns new parameter and state trees and changes
none it is given.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint

from .. import resolve_device
from ..core import chunking
from ..core import random as prand
from ..core.codec import as_pipeline
from ..dist import collectives
from ..dist import pipeline as pipe_lib
from ..dist import sharding as shard_lib
from ..models import act_sharding, transformer


def _pipelined_loss(params, cfg, batch, *, mesh, axis, n_stages, n_micro):
    """``transformer.loss_fn`` with the block stack run through
    ``dist.pipeline.pipeline_apply`` (GPipe over the ``axis`` mesh axis).

    The embedding, prologue, epilogue, logits and cross entropy are
    ``loss_fn``'s own; only the repeated block stack is staged, each block
    recomputed in the backward under ``remat == "block"``. The batch is
    split into ``n_micro`` microbatches along its leading dim, which must
    divide evenly. ``make_train_step`` refuses MoE block patterns: a stage
    carries activations only, so the blocks' router aux loss would be
    dropped (a prologue or epilogue MoE layer keeps its aux)."""
    inputs = batch["inputs"]
    b = inputs.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    positions = transformer._positions(inputs)
    x = transformer.embed_inputs(params, cfg, inputs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(cfg.prologue):
        x, aux = transformer._run_layer(cfg, spec, params["prologue"][i], x, aux, positions,
                                        None, "auto")
    if cfg.n_blocks > 0:
        per_stage = cfg.n_blocks // n_stages
        remat = cfg.remat == "block" and torch.is_grad_enabled()

        def stage_fn(stage_params, h):
            pos = transformer._positions(h)
            zero = torch.zeros((), dtype=torch.float32, device=h.device)
            for p_block in transformer._unstack(stage_params, per_stage):
                if remat:
                    h, _ = torch.utils.checkpoint.checkpoint(
                        transformer._run_block, cfg, p_block, h, zero, pos, None, "auto",
                        use_reentrant=False)
                else:
                    h, _ = transformer._run_block(cfg, p_block, h, zero, pos, None, "auto")
            return h

        staged = pipe_lib.partition_blocks(params["blocks"], n_stages)
        # the stages manage their own placement, as in the JAX package
        with act_sharding.constraint(None):
            xm = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
            x = pipe_lib.pipeline_apply(stage_fn, staged, xm, mesh, axis).reshape(x.shape)
    for i, spec in enumerate(cfg.epilogue):
        x, aux = transformer._run_layer(cfg, spec, params["epilogue"][i], x, aux, positions,
                                        None, "auto")
    logits = transformer.logits_fn(params, cfg, x)
    return transformer.cross_entropy_loss(cfg, logits, batch["labels"], aux)


def _value_and_grad(params, cfg, batch, loss_fn=transformer.loss_fn, pipeline=None):
    """-> (loss, metrics, grads): ``loss_fn`` and its gradient with respect
    to every leaf of ``params`` (zeros for a leaf the loss does not read, as
    ``jax.grad`` gives). ``pipeline`` (mesh, axis): the block leaves'
    gradients are summed over the ``axis`` group, every stage's on every
    rank."""
    leaves = chunking.tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = loss_fn(chunking.tree_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    if pipeline is not None:
        blocks = {id(p) for p in chunking.tree_leaves(params["blocks"])}
        at = [i for i, p in enumerate(leaves) if id(p) in blocks]
        for i, g in zip(at, pipe_lib.reduce_stage_grads([grads[i] for i in at], *pipeline)):
            grads[i] = g
    metrics = {k: v.detach() for k, v in metrics.items()}
    loss = metrics.pop("loss", loss)  # a placed loss reports the whole batch's
    return loss.detach(), metrics, chunking.tree_unflatten(params, grads)


class _Placed:
    """The placed step's view of the mesh (module docstring): the
    parameters' specs, the axes a batch's rows split over, and the
    gradient's way from the shards to the whole tree and back."""

    def __init__(self, mesh, shardings, row_axes):
        self.shardings = shardings
        self.specs = [s.spec for s in chunking.tree_leaves(shardings)]
        self.pl = shard_lib.Placement(mesh, batch_axes=row_axes)
        entry = row_axes[0] if len(row_axes) == 1 else (tuple(row_axes) or None)
        self.layout = shard_lib.NamedSharding(mesh, (entry, None, None))
        self._work = None

    def rows(self, batch: dict) -> dict:
        """This rank's rows of each of ``batch``'s tensors."""
        n, k = next(iter(batch.values())).shape[0], self.pl.size(self.pl.batch_axes)
        if n % k:
            raise ValueError(f"{n} rows do not split over the batch axes "
                             f"{self.pl.batch_axes} ({k} ranks)")
        i = self.pl.index(self.pl.batch_axes)
        return {name: t[i * (n // k):(i + 1) * (n // k)] for name, t in batch.items()}

    def gathered(self, params) -> list:
        """The parameters' FSDP shards gathered over ``data`` (their
        ``model`` shards), once for all of a step's clients."""
        if self._work is None or self._work[0] is not params:
            self._work = (params, self.pl.full_many(chunking.tree_leaves(params), self.specs,
                                                    "data"))
        return self._work[1]

    def release(self) -> None:
        """Drop the gathered parameters: at rest a rank holds its shards."""
        self._work = None

    def value_and_grad(self, params, cfg, batch):
        """-> (loss, metrics, grads): the whole batch's loss and metrics,
        and the gradient as whole tensors, from this rank's shards."""
        work = self.gathered(params)
        with shard_lib.placing(self.pl), act_sharding.constraint(self.layout):
            loss, metrics, grads = _value_and_grad(chunking.tree_unflatten(params, work), cfg,
                                                   self.rows(batch))
        g = self.pl.all_reduce_many(chunking.tree_leaves(grads), self.pl.batch_axes)
        g = self.pl.full_many(g, self.specs, "model")
        return loss, metrics, chunking.tree_unflatten(params, g)

    def local(self, grads):
        """The whole gradient tree cut to this rank's shards."""
        return chunking.tree_unflatten(grads, [self.pl.local(g, spec) for g, spec in
                                               zip(chunking.tree_leaves(grads), self.specs)])


def init_train_state(cfg, optimizer, params, dme_spec=None, n_clients: int = 0,
                     shardings=None) -> dict:
    """{"opt": optimizer state[, "ef": (n_clients, C, d_block) float32
    zeros when the pipeline has error feedback]}, on the parameters' device.
    ``shardings``: ``params`` are this rank's shards (the moments are too;
    the residuals cover the whole gradient)."""
    state = {"opt": optimizer.init(params)}
    if dme_spec is not None:
        pipe = as_pipeline(dme_spec)
        if pipe.has_ef:
            leaves = chunking.tree_leaves(params)
            sizes = [p.numel() for p in leaves] if shardings is None else [
                math.prod(shard_lib.whole_shape(p.shape, s.spec, s.mesh))
                for p, s in zip(leaves, chunking.tree_leaves(shardings))]
            c = chunking.num_chunks(sum(sizes), pipe.d_block)
            state["ef"] = torch.zeros((n_clients, c, pipe.d_block), dtype=torch.float32,
                                      device=leaves[0].device)
    return state


def make_train_step(cfg, optimizer, *, dme_spec=None, mesh=None, client_axes=("pod",),
                    seed: int = 0, dme_impl: str = "auto", dme_overlap: bool = False,
                    dme_overlap_tile: int = 1, dme_ownership=False, pipeline_stages: int = 0,
                    pipeline_axis: str = "pipe", pipeline_microbatches: int = 0,
                    param_shardings=None, device=None):
    """-> step(params, state, batch, step) -> (params, state, metrics) on
    ``device`` (the card when None).

    ``dme_overlap=True`` streams the gradient's chunk axis through the
    collectives' double buffer, bit-identical to the synchronous exchange;
    it needs a chunk-streamable pipeline. ``dme_ownership`` (True / owner
    count / ``dist.sharding.ChunkOwnership``) decodes owner-partitioned,
    bit-identical to the whole decode: on the shard_map route each rank
    receives and decodes only the chunks it owns. ``mesh`` / ``client_axes``
    / ``dme_impl`` (auto | shard_map | gspmd): the exchange over the ranks
    (module docstring). On the shard_map route ``state["ef"]`` holds this
    rank's residual rows; a buffer of all n_clients rows going in is cut to
    them. The metrics: loss, ce, aux, grad_norm, lr, and with a pipeline
    compression_ratio (and intra_pod_reduction with ownership).

    ``pipeline_stages >= 1`` runs the block stack layer-pipelined over the
    ``pipeline_axis`` mesh axis, whose size it must be, in
    ``pipeline_microbatches`` microbatches (default: the stage count).

    A mesh with a ``data`` or ``model`` axis larger than 1 places the
    parameters (module docstring): ``param_shardings`` is their
    NamedSharding tree (default ``param_shardings(cfg, mesh)``; pass the
    tree the shards were cut by, e.g. with ``MODEL_PREF_EP``)."""
    value_and_grad = _value_and_grad
    if pipeline_stages:
        sizes = {} if mesh is None else shard_lib.mesh_axis_sizes(mesh)
        if pipeline_axis not in sizes:
            raise ValueError(f"pipeline_stages={pipeline_stages} needs a mesh with a "
                             f"'{pipeline_axis}' axis")
        if sizes[pipeline_axis] != pipeline_stages:
            raise ValueError(f"pipeline_stages={pipeline_stages} != mesh axis "
                             f"'{pipeline_axis}' size {sizes[pipeline_axis]}")
        if any(spec.ffn == "moe" for spec in cfg.block_pattern):
            raise ValueError("pipeline_stages does not support MoE block patterns "
                             "(the stage hop would drop the router aux loss)")
        value_and_grad = functools.partial(
            _value_and_grad,
            loss_fn=functools.partial(_pipelined_loss, mesh=mesh, axis=pipeline_axis,
                                      n_stages=pipeline_stages,
                                      n_micro=pipeline_microbatches or pipeline_stages),
            pipeline=(mesh, pipeline_axis))
    if dme_impl not in ("auto", "shard_map", "gspmd"):
        raise ValueError(f"dme_impl must be auto, shard_map or gspmd, got {dme_impl!r}")
    sizes = {} if mesh is None else shard_lib.mesh_axis_sizes(mesh)
    placed = None
    if sizes.get("data", 1) > 1 or sizes.get("model", 1) > 1:
        if pipeline_stages:
            raise NotImplementedError("pipeline_stages with parameters placed over a data "
                                      "or model axis is not ported yet (ROADMAP A.9.4)")
        shardings = param_shardings or shard_lib.param_shardings(cfg, mesh)
        row_axes = (tuple(a for a in ("data",) if a not in client_axes) if dme_spec is not None
                    else shard_lib.dp_axes(mesh))
        placed = _Placed(mesh, shardings, row_axes)
        value_and_grad = placed.value_and_grad
    dev = resolve_device(device)

    def _update(grads, state, params):
        if placed is None:
            return optimizer.update(grads, state["opt"], params)
        placed.release()
        return optimizer.update(placed.local(grads), state["opt"], params,
                                shardings=placed.shardings)

    def _on_device(batch):
        return {name: t.to(dev) for name, t in batch.items()}

    if dme_spec is None:

        def plain_step(params, state, batch, step):
            loss, metrics, grads = value_and_grad(params, cfg, _on_device(batch))
            params, opt, om = _update(grads, state, params)
            return params, {"opt": opt}, {"loss": loss, **metrics, **om}

        return plain_step

    pipe = as_pipeline(dme_spec)
    if dme_overlap:
        collectives.check_streamable(pipe)
    if dme_ownership:
        collectives.check_shardable(pipe)
    base_key = prand.key(seed, dev)
    shardings = collectives.dme_shardings(mesh, client_axes)
    n_shards, shard = (1, 0) if shardings is None else collectives.client_shard(mesh,
                                                                                 client_axes)

    def dme_step(params, state, batch, step):
        key = prand.fold_in(base_key, step)
        batch = _on_device(batch)
        n = batch["inputs"].shape[0]
        shard_map = (shardings is not None and dme_impl != "gspmd"
                     and n % n_shards == 0)
        lo, hi = (shard * (n // n_shards), (shard + 1) * (n // n_shards)) if shard_map \
            else (0, n)
        leaves = chunking.tree_leaves(params)
        shapes = [tuple(p.shape) for p in leaves] if placed is None else [
            shard_lib.whole_shape(p.shape, spec, mesh) for p, spec in zip(leaves, placed.specs)]
        stacked = [torch.empty((hi - lo,) + shape, dtype=p.dtype, device=p.device)
                   for p, shape in zip(leaves, shapes)]
        losses, metrics = [], []
        for i in range(lo, hi):
            loss, m, grads = value_and_grad(params, cfg, {k: v[i] for k, v in batch.items()})
            for dst, g in zip(stacked, chunking.tree_leaves(grads)):
                dst[i - lo].copy_(g)
            del grads
            losses.append(loss)
            metrics.append(m)
        losses = torch.stack(losses)
        metrics = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
        grads = chunking.tree_unflatten(params, stacked)
        if placed is not None:
            placed.release()
        ef = state.get("ef")
        if shard_map:
            if ef is not None and ef.shape[0] == n:
                ef = ef[lo:hi]
            grad_mean, info, new_ef = collectives.compressed_mean_tree_shardmap(
                pipe, key, grads, mesh, client_axes=client_axes, ef_chunks=ef,
                overlap=dme_overlap, overlap_tile=dme_overlap_tile,
                ownership=dme_ownership or None, device=dev)
            # every rank reports the all-client means
            losses = collectives.gather_clients(losses, mesh, client_axes)
            metrics = {k: collectives.gather_clients(v, mesh, client_axes)
                       for k, v in metrics.items()}
        else:
            grad_mean, info, new_ef = collectives.compressed_mean_tree(
                pipe, key, grads, shardings, ef_chunks=ef, overlap=dme_overlap,
                overlap_tile=dme_overlap_tile, ownership=dme_ownership or None, device=dev)
        del stacked, grads
        params, opt, om = _update(grad_mean, state, params)
        new_state = {"opt": opt}
        if new_ef is not None:
            new_state["ef"] = new_ef
        out = {
            "loss": losses.mean(),
            **{k: v.mean() for k, v in metrics.items()},
            **om,
            "compression_ratio": info["full_bytes"] / max(info["payload_bytes_per_client"], 1),
        }
        if dme_ownership:
            reduction = collectives.intra_pod_reduction(info)
            if reduction is not None:
                out["intra_pod_reduction"] = reduction
        return params, new_state, out

    return dme_step
