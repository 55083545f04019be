"""Training step factory (port of repro/train/train_step.py): loss ->
per-client grads -> (compressed) mean -> optimizer, on one device.

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

A step is functional: it returns new parameter and state trees and changes
none it is given. The GSPMD / shard_map exchange over a mesh and the GPipe
schedule (``pipeline_stages``) are ROADMAP A.9 and raise
NotImplementedError.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..core import chunking
from ..core import random as prand
from ..core.codec import as_pipeline
from ..dist import collectives
from ..models import transformer


def _value_and_grad(params, cfg, batch):
    """-> (loss, metrics, grads): ``transformer.loss_fn`` and its gradient
    with respect to every leaf of ``params`` (zeros for a leaf the loss does
    not read, as ``jax.grad`` gives)."""
    leaves = chunking.tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = transformer.loss_fn(chunking.tree_unflatten(params, live), cfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, chunking.tree_unflatten(params, grads)


def init_train_state(cfg, optimizer, params, dme_spec=None, n_clients: int = 0) -> dict:
    """{"opt": optimizer state[, "ef": (n_clients, C, d_block) float32
    zeros when the pipeline has error feedback]}, on the parameters' device."""
    state = {"opt": optimizer.init(params)}
    if dme_spec is not None:
        pipe = as_pipeline(dme_spec)
        if pipe.has_ef:
            leaves = chunking.tree_leaves(params)
            c = chunking.num_chunks(sum(p.numel() for p in leaves), pipe.d_block)
            state["ef"] = torch.zeros((n_clients, c, pipe.d_block), dtype=torch.float32,
                                      device=leaves[0].device)
    return state


def make_train_step(cfg, optimizer, *, dme_spec=None, mesh=None, client_axes=("pod",),
                    seed: int = 0, dme_impl: str = "auto", dme_overlap: bool = False,
                    dme_overlap_tile: int = 1, dme_ownership=False, pipeline_stages: int = 0,
                    pipeline_axis: str = "pipe", pipeline_microbatches: int = 0, device=None):
    """-> step(params, state, batch, step) -> (params, state, metrics) on
    ``device`` (the card when None).

    ``dme_overlap=True`` streams the gradient's chunk axis through the
    collectives' double buffer, bit-identical to the synchronous exchange;
    it needs a chunk-streamable pipeline. ``dme_ownership`` (True / owner
    count / ``dist.sharding.ChunkOwnership``) decodes owner-partitioned, one
    logical owner after another, bit-identical to the whole decode.
    ``client_axes`` and ``pipeline_axis`` name mesh axes; with no mesh they
    are not read. The metrics: loss, ce, aux, grad_norm, lr, and with a
    pipeline compression_ratio (and intra_pod_reduction with ownership)."""
    if pipeline_stages:
        raise NotImplementedError(
            f"pipeline_stages={pipeline_stages}: the GPipe schedule (dist/pipeline.py) is not "
            "ported to repro_torch yet (ROADMAP A.9)")
    if mesh is not None:
        raise NotImplementedError("mesh= (the GSPMD / shard_map gradient exchange) is not "
                                  "ported to repro_torch yet (ROADMAP A.9)")
    if dme_impl == "shard_map":
        raise NotImplementedError("dme_impl='shard_map' is not ported to repro_torch yet "
                                  "(ROADMAP A.9)")
    dev = resolve_device(device)

    def _on_device(batch):
        return {name: t.to(dev) for name, t in batch.items()}

    if dme_spec is None:

        def plain_step(params, state, batch, step):
            loss, metrics, grads = _value_and_grad(params, cfg, _on_device(batch))
            params, opt, om = optimizer.update(grads, state["opt"], params)
            return params, {"opt": opt}, {"loss": loss, **metrics, **om}

        return plain_step

    pipe = as_pipeline(dme_spec)
    if dme_overlap:
        collectives.check_streamable(pipe)
    if dme_ownership:
        collectives.check_shardable(pipe)
    base_key = prand.key(seed, dev)

    def dme_step(params, state, batch, step):
        key = prand.fold_in(base_key, step)
        batch = _on_device(batch)
        n = batch["inputs"].shape[0]
        leaves = chunking.tree_leaves(params)
        stacked = [torch.empty((n,) + tuple(p.shape), dtype=p.dtype, device=p.device)
                   for p in leaves]
        losses, metrics = [], []
        for i in range(n):
            loss, m, grads = _value_and_grad(params, cfg, {k: v[i] for k, v in batch.items()})
            for dst, g in zip(stacked, chunking.tree_leaves(grads)):
                dst[i].copy_(g)
            del grads
            losses.append(loss)
            metrics.append(m)
        grad_mean, info, new_ef = collectives.compressed_mean_tree(
            pipe, key, chunking.tree_unflatten(params, stacked), ef_chunks=state.get("ef"),
            overlap=dme_overlap, overlap_tile=dme_overlap_tile,
            ownership=dme_ownership or None, device=dev)
        del stacked
        params, opt, om = optimizer.update(grad_mean, state["opt"], params)
        new_state = {"opt": opt}
        if new_ef is not None:
            new_state["ef"] = new_ef
        out = {
            "loss": torch.stack(losses).mean(),
            **{k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]},
            **om,
            "compression_ratio": info["full_bytes"] / max(info["payload_bytes_per_client"], 1),
        }
        if dme_ownership:
            reduction = collectives.intra_pod_reduction(info)
            if reduction is not None:
                out["intra_pod_reduction"] = reduction
        return params, new_state, out

    return dme_step
