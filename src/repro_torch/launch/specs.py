"""Input stand-ins for every (arch x input shape) cell (port of
repro/launch/specs.py): shape, dtype and placement, no storage.

JAX's ``ShapeDtypeStruct`` has no PyTorch twin; ``TensorSpec`` is a frozen
record of the three. Its ``sharding`` is a ``dist.sharding.NamedSharding``
(None where the JAX package leaves the placement to jit: a replicated
scalar). The shapes come from the port's meta-device trees
(``transformer.abstract_params``, ``init_cache(device="meta")``), the
placements from ``dist.sharding``'s rules, so they equal the JAX
package's cell for cell.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import chunking
from ..dist import sharding as shard_lib
from ..models import transformer
from ..models.common import ModelConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor by its shape, dtype and placement (JAX's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype
    sharding: Any = None


def pspec(*entries) -> tuple:
    """A spec with JAX's PartitionSpec canonical entries: a tuple of one
    axis is that axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _ts(shape, dtype, mesh, spec) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype, shard_lib.NamedSharding(mesh, spec))


def supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    info = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k decode skipped (docs/DESIGN.md §6)"
    if info["kind"] == "train" and cfg.input_mode == "embeddings":
        # VLM backbone trains on embeddings; still supported (stub frontend)
        return True, ""
    return True, ""


def batch_specs(cfg: ModelConfig, shape_name: str, mesh, *, n_clients: int = 0) -> dict:
    """Training batch specs. n_clients > 0 adds the leading DME client dim."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    dp = shard_lib.dp_axes(mesh)
    tail = (None,) * (2 if cfg.input_mode == "embeddings" else 1)
    if n_clients:
        lead = (n_clients, b // n_clients)
        tok_spec = pspec("pod", "data", *tail)
        lab_spec = pspec("pod", "data", None)
    else:
        lead = (b,)
        tok_spec = pspec(dp, *tail)
        lab_spec = pspec(dp, None)
    if cfg.input_mode == "embeddings":
        inputs = _ts(lead + (s, cfg.d_model), torch.bfloat16, mesh, tok_spec)
    else:
        inputs = _ts(lead + (s,), torch.int32, mesh, tok_spec)
    labels = _ts(lead + (s,), torch.int32, mesh, lab_spec)
    return {"inputs": inputs, "labels": labels}


def decode_specs(cfg: ModelConfig, shape_name: str, mesh):
    """(cache, tokens, positions) specs for decode; (cache, tokens, None) for
    prefill."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    seq_shard = shape_name == "long_500k"
    cache_meta = transformer.init_cache(cfg, b, s, torch.bfloat16, device="meta")
    cache_sh = shard_lib.cache_shardings(cfg, mesh, cache_meta, seq_shard=seq_shard)
    cache = chunking.tree_unflatten(cache_meta, [
        TensorSpec(tuple(t.shape), t.dtype, sh) for t, sh in
        zip(chunking.tree_leaves(cache_meta), chunking.tree_leaves(cache_sh))])
    dp = shard_lib.dp_axes(mesh)
    bspec = (None,) if seq_shard else (dp,)
    if info["kind"] == "prefill":
        if cfg.input_mode == "embeddings":
            tokens = _ts((b, s, cfg.d_model), torch.bfloat16, mesh, pspec(dp, None, None))
        else:
            tokens = _ts((b, s), torch.int32, mesh, pspec(dp, None))
        return cache, tokens, None
    if cfg.input_mode == "embeddings":
        tokens = _ts((b, 1, cfg.d_model), torch.bfloat16, mesh, pspec(*bspec, None, None))
    else:
        tokens = _ts((b, 1), torch.int32, mesh, pspec(*bspec, None))
    positions = _ts((b, 1), torch.int32, mesh, pspec(*bspec, None))
    return cache, tokens, positions


def params_specs(cfg: ModelConfig, mesh, *, model_pref=shard_lib.MODEL_PREF,
                 fsdp: bool = True):
    abs_p = transformer.abstract_params(cfg)
    shards = shard_lib.param_shardings(cfg, mesh, model_pref=model_pref, fsdp=fsdp)
    return chunking.tree_unflatten(abs_p, [
        TensorSpec(tuple(t.shape), t.dtype, sh) for t, sh in
        zip(chunking.tree_leaves(abs_p), chunking.tree_leaves(shards))])


def opt_state_specs(optimizer, params_specs_tree):
    """The optimizer state's specs: the moment trees inherit the parameters'
    placements; scalars (``step``) are replicated, their sharding None."""
    meta = chunking.tree_unflatten(params_specs_tree, [
        torch.empty(ts.shape, dtype=ts.dtype, device="meta")
        for ts in chunking.tree_leaves(params_specs_tree)])
    state = optimizer.init(meta)
    out = {}
    for name, sub in state.items():
        if name in ("mu", "nu", "m"):
            out[name] = chunking.tree_unflatten(sub, [
                TensorSpec(tuple(t.shape), t.dtype, ts.sharding) for t, ts in
                zip(chunking.tree_leaves(sub), chunking.tree_leaves(params_specs_tree))])
        else:
            out[name] = TensorSpec(tuple(sub.shape), sub.dtype, None)
    return out
