"""Placement rules over (pod, data, model) meshes, and the chunk-ownership
plan of the sharded server decode (port of repro/dist/sharding.py).

One rule, applied uniformly from the single structural source of truth
(``transformer.param_defs``): every parameter names its logical axes, and
``spec_for`` maps logical axes to mesh axes with divisibility checks; a
dimension that does not divide falls through to replication.

Placement policy:
    - the "model" mesh axis goes to the first axis of ``model_pref`` present
      in the param whose dim is divisible by the model-axis size (tensor
      parallelism); ``MODEL_PREF_EP`` is the expert-parallel-first variant.
    - the "data" mesh axis goes to the "embed" axis when divisible (FSDP:
      params and optimizer moments are sharded over data too).
    - the "pod" axis is NEVER assigned to parameters: pods are DME clients
      holding full replicas whose gradient exchange is the compressed
      collective in ``dist.collectives``, not an all-reduce.

A spec is JAX's PartitionSpec as a tuple: one entry a tensor dimension,
``None``, a mesh axis name or a tuple of names. ``placements`` turns one
into DTensor placements on a ``DeviceMesh``. The rules read only a mesh's
axis names and sizes, so they take a ``DeviceMesh`` or anything with
``axis_names`` and ``devices.shape`` (a JAX mesh's attributes).
``make_mesh`` is ``jax.make_mesh``'s counterpart over ``torch.distributed``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch.distributed as dist

from .. import resolve_device

# logical axes eligible for tensor parallelism, in assignment preference order
MODEL_PREF = ("heads", "mamba_inner", "ff", "vocab", "experts")
# expert-parallel-first variant
MODEL_PREF_EP = ("experts", "heads", "mamba_inner", "ff", "vocab")

# logical axes eligible for the data (FSDP) axis, in preference order
DATA_PREF = ("embed",)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of ``mesh``."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    shape = mesh.devices.shape if hasattr(mesh, "devices") else mesh.shape
    return dict(zip(names, (int(s) for s in shape)))


def make_mesh(shape, axis_names, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the running
    process group, on ``device``'s type (the card when None). With no group
    running it joins ``torchrun``'s (``WORLD_SIZE`` set in the environment)
    or starts a world-size-1 group in this process: NCCL for the card, gloo
    for the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:  # torchrun's env:// rendezvous
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axis_names))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(i)`` where tensor dimension i names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_axis_sizes(mesh):
        dims = [i for i, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple) and name in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding(mesh, PartitionSpec)``)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


# ------------------------------------------------------- chunk ownership plan


@dataclasses.dataclass(frozen=True)
class ChunkOwnership:
    """Contiguous chunk-grid partition for the sharded server decode.

    Shard s OWNS global chunks ``[s*chunks_per_owner, (s+1)*chunks_per_owner)``
    clamped to ``n_chunks``: payloads for chunk c go only to c's owner
    (``dist.collectives``, ``ownership=``), the owner decodes its slice, and
    the global mean is assembled from the decoded slices.

    When ``n_chunks % n_shards == 0`` the slices tile the grid exactly;
    otherwise the grid is logically padded to ``padded_chunks = n_shards *
    chunks_per_owner`` (the intra-pod ledger counts the padded width); the
    tail shard(s) own fewer chunks, or none.
    """

    n_chunks: int
    n_shards: int

    def __post_init__(self):
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {self.n_chunks}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")

    @property
    def chunks_per_owner(self) -> int:
        """Owned-slice width (ceil division: the tail may own fewer)."""
        return -(-self.n_chunks // self.n_shards)

    @property
    def padded_chunks(self) -> int:
        return self.n_shards * self.chunks_per_owner

    @property
    def pad(self) -> int:
        return self.padded_chunks - self.n_chunks

    def slice_for(self, shard: int) -> tuple[int, int]:
        """Global chunk slice [lo, hi) shard ``shard`` owns (hi == lo for a
        fully-padded tail shard)."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range [0, {self.n_shards})")
        lo = shard * self.chunks_per_owner
        return min(lo, self.n_chunks), min(lo + self.chunks_per_owner, self.n_chunks)

    @property
    def slices(self) -> tuple:
        return tuple(self.slice_for(s) for s in range(self.n_shards))

    def owner_of(self, chunk: int) -> int:
        if not 0 <= chunk < self.n_chunks:
            raise ValueError(f"chunk {chunk} out of range [0, {self.n_chunks})")
        return chunk // self.chunks_per_owner


def chunk_ownership(n_chunks: int, n_shards: int) -> ChunkOwnership:
    """Ownership plan for an ``n_chunks`` grid over ``n_shards`` shards."""
    return ChunkOwnership(n_chunks=n_chunks, n_shards=n_shards)


# ------------------------------------------------------------ placement rules


def dp_axes(mesh) -> tuple:
    """Mesh axes carrying the batch dimension (pod-major)."""
    names = mesh_axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def spec_for(shape, axes, mesh, *, model_pref=MODEL_PREF, fsdp: bool = True) -> tuple:
    """Spec for one parameter from its logical axis names.

    ``axes`` is a tuple of logical names (or None), len == len(shape).
    """
    sizes = mesh_axis_sizes(mesh)
    model_size = sizes.get("model", 0)
    data_size = sizes.get("data", 0)
    assign: list = [None] * len(shape)

    if model_size > 1:
        for pref in model_pref:
            if pref in axes:
                i = axes.index(pref)
                if shape[i] % model_size == 0:
                    assign[i] = "model"
                    break
    if fsdp and data_size > 1:
        for pref in DATA_PREF:
            if pref in axes:
                i = axes.index(pref)
                if assign[i] is None and shape[i] % data_size == 0:
                    assign[i] = "data"
                    break
    return tuple(assign)


def param_shardings(cfg, mesh, *, model_pref=MODEL_PREF, fsdp: bool = True):
    """NamedSharding tree matching ``transformer.abstract_params(cfg)``."""
    from ..models import transformer

    return transformer.map_defs(
        lambda d: NamedSharding(mesh, spec_for(d.shape, d.axes, mesh, model_pref=model_pref,
                                               fsdp=fsdp)),
        transformer.param_defs(cfg))


def cache_shardings(cfg, mesh, cache_abs, *, seq_shard: bool = False):
    """Decode-cache placement (a NamedSharding tree like ``cache_abs``, whose
    leaves need only ``shape``; ``init_cache(..., device="meta")`` gives
    one). Leaves are keyed by their dict name:

        k/v  (B, S, kvh, dh): batch -> DP, kv heads -> model if divisible
        pos  (B, S)
        conv (B, K, convdim):  convdim -> model if divisible
        ssm  (B, nh, N, hd):   ssm heads -> model if divisible

    ``seq_shard=True`` (long-context, batch ~ 1) shards the sequence dim of
    k/v/pos over the DP axes instead of the batch dim. Leaves under "blocks"
    carry a leading stacked-layers dim that is never sharded.
    """
    dp = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    model_size = sizes.get("model", 0)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    dp_entry = dp[0] if len(dp) == 1 else dp  # a PartitionSpec's entry for the DP axes

    def one(keys, leaf):
        name = next((k for k in reversed(keys) if isinstance(k, str)), None)
        off = 1 if "blocks" in keys else 0  # stacked-layers leading dim
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if seq_shard and name in ("k", "v", "pos"):
            s_i = off + 1
            if dp and shape[s_i] % dp_size == 0:
                spec[s_i] = dp_entry
        elif dp and shape[off] % dp_size == 0:
            spec[off] = dp_entry
        if model_size > 1:
            if name in ("k", "v") and shape[off + 2] % model_size == 0:
                spec[off + 2] = "model"
            elif name == "conv" and shape[off + 2] % model_size == 0:
                spec[off + 2] = "model"
            elif name == "ssm" and shape[off + 1] % model_size == 0:
                spec[off + 1] = "model"
        return NamedSharding(mesh, tuple(spec))

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, keys + (i,)) for i, v in enumerate(node))
        return one(keys, node)

    return walk(cache_abs, ())
