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

Placed trees (ROADMAP A.9.2). Where the JAX package hands GSPMD global
arrays with shardings, the port keeps on each rank its LOCAL SHARD of every
placed tensor, a plain tensor, with the ``NamedSharding`` tree beside it:
``shard_tree`` cuts a whole tree to this rank's shards, ``full_tree``
gathers them back, and ``local_shape`` gives a shard's shape. A dimension sharded over a tuple of axes is split row-major over
them (DTensor's order). ``Placement`` is a mesh seen from one rank (its
coordinates and axis groups) and holds the collectives the placed model
code runs; ``placing(p)`` installs one for ``current()`` to return, and
``copy_to`` / ``reduce_from`` / ``gather_from`` are the tensor-parallel
autograd pairs over an axis (identities where the axis has one rank).

Every collective here goes through ``to_wire`` / ``from_wire``: on a
gloo group a card tensor is copied to the host before the call and back
after, its bytes counted as ``dist/host_staged_bytes`` (NCCL passes device
tensors), and half-precision payloads are summed in float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Any

import torch
import torch.distributed as dist

from .. import obs, resolve_device

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


# ------------------------------------------------------------ the transport


def to_wire(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` where ``group``'s transport reads it: on gloo a card tensor is
    copied to the host, and the bytes counted."""
    if t.device.type != "cpu" and dist.get_backend(group) == "gloo":
        obs.count("dist", "host_staged_bytes", t.numel() * t.element_size())
        return t.cpu()
    return t.contiguous()


def from_wire(t: torch.Tensor, device) -> torch.Tensor:
    if t.device != torch.device(device):
        obs.count("dist", "host_staged_bytes", t.numel() * t.element_size())
        return t.to(device)
    return t


_HALF = (torch.bfloat16, torch.float16)


def _reduce(group, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor on ``t``'s device."""
    wire = to_wire(group, t.float() if t.dtype in _HALF else t)
    if wire.data_ptr() == t.data_ptr():
        wire = wire.clone()
    dist.all_reduce(wire, group=group)
    return from_wire(wire, t.device).to(t.dtype)


def _gather(group, n: int, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` stacked in rank order: (n, *t.shape)."""
    wire = to_wire(group, t).reshape(-1)
    out = wire.new_empty(n * wire.numel())
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, wire, group=group)
    return from_wire(out, t.device).view((n,) + tuple(t.shape))


# ------------------------------------------------------------ placed trees


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor placed by ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for n, entry in zip(shape, spec):
        k = math.prod(sizes[a] for a in _entry_axes(entry))
        if n % k:
            raise ValueError(f"dimension {n} does not split over {entry} ({k} ranks)")
        out.append(n // k)
    return tuple(out)


def whole_shape(shape, spec, mesh) -> tuple:
    """The shape of the whole tensor whose shard has ``shape`` under ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    return tuple(n * math.prod(sizes[a] for a in _entry_axes(entry))
                 for n, entry in zip(shape, spec))


class Placement:
    """A ``DeviceMesh`` seen from this rank: its axis sizes, its coordinate
    on each axis, and the collectives the placed model code runs over them.

    ``batch_axes``: the axes a batch's rows are split over (the DP axes by
    default; ``("data",)`` inside a DME client, whose clients lie on
    ``pod``). The loss's label count and the MoE capacity, drop order and
    aux loss are taken over them, so they keep their whole-batch meaning."""

    def __init__(self, mesh, batch_axes=None):
        self.mesh = mesh
        self.sizes = mesh_axis_sizes(mesh)
        self.coords = dict(zip(self.sizes, mesh.get_coordinate()))
        self.batch_axes = dp_axes(mesh) if batch_axes is None else tuple(batch_axes)
        self.groups = {a: mesh.get_group(a) for a in self.sizes}

    def size(self, axes) -> int:
        return math.prod(self.sizes.get(a, 1) for a in _entry_axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        i = 0
        for a in _entry_axes(axes):
            i = i * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return i

    def _live(self, axes) -> list:
        return [a for a in _entry_axes(axes) if self.sizes.get(a, 1) > 1]

    def all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over ``axes`` (``t`` itself over one rank)."""
        for a in self._live(axes):
            t = _reduce(self.groups[a], t)
        return t

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Every rank's ``t`` over ``axes`` concatenated along ``dim``, in
        the row-major order of their indices."""
        for a in reversed(self._live(axes)):  # the inner axis first
            parts = _gather(self.groups[a], self.sizes[a], t)
            t = torch.cat(parts.unbind(0), dim=dim)
        return t

    def all_reduce_many(self, tensors: list, axes) -> list:
        """``all_reduce`` of each tensor, in one call a dtype (the tensors
        laid end to end)."""
        if not self._live(axes):
            return list(tensors)
        out = list(tensors)
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            at = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            flat = self.all_reduce(torch.cat([tensors[i].reshape(-1) for i in at]), axes)
            for i, part in zip(at, flat.split([tensors[i].numel() for i in at])):
                out[i] = part.view(tensors[i].shape)
        return out

    def full_many(self, tensors: list, specs: list, axis: str) -> list:
        """``full(t, spec, (axis,))`` of each tensor, in one gather a dtype:
        the shards laid end to end (they have the same shapes on every
        rank), gathered once and cut back into whole tensors."""
        n = self.sizes.get(axis, 1)
        dims = [next((d for d, e in enumerate(spec) if axis in _entry_axes(e)), None)
                for spec in specs]
        out = list(tensors)
        if n == 1:
            return out
        for dtype in dict.fromkeys(t.dtype for t, d in zip(tensors, dims) if d is not None):
            at = [i for i, (t, d) in enumerate(zip(tensors, dims))
                  if d is not None and t.dtype == dtype]
            flat = torch.cat([tensors[i].reshape(-1) for i in at])
            every = _gather(self.groups[axis], n, flat)  # (n, total)
            for i, part in zip(at, every.split([tensors[i].numel() for i in at], dim=1)):
                parts = part.reshape((n,) + tuple(tensors[i].shape)).unbind(0)
                out[i] = torch.cat(parts, dim=dims[i])
        return out

    def local(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's shard of the whole tensor ``t`` placed by ``spec``:
        its own storage, so the whole tensor can be freed."""
        for dim, entry in enumerate(spec):
            k = self.size(entry)
            if k > 1:
                n = t.shape[dim] // k
                t = t.narrow(dim, self.index(entry) * n, n)
        return t.clone()

    def full(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor whose shard ``t`` is, on every rank."""
        for dim, entry in enumerate(spec):
            if entry is not None:
                t = self.all_gather(t, entry, dim)
        return t

    def is_leader(self, spec) -> bool:
        """Whether this rank is the one replica of its shard that counts it:
        coordinate 0 on every axis ``spec`` does not shard over."""
        used = {a for entry in spec for a in _entry_axes(entry)}
        return all(c == 0 for a, c in self.coords.items() if a not in used)


def shard_tree(tree, shardings):
    """``tree``'s whole tensors cut to this rank's shards under the
    NamedSharding tree ``shardings`` (``param_shardings``,
    ``cache_shardings``)."""
    from ..core import chunking

    leaves = chunking.tree_leaves(shardings)
    pl = Placement(leaves[0].mesh)
    return chunking.tree_unflatten(tree, [pl.local(t, s.spec) for t, s in
                                          zip(chunking.tree_leaves(tree), leaves)])


def full_tree(tree, shardings):
    """Every shard of ``tree`` gathered back to its whole tensor."""
    from ..core import chunking

    leaves = chunking.tree_leaves(shardings)
    pl = Placement(leaves[0].mesh)
    return chunking.tree_unflatten(tree, [pl.full(t, s.spec) for t, s in
                                          zip(chunking.tree_leaves(tree), leaves)])


# ------------------------------------------------ the installed placement

_CURRENT: Placement | None = None


def current() -> Placement | None:
    """The placement the model code runs under (None: whole tensors)."""
    return _CURRENT


@contextlib.contextmanager
def placing(placement: Placement | None):
    """Run the model code under ``placement`` (None: whole tensors)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, placement
    try:
        yield placement
    finally:
        _CURRENT = prev


def model_size() -> int:
    """The ``model`` axis's rank count under the installed placement (1
    without one)."""
    return 1 if _CURRENT is None else _CURRENT.size("model")


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.pl, ctx.axes = _CURRENT, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.pl.all_reduce(g, ctx.axes), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return _CURRENT.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.pl, ctx.axes, ctx.dim, ctx.n = _CURRENT, axes, dim, x.shape[dim]
        return _CURRENT.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.pl.index(ctx.axes) * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n), None, None


def _trivial(axes) -> bool:
    return _CURRENT is None or _CURRENT.size(axes) == 1


def copy_to(x: torch.Tensor, axes="model") -> torch.Tensor:
    """Enter a sharded region over ``axes``: the identity forward, the
    gradient summed over the ranks backward (each rank's use of ``x`` is
    its own share of the computation)."""
    return x if _trivial(axes) else _CopyTo.apply(x, axes)


def reduce_from(x: torch.Tensor, axes="model") -> torch.Tensor:
    """Leave a sharded region: the partial sums of every rank added, the
    gradient passed through (what follows is the same on every rank)."""
    return x if _trivial(axes) else _ReduceFrom.apply(x, axes)


def gather_from(x: torch.Tensor, axes="model", dim: int = -1) -> torch.Tensor:
    """Every rank's shard of ``x`` concatenated along ``dim``; backward
    each rank keeps its own slice of the gradient (what follows is the same
    on every rank)."""
    if _trivial(axes):
        return x
    return _GatherFrom.apply(x, axes, dim % x.dim())


def psum(x: torch.Tensor, axes="model") -> torch.Tensor:
    """A sum over ``axes`` that every rank then uses its own way: summed
    forward and backward."""
    return reduce_from(copy_to(x, axes), axes)
