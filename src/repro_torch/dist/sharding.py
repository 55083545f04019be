"""The chunk-ownership plan of the sharded server decode (port of
``ChunkOwnership`` / ``chunk_ownership`` in repro/dist/sharding.py).

The mesh placement rules of that module (``spec_for``, ``param_shardings``,
``cache_shardings``, ``dp_axes``) wait for ROADMAP A.9.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChunkOwnership:
    """Contiguous chunk-grid partition for the sharded server decode.

    Shard s OWNS global chunks ``[s*chunks_per_owner, (s+1)*chunks_per_owner)``
    clamped to ``n_chunks``: payloads for chunk c go only to c's owner
    (``dist.collectives``, ``ownership=``), the owner decodes its slice, and
    the global mean is assembled from the decoded slices.

    When ``n_chunks % n_shards == 0`` the slices tile the grid exactly;
    otherwise the grid is logically padded to ``padded_chunks = n_shards *
    chunks_per_owner`` (the payload routing of a mesh needs equal splits,
    and the intra-pod ledger counts the padded width); the tail shard(s) own
    fewer chunks, or none.
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
