"""Sparsifier configs (port of repro/core/codec/sparsifiers.py).

A config is a frozen dataclass that carries only the fields its codec reads
and doubles as the spec the registered codec functions consume. Only
``RandProjSpatial`` is ported; ``use_pallas`` is renamed ``use_kernel``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

from ..estimators import base as est_base
from ..estimators import rand_proj_spatial  # noqa: F401  (registers the codec)
from .payload import AUX, VALUES, ArraySpec


@dataclasses.dataclass(frozen=True)
class Sparsifier:
    """Base sparsifier stage: (C, d_block) chunk batch -> payload tensors."""

    role: ClassVar[str] = "sparsify"
    name: ClassVar[str] = ""

    @property
    def codec(self) -> est_base.Codec:
        return est_base.get(self.name)

    @property
    def budget(self) -> int:
        """Per-chunk transmitted-coordinate budget (k)."""
        return getattr(self, "k", self.d_block)

    def encode(self, key, client_id, x_cd, draws=None) -> dict:
        return self.codec.encode(self, key, client_id, x_cd, draws=draws)

    def decode(self, key, arrays, n, client_ids=None, chunk_offset=0, draws=None, bank=None):
        """``chunk_offset``: global position of the first chunk in ``arrays``;
        position-keyed draws are re-derived from the global chunk id."""
        return self.codec.decode(self, key, arrays, n, client_ids=client_ids,
                                 chunk_offset=chunk_offset, draws=draws, bank=bank)

    def payload_schema(self, n_chunks: int) -> tuple:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class RandProjSpatial(Sparsifier):
    """Rand-Proj-Spatial family (paper Eq. 5), the paper's contribution."""

    name: ClassVar[str] = "rand_proj_spatial"
    k: int = 64
    d_block: int = 1024
    shared_randomness: bool = True
    transform: str = "avg"
    r_value: float | None = None
    r_mode: str = "fixed"         # fixed | est (in-decode R-hat)
    decode_method: str = "auto"   # auto | fused (gram and direct: still to port)
    projection: str = "srht"      # srht (subsample and gauss: still to port)
    beta_trials: int | None = None
    use_kernel: str = "auto"      # auto | force | never (kernels.ops)
    ridge: float = 1e-2           # eps of the fused resolvent solve (T + eps)
    cg_iters: int = 64            # CG iteration cap of the fused decode

    def __post_init__(self):
        if self.projection != "srht":
            raise NotImplementedError(
                f"projection={self.projection!r} is not ported yet (ROADMAP A.3)"
            )
        if self.r_mode not in ("fixed", "est"):
            raise ValueError(f"r_mode must be 'fixed' or 'est', got {self.r_mode!r}")

    def payload_schema(self, n_chunks: int) -> tuple:
        schema = (ArraySpec("vals", (n_chunks, self.k), "float32", VALUES),)
        if self.r_mode == "est":
            schema += (ArraySpec("norm_sq", (n_chunks,), "float32", AUX),)
        return schema

