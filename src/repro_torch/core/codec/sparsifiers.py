"""Sparsifier configs (port of repro/core/codec/sparsifiers.py).

A config is a frozen dataclass that carries only the fields its codec reads
and doubles as the spec the registered codec functions consume. Every
config of the JAX package is ported; ``RandProjSpatial``'s ``use_pallas``
is named ``use_kernel``. ``payload_schema`` is each codec's
own declaration of its wire format, held against the tensors it produces by
``check_against_schema``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

from .. import estimators  # noqa: F401  (registers every codec)
from ..estimators import base as est_base
from .payload import AUX, INDICES, VALUES, ArraySpec

_PROJECTIONS = ("srht", "subsample", "gauss")
_DECODE_METHODS = ("auto", "fused", "gram", "direct")


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
        """Per-chunk transmitted-coordinate budget (k; d_block for identity)."""
        return getattr(self, "k", self.d_block)

    def encode(self, key, client_id, x_cd, draws=None) -> dict:
        return self.codec.encode(self, key, client_id, x_cd, draws=draws)

    def round_draws(self, key, n, c, client_ids=None, device=None):
        """The round's maps for ``n`` clients of ``c`` chunks, stacked
        (leaves (n, 1|C, ...)), to pass as ``draws=`` to both the encode and
        the decode; None for a codec that draws nothing from the round key
        or derives its draws where it uses them."""
        fn = self.codec.draws
        return None if fn is None else fn(self, key, n, c, client_ids=client_ids, device=device)

    def decode(self, key, arrays, n, client_ids=None, chunk_offset=0, draws=None, bank=None):
        """``chunk_offset``: global position of the first chunk in ``arrays``;
        position-keyed draws are re-derived from the global chunk id. ``bank``
        goes to the codecs that read an eigenvalue bank."""
        extra = {} if bank is None else {"bank": bank}
        return self.codec.decode(self, key, arrays, n, client_ids=client_ids,
                                 chunk_offset=chunk_offset, draws=draws, **extra)

    @property
    def supports_self_decode(self) -> bool:
        return self.codec.self_decode is not None

    def self_decode(self, key, client_id, arrays, draws=None):
        if self.codec.self_decode is None:
            raise ValueError(f"sparsifier {self.name!r} has no per-client reconstruction "
                             "(self_decode); it cannot drive error feedback or temporal "
                             "memories")
        return self.codec.self_decode(self, key, client_id, arrays, draws=draws)

    def payload_schema(self, n_chunks: int) -> tuple:
        raise NotImplementedError

    @property
    def self_decode_norm_inflation(self) -> float:
        """``E||self_decode(x)||^2 / ||x||^2``: 1.0 where the per-client
        reconstruction does not inflate norms; the unbiased sparsifying
        families override it with their exact second-moment factor."""
        return 1.0

    def replace(self, **kw) -> "Sparsifier":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RandK(Sparsifier):
    """Rand-k sparsification (Konecny & Richtarik 2018); indices key-derived.

    ``chunk_budgets`` (rand_k only) replaces the uniform budget k by one
    budget a chunk, ``(k_0, ..., k_{C-1})``: the payload is one flat row of
    ``sum(chunk_budgets)`` values and the decode scales chunk c by
    ``d_block / k_c``, so each chunk stays unbiased at its own budget."""

    name: ClassVar[str] = "rand_k"
    k: int = 64
    d_block: int = 1024
    shared_randomness: bool = True
    chunk_budgets: tuple | None = None  # per-chunk (k_0..k_{C-1}); rand_k only

    def __post_init__(self):
        cb = self.chunk_budgets
        if cb is None:
            return
        if type(self).name != "rand_k":
            raise ValueError(f"chunk_budgets is rand_k-only (the {type(self).name!r} decode "
                             "assumes one uniform per-chunk budget)")
        cb = tuple(int(b) for b in cb)
        if not cb or any(b < 1 or b > self.d_block for b in cb):
            raise ValueError(f"chunk_budgets must be non-empty with every entry in "
                             f"[1, d_block={self.d_block}], got {cb}")
        object.__setattr__(self, "chunk_budgets", cb)

    def payload_schema(self, n_chunks: int) -> tuple:
        if self.chunk_budgets is not None:
            if len(self.chunk_budgets) != n_chunks:
                raise ValueError(f"chunk_budgets has {len(self.chunk_budgets)} entries but "
                                 f"the vector has {n_chunks} chunks")
            return (ArraySpec("vals", (sum(self.chunk_budgets),), "float32", VALUES),)
        return (ArraySpec("vals", (n_chunks, self.k), "float32", VALUES),)

    @property
    def self_decode_norm_inflation(self) -> float:
        # E||(d/k) scatter_k(x)||^2 = (d/k) ||x||^2 per chunk
        return self.d_block / self.k


def _with_norm_sq(schema: tuple, r_mode: str, n_chunks: int) -> tuple:
    if r_mode == "est":
        schema += (ArraySpec("norm_sq", (n_chunks,), "float32", AUX),)
    return schema


@dataclasses.dataclass(frozen=True)
class RandKSpatial(RandK):
    """Rand-k-Spatial decoding (Jhunjhunwala et al. 2021, paper Eq. 2/3)."""

    name: ClassVar[str] = "rand_k_spatial"
    transform: str = "avg"        # one|max|avg|opt
    r_value: float | None = None  # oracle R for transform="opt"
    r_mode: str = "fixed"         # fixed | est (in-decode R-hat)

    def payload_schema(self, n_chunks: int) -> tuple:
        return _with_norm_sq(super().payload_schema(n_chunks), self.r_mode, n_chunks)


@dataclasses.dataclass(frozen=True)
class RandProjSpatial(RandK):
    """Rand-Proj-Spatial family (paper Eq. 5), the paper's contribution."""

    name: ClassVar[str] = "rand_proj_spatial"
    transform: str = "avg"
    r_value: float | None = None
    r_mode: str = "fixed"         # fixed | est (in-decode R-hat)
    # auto: fused for srht and subsample, gram for gauss; fused: CG resolvent
    # solve on the kernels (closed form for subsample); gram: nk x nk
    # eigendecomposition; direct: the paper-literal d x d one (the oracle)
    decode_method: str = "auto"
    projection: str = "srht"      # srht | subsample (Lemma 4.1) | gauss
    beta_trials: int | None = None
    use_kernel: str = "auto"      # auto | force | never (kernels.ops)
    ridge: float = 1e-2           # eps of the fused resolvent solve (T + eps)
    cg_iters: int = 64            # CG iteration cap of the fused decode

    def __post_init__(self):
        super().__post_init__()
        if self.projection not in _PROJECTIONS:
            raise ValueError(f"unknown projection {self.projection!r}; pick from {_PROJECTIONS}")
        if (self.decode_method or "auto") not in _DECODE_METHODS:
            raise ValueError(f"unknown decode_method {self.decode_method!r}; pick from "
                             f"{_DECODE_METHODS}")
        if self.r_mode not in ("fixed", "est"):
            raise ValueError(f"r_mode must be 'fixed' or 'est', got {self.r_mode!r}")

    def payload_schema(self, n_chunks: int) -> tuple:
        return _with_norm_sq((ArraySpec("vals", (n_chunks, self.k), "float32", VALUES),),
                             self.r_mode, n_chunks)


@dataclasses.dataclass(frozen=True)
class SparseProj(Sparsifier):
    """Very-sparse random projection (Achlioptas 2003; Li et al. 2006) with
    the paper's correlation-aware Gram-resolvent decode.

    Each of the k rows of G holds ``nnz = round(d_block / s)`` signed entries
    of magnitude 1/sqrt(nnz) at drawn columns (with replacement), so
    E[G^T G] = (k/d) I as for the SRHT maps; ``s`` is the density divisor,
    the encode costs O(k d / s). ``r_mode="est"`` pools its online R-hat
    over every chunk (one scalar rho), so that decode is not shardable."""

    name: ClassVar[str] = "sparse_proj"
    k: int = 64
    d_block: int = 1024
    s: float = 16.0               # density divisor: nnz per row = d_block / s
    shared_randomness: bool = True
    transform: str = "avg"        # one|max|avg|opt
    r_value: float | None = None
    r_mode: str = "fixed"         # fixed | est (pooled online R-hat)
    beta_trials: int | None = None
    ridge: float = 1e-2           # eps of the resolvent solve (T + eps)
    cg_iters: int = 64            # CG iteration cap of the decode

    def __post_init__(self):
        if self.s < 1.0:
            raise ValueError(f"density divisor s must be >= 1, got {self.s}")

    @property
    def nnz(self) -> int:
        """Signed entries per projection row: round(d_block / s), >= 1."""
        return max(1, min(self.d_block, int(round(self.d_block / self.s))))

    def payload_schema(self, n_chunks: int) -> tuple:
        return _with_norm_sq((ArraySpec("vals", (n_chunks, self.k), "float32", VALUES),),
                             self.r_mode, n_chunks)

    @property
    def self_decode_norm_inflation(self) -> float:
        """Exact second moment of the with-replacement very-sparse decode,
        E||(d/k) G^T G x||^2 = (d/k) F ||x||^2 with
        F = 1 + (k-1)/d + 2(nnz-1)/(nnz d): the k rows are independent (the
        (k-1)/d cross-row term) and duplicate columns add the fourth-moment
        term 2(nnz-1)/(nnz d)."""
        d, k, nnz = self.d_block, self.k, self.nnz
        f = 1.0 + (k - 1.0) / d + 2.0 * (nnz - 1.0) / (nnz * d)
        return (d / k) * f


@dataclasses.dataclass(frozen=True)
class TopK(Sparsifier):
    """Top-k (Shi et al. 2019): data-dependent indices DO travel."""

    name: ClassVar[str] = "top_k"
    k: int = 64
    d_block: int = 1024

    def payload_schema(self, n_chunks: int) -> tuple:
        return (ArraySpec("vals", (n_chunks, self.k), "float32", VALUES),
                ArraySpec("idx", (n_chunks, self.k), "int32", INDICES))


@dataclasses.dataclass(frozen=True)
class Wangni(Sparsifier):
    """Non-uniform adaptive sparsification (Wangni et al. 2018)."""

    name: ClassVar[str] = "wangni"
    k: int = 64
    d_block: int = 1024
    capacity: float = 1.5  # fixed-shape payload capacity multiplier

    @property
    def capacity_slots(self) -> int:
        return int(math.ceil(self.capacity * self.k))

    def payload_schema(self, n_chunks: int) -> tuple:
        cap = self.capacity_slots
        return (ArraySpec("vals", (n_chunks, cap), "float32", VALUES),
                ArraySpec("idx", (n_chunks, cap), "int32", INDICES))


@dataclasses.dataclass(frozen=True)
class Induced(Sparsifier):
    """Induced compressor (Horvath & Richtarik 2021): Top-k1 + Rand-k2."""

    name: ClassVar[str] = "induced"
    k: int = 64
    d_block: int = 1024
    topk_frac: float = 0.5  # budget split k1 = round(topk_frac * k)

    def split(self) -> tuple[int, int]:
        k1 = max(1, int(round(self.topk_frac * self.k)))
        k1 = min(k1, self.k - 1) if self.k > 1 else 0
        return k1, self.k - k1

    def payload_schema(self, n_chunks: int) -> tuple:
        k1, k2 = self.split()
        t = max(k1, 1)  # k1 == 0 still ships a (C, 1) zero placeholder
        return (ArraySpec("top_vals", (n_chunks, t), "float32", VALUES),
                ArraySpec("top_idx", (n_chunks, t), "int32", INDICES),
                ArraySpec("rand_vals", (n_chunks, k2), "float32", VALUES),
                ArraySpec("rand_idx", (n_chunks, k2), "int32", INDICES))


@dataclasses.dataclass(frozen=True)
class Identity(Sparsifier):
    """No-compression baseline: the full chunk is the payload."""

    name: ClassVar[str] = "identity"
    d_block: int = 1024

    def payload_schema(self, n_chunks: int) -> tuple:
        return (ArraySpec("vals", (n_chunks, self.d_block), "float32", VALUES),)


SPARSIFIERS: dict[str, type] = {
    cls.name: cls
    for cls in (RandK, RandKSpatial, RandProjSpatial, SparseProj, TopK, Wangni,
                Induced, Identity)
}
