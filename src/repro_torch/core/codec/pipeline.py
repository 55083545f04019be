"""The codec pipeline (port of repro/core/codec/pipeline.py), sparsifier
stage only.

    Pipeline([RandProjSpatial(k=64, d_block=1024)])

encode: x --sparsify--> Payload (client side); decode: Payload --sparsifier
decode--> x_hat (server side). The payload is self-describing and ``decode``
trusts the PAYLOAD's budget over its own config. The quantize, feedback,
temporal and code stages of the JAX pipeline are still to port.
"""
from __future__ import annotations

import dataclasses

import torch

from ... import resolve_device
from .payload import Payload, PayloadMeta, arrays_of, meta_of
from .sparsifiers import Sparsifier

# ROADMAP items of the stages this pipeline does not run yet
_UNPORTED_ROLES = {
    "quantize": "A.6 codec layer: quantizers",
    "feedback": "A.6 codec layer: stages (error feedback)",
    "temporal": "A.6 codec layer: stages (temporal)",
    "code": "A.6 codec layer: entropy coding",
}


@dataclasses.dataclass(frozen=True)
class Pipeline:
    stages: tuple

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))
        sparsifiers = []
        for s in self.stages:
            role = getattr(s, "role", None)
            if role in _UNPORTED_ROLES:
                raise NotImplementedError(
                    f"the {role!r} stage is not ported yet (ROADMAP {_UNPORTED_ROLES[role]})"
                )
            if role != "sparsify":
                raise TypeError(f"{s!r} is not a codec stage (role={role!r})")
            sparsifiers.append(s)
        if len(sparsifiers) != 1:
            raise ValueError("pipeline needs exactly one sparsifier stage")

    @property
    def sparsifier(self) -> Sparsifier:
        return self.stages[0]

    @property
    def d_block(self) -> int:
        return self.sparsifier.d_block

    def with_budget(self, k: int) -> "Pipeline":
        """Re-target the sparsifier at budget ``k`` (no-op for budget-free
        sparsifiers like identity, and when k already matches)."""
        if not hasattr(self.sparsifier, "k") or self.sparsifier.k == k:
            return self
        return Pipeline((dataclasses.replace(self.sparsifier, k=k),))

    # ------------------------------------------------------------ ledger

    def payload_schema(self, n_chunks: int) -> tuple:
        return self.sparsifier.payload_schema(n_chunks)

    def payload_meta(self, n_chunks: int) -> PayloadMeta:
        return PayloadMeta(
            budget=self.sparsifier.budget,
            d_block=self.d_block,
            stages=tuple(s.name for s in self.stages),
            schema=self.payload_schema(n_chunks),
        )

    def payload_nbytes(self, n_chunks: int) -> int:
        """Declared per-client wire bytes for an ``n_chunks``-chunk vector."""
        return self.payload_meta(n_chunks).declared_nbytes

    # ------------------------------------------------------------ codec

    def encode_payload(self, key, client_id, x_cd, draws=None) -> Payload:
        """Sparsify one client's (C, d_block) chunks; ``draws`` is this
        client's slice of the stacked draws (leaves (1|C, ...))."""
        arrays = self.sparsifier.encode(key, client_id, x_cd, draws=draws)
        return Payload(arrays=arrays, meta=self.payload_meta(x_cd.shape[0]))

    def _for_payload(self, payload) -> "Pipeline":
        """Trust the payload's self-described budget over our own config."""
        meta = meta_of(payload)
        return self if meta is None else self.with_budget(meta.budget)

    def decode_payload(self, key, payloads, n: int, client_ids=None, chunk_offset=0,
                       draws=None, bank=None):
        """Stacked payloads (leading n) -> (C, d_block) mean estimate."""
        pipe = self._for_payload(payloads)
        return pipe.sparsifier.decode(key, arrays_of(payloads), n, client_ids=client_ids,
                                      chunk_offset=chunk_offset, draws=draws, bank=bank)

    def self_decode(self, key, client_id, payload, draws=None):
        """One client's unbiased view of what the server attributes to it;
        ``draws`` is this client's slice of the stacked draws."""
        pipe = self._for_payload(payload)
        return pipe.sparsifier.self_decode(key, client_id, arrays_of(payload), draws=draws)

    def encode(self, key, client_id, x_cd, *, side_info=None, draws=None):
        """One client's encode (side information subtracted first). Returns
        (Payload, None): this pipeline holds no client state."""
        x_enc = x_cd if side_info is None else x_cd - side_info
        return self.encode_payload(key, client_id, x_enc, draws=draws), None

    def decode(self, key, payloads, n: int, *, client_ids=None, side_info=None,
               chunk_offset=0, draws=None, bank=None):
        """Server decode of stacked payloads, plus ``side_info`` if given."""
        out = self.decode_payload(key, payloads, n, client_ids=client_ids,
                                  chunk_offset=chunk_offset, draws=draws, bank=bank)
        return out if side_info is None else out + side_info

    def encode_all(self, key, xs, *, client_ids=None, side_info=None, draws=None):
        """xs: (n, C, d) -> (stacked Payload, None). ``client_ids`` (n,)
        overrides the 0..n-1 assignment; ``draws`` are stacked (n, 1|C, ...)."""
        n = xs.shape[0]
        ids = list(range(n)) if client_ids is None else [int(i) for i in client_ids]
        per = []
        for i, cid in enumerate(ids):
            d_i = None if draws is None else {name: v[i] for name, v in draws.items()}
            per.append(self.encode(key, cid, xs[i], side_info=side_info, draws=d_i)[0])
        arrays = {name: torch.stack([p.arrays[name] for p in per]) for name in per[0].arrays}
        return Payload(arrays=arrays, meta=per[0].meta), None

    def mean_estimate(self, key, xs, *, client_ids=None, side_info=None, draws=None,
                      bank=None, device=None):
        """One-shot DME on ``device``: xs (n, C, d) -> (C, d) mean estimate."""
        xs = xs.to(resolve_device(device))
        payloads, _ = self.encode_all(key, xs, client_ids=client_ids, side_info=side_info,
                                      draws=draws)
        return self.decode(key, payloads, xs.shape[0], client_ids=client_ids,
                           side_info=side_info, draws=draws, bank=bank)


def as_pipeline(spec) -> Pipeline:
    """A Pipeline, or a bare sparsifier config wrapped into one."""
    if isinstance(spec, Pipeline):
        return spec
    if isinstance(spec, Sparsifier):
        return Pipeline((spec,))
    raise TypeError(f"expected a Pipeline or a sparsifier config, got {type(spec).__name__}")
