"""The composable codec pipeline: ordered stages -> one estimator (port of
repro/core/codec/pipeline.py).

    Pipeline([RandProjSpatial(k=64, d_block=1024), Int8Quant(), ErrorFeedback()])

A pipeline owns exactly one sparsifier, at most one quantizer, and the
optional error-feedback, temporal and entropy-coding stages. The dataflow is
fixed by role, not list position:

    encode:  x --temporal subtract--> --EF add residual--> sparsify
               --quantize--> Payload                      (client side)
    decode:  Payload --dequantize--> sparsifier decode --side add-back--> x_hat
                                                          (server side)

``encode`` threads client-held state (``ClientState``) explicitly and
returns the updated state next to the payload. The payload is
self-describing, and the decode follows the PAYLOAD's budgets (``budget``
and ``chunk_budgets``) over its own config, so one decode path serves a
heterogeneous cohort. ``draws=`` (stacked (n, 1|C, ...), or one client's
(1|C, ...)) and ``bank=`` pass through to the sparsifier, so the JAX
package's draws and eigenvalue bank can be carried across. With
``repro_torch.obs`` enabled, ``encode_all`` and ``decode_payload`` count
their calls, clients and declared payload bytes (Python ints, no host read).
"""
from __future__ import annotations

import dataclasses

import torch

from ... import obs, resolve_device
from .. import random as prand
from ..estimators import base as est_base
from .payload import LEGACY_VALUE_NAMES, Payload, PayloadMeta, arrays_of, meta_of
from .sparsifiers import Sparsifier
from .stages import ClientState

_ROLES = ("sparsify", "quantize", "feedback", "temporal", "code")


@dataclasses.dataclass(frozen=True)
class Pipeline:
    stages: tuple

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))
        by_role: dict = {}
        for s in self.stages:
            role = getattr(s, "role", None)
            if role not in _ROLES:
                raise TypeError(f"{s!r} is not a codec stage (role={role!r})")
            by_role.setdefault(role, []).append(s)
            if len(by_role[role]) > 1:
                raise ValueError(f"pipeline has more than one {role!r} stage")
        if "sparsify" not in by_role:
            raise ValueError("pipeline needs exactly one sparsifier stage")

    # ------------------------------------------------------------ structure

    def _stage(self, role: str):
        return next((s for s in self.stages if s.role == role), None)

    @property
    def sparsifier(self) -> Sparsifier:
        return self._stage("sparsify")

    @property
    def quantizer(self):
        return self._stage("quantize")

    @property
    def ef_stage(self):
        return self._stage("feedback")

    @property
    def temporal_stage(self):
        return self._stage("temporal")

    @property
    def code_stage(self):
        """The entropy-coding (wire-accounting) stage, or None."""
        return self._stage("code")

    @property
    def has_ef(self) -> bool:
        return self.ef_stage is not None

    @property
    def has_client_temporal(self) -> bool:
        t = self.temporal_stage
        return t is not None and t.per_client

    @property
    def stateful(self) -> bool:
        return self.has_ef or self.has_client_temporal

    @property
    def non_streamable_stage(self):
        """The first stage that breaks chunk-streamability, as a
        ``(stage, reason)`` pair, or None when the pipeline streams: when a
        chunk slice's encode would differ from the same rows of the whole
        vector's (position-keyed draws, adaptive budgets over the full chunk
        axis, rounding noise drawn over the full array)."""
        sp = self.sparsifier
        if sp.name not in ("top_k", "identity") and not getattr(
            sp, "shared_randomness", False
        ):
            return sp, (
                "keys each chunk's encode randomness by its position in the "
                "array (shared_randomness=False / per-chunk fold_in), so a "
                "chunk slice encodes differently than the same rows of the "
                "full array"
            )
        if getattr(sp, "chunk_budgets", None) is not None:
            return sp, (
                "allocates an explicit per-chunk budget vector over the FULL "
                "chunk axis (adaptive budgets), so a chunk slice's flat "
                "payload layout depends on the other chunks' budgets"
            )
        q = self.quantizer
        if q is not None and q.name in ("int8", "correlated"):
            return q, (
                "draws stochastic-rounding noise over the full array shape, "
                "so a chunk slice draws different noise"
            )
        return None

    @property
    def chunk_streamable(self) -> bool:
        """True when encode and decode of a chunk slice equal the same rows of
        a whole-vector encode and decode (``non_streamable_stage``)."""
        return self.non_streamable_stage is None

    @property
    def non_shardable_stage(self):
        """The first stage whose DECODE mixes statistics across chunks, as a
        ``(stage, reason)`` pair, or None when every chunk's decode reads
        only its own payload rows (plus its global position): the
        precondition of the chunk-ownership sharded decode."""
        sp = self.sparsifier
        if sp.name in ("rand_k_spatial", "sparse_proj") and \
                getattr(sp, "r_mode", "fixed") == "est":
            return sp, (
                "pools its online R-hat statistic across ALL chunks (one "
                "scalar rho per decode), so an owner's chunk-slice decode "
                "would estimate a different rho than the full decode"
            )
        if getattr(sp, "chunk_budgets", None) is not None:
            return sp, (
                "packs adaptive per-chunk budgets into ONE flat value row "
                "(no per-chunk payload axis), so an owner cannot slice out "
                "just its own chunks' rows"
            )
        return None

    @property
    def decode_shardable(self) -> bool:
        """True when the decode of a chunk slice (at its global offset) equals
        the same rows of the full decode (``non_shardable_stage``)."""
        return self.non_shardable_stage is None

    @property
    def name(self) -> str:
        return self.sparsifier.name

    @property
    def k(self) -> int:
        return self.sparsifier.budget

    @property
    def d_block(self) -> int:
        return self.sparsifier.d_block

    @property
    def transform(self):
        return getattr(self.sparsifier, "transform", None)

    def describe(self) -> str:
        return " | ".join(s.name for s in self.stages)

    # ------------------------------------------------------------- rebuilds

    def replace_sparsifier(self, _ignore_missing: bool = False, **kw) -> "Pipeline":
        sp = self.sparsifier
        fields = {f.name for f in dataclasses.fields(sp)}
        if _ignore_missing:
            kw = {k: v for k, v in kw.items() if k in fields}
        else:
            unknown = set(kw) - fields
            if unknown:
                raise TypeError(f"sparsifier {sp.name!r} has no field(s) {sorted(unknown)}")
        if not kw:
            return self
        new_sp = dataclasses.replace(sp, **kw)
        return Pipeline(tuple(new_sp if s is sp else s for s in self.stages))

    replace = replace_sparsifier

    def with_budget(self, k: int) -> "Pipeline":
        """Re-target the sparsifier at budget ``k`` (no-op for budget-free
        sparsifiers like identity, and when k already matches)."""
        if not hasattr(self.sparsifier, "k") or self.sparsifier.k == k:
            return self
        return self.replace_sparsifier(k=k)

    # --------------------------------------------------------------- ledger

    def payload_schema(self, n_chunks: int) -> tuple:
        schema = self.sparsifier.payload_schema(n_chunks)
        if self.quantizer is not None:
            schema = self.quantizer.transform_schema(schema)
        return schema

    def payload_meta(self, n_chunks: int) -> PayloadMeta:
        return PayloadMeta(
            budget=self.sparsifier.budget,
            d_block=self.d_block,
            stages=tuple(s.name for s in self.stages),
            schema=self.payload_schema(n_chunks),
            chunk_budgets=getattr(self.sparsifier, "chunk_budgets", None),
        )

    def payload_nbytes(self, n_chunks: int) -> int:
        """Declared per-client wire bytes for an ``n_chunks``-chunk vector."""
        return self.payload_meta(n_chunks).declared_nbytes

    # ------------------------------------------------------- stateless core

    def encode_payload(self, key, client_id, x_cd, draws=None) -> Payload:
        """Sparsify and quantize one client's (C, d_block) chunks; ``draws``
        is this client's slice of the stacked draws (leaves (1|C, ...)). The
        quantizer's key is the client key; the cohort-correlated quantizer
        also takes the round key and the client id."""
        arrays = self.sparsifier.encode(key, client_id, x_cd, draws=draws)
        meta = self.payload_meta(x_cd.shape[0])
        q = self.quantizer
        if q is not None:
            qkey = est_base.client_key(prand.as_key(key, x_cd.device), client_id)
            if getattr(q, "needs_round_key", False):
                arrays = q.encode(qkey, arrays, meta.value_names, round_key=key,
                                  client_id=client_id)
            else:
                arrays = q.encode(qkey, arrays, meta.value_names)
        return Payload(arrays=arrays, meta=meta)

    def _for_payload(self, payload) -> "Pipeline":
        """Follow the payload's self-described budgets over our own config."""
        meta = meta_of(payload)
        if meta is None:
            return self
        pipe = self.with_budget(meta.budget)
        cb = meta.chunk_budgets
        if hasattr(pipe.sparsifier, "chunk_budgets") and cb != pipe.sparsifier.chunk_budgets:
            pipe = pipe.replace_sparsifier(chunk_budgets=cb)
        return pipe

    def _dequantize(self, payload) -> dict:
        arrays = arrays_of(payload)
        if self.quantizer is None:
            return arrays
        meta = meta_of(payload)
        if meta is not None:
            names = meta.value_names
        else:  # bare dict: only the historical value tensors quantize
            names = tuple(n for n in arrays if n in LEGACY_VALUE_NAMES)
        return self.quantizer.decode(arrays, names)

    def decode_payload(self, key, payloads, n: int, client_ids=None, chunk_offset=0,
                       draws=None, bank=None):
        """Stacked payloads (leading n) -> (C, d_block) mean estimate.
        ``chunk_offset``: global position of the payloads' first chunk."""
        pipe = self._for_payload(payloads)
        obs.count("codec", "decode.calls", sparsifier=pipe.sparsifier.name)
        obs.count("codec", "decode.clients", n)
        return pipe.sparsifier.decode(key, pipe._dequantize(payloads), n, client_ids=client_ids,
                                      chunk_offset=chunk_offset, draws=draws, bank=bank)

    def self_decode(self, key, client_id, payload, draws=None):
        """One client's unbiased view of what the server attributes to it;
        ``draws`` is this client's slice of the stacked draws."""
        pipe = self._for_payload(payload)
        return pipe.sparsifier.self_decode(key, client_id, pipe._dequantize(payload), draws=draws)

    # ------------------------------------------------- stateful client side

    def init_client_state(self, n_clients: int, n_chunks: int, device=None):
        """Stacked (leading n_clients) ClientState on ``device``, or None if
        the pipeline is stateless."""
        if not self.stateful:
            return None
        dev = resolve_device(device)

        def rows(stage):
            row = None if stage is None else stage.client_state(n_chunks, self.d_block, dev)
            return None if row is None else row.expand((n_clients,) + row.shape).clone()

        return ClientState(ef=rows(self.ef_stage), memory=rows(self.temporal_stage))

    def encode(self, key, client_id, x_cd, *, state: ClientState | None = None,
               side_info=None, draws=None):
        """One client's full encode: temporal subtract -> EF add -> sparsify
        -> quantize, plus the state updates. Returns (Payload, new_state);
        new_state is None when no state was threaded in."""
        tstage = self.temporal_stage
        mem = state.memory if state is not None else None
        side = side_info
        if tstage is not None and tstage.per_client and mem is not None:
            side = mem  # the client's own memory IS its side information
        x_enc = x_cd if side is None else x_cd - side
        resid = state.ef if state is not None else None
        if self.has_ef and resid is not None:
            x_enc = x_enc + resid
        payload = self.encode_payload(key, client_id, x_enc, draws=draws)
        if state is None:
            return payload, None
        new_ef, new_mem = state.ef, state.memory
        update_mem = tstage is not None and tstage.per_client and mem is not None
        if (self.has_ef and resid is not None) or update_mem:
            recon = self.self_decode(key, client_id, payload, draws=draws)
            if self.has_ef and resid is not None:
                new_ef = x_enc - recon
            if update_mem:
                new_mem = mem + tstage.resolve_eta(self.sparsifier.budget, self.d_block) * recon
        return payload, ClientState(ef=new_ef, memory=new_mem)

    def decode(self, key, payloads, n: int, *, client_ids=None, side_info=None,
               chunk_offset=0, draws=None, bank=None):
        """Server decode of stacked payloads, plus ``side_info`` if given (the
        broadcast estimate, or the survivors' mean memory)."""
        out = self.decode_payload(key, payloads, n, client_ids=client_ids,
                                  chunk_offset=chunk_offset, draws=draws, bank=bank)
        return out if side_info is None else out + side_info

    # ------------------------------------------------------------ batched

    def encode_all(self, key, xs, *, client_ids=None, side_info=None, states=None, draws=None):
        """xs: (n, C, d) -> (stacked Payload, stacked new ClientState | None).

        ``client_ids`` (n,) overrides the 0..n-1 assignment; ``states`` is a
        stacked ClientState of those clients; ``draws`` are stacked (n, 1|C,
        ...). The clients encode one after another."""
        n = xs.shape[0]
        if obs.enabled():  # guard: payload_nbytes builds a PayloadMeta
            obs.count("codec", "encode_all.calls", sparsifier=self.sparsifier.name)
            obs.count("codec", "encode_all.clients", n)
            obs.count("codec", "encode_all.payload_bytes", n * self.payload_nbytes(xs.shape[1]))
        ids = list(range(n)) if client_ids is None else [int(i) for i in client_ids]
        per, new_states = [], []
        for i, cid in enumerate(ids):
            d_i = None if draws is None else {name: v[i] for name, v in draws.items()}
            st = None if states is None else states.client(i)
            payload, new = self.encode(key, cid, xs[i], state=st, side_info=side_info, draws=d_i)
            per.append(payload)
            new_states.append(new)
        arrays = {name: torch.stack([p.arrays[name] for p in per]) for name in per[0].arrays}
        stacked = Payload(arrays=arrays, meta=per[0].meta)
        return stacked, (None if states is None else ClientState.stack(new_states))

    def mean_estimate(self, key, xs, *, client_ids=None, side_info=None, draws=None,
                      bank=None, device=None):
        """One-shot DME on ``device``: xs (n, C, d) -> (C, d) mean estimate."""
        xs = xs.to(resolve_device(device))
        if draws is None:  # the clients' maps, made once for the encode and the decode
            draws = self.sparsifier.round_draws(key, xs.shape[0], xs.shape[1],
                                                client_ids=client_ids, device=xs.device)
        payloads, _ = self.encode_all(key, xs, client_ids=client_ids, side_info=side_info,
                                      draws=draws)
        return self.decode(key, payloads, xs.shape[0], client_ids=client_ids,
                           side_info=side_info, draws=draws, bank=bank)
