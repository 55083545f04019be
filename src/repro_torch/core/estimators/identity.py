"""No-compression baseline: clients send their full chunks, the server
averages them; port of repro/core/estimators/identity.py."""
from __future__ import annotations

from ...kernels import ref as kref
from . import base


def encode(spec, key, client_id, x_cd, draws=None):
    base.no_draws(spec, draws)
    return {"vals": x_cd}


def decode(spec, key, payloads, n, client_ids=None, chunk_offset=0, draws=None):
    return kref.client_sum(payloads["vals"]) / n


def self_decode(spec, key, client_id, payload, draws=None):
    return payload["vals"]


base.register("identity", base.Codec(encode=encode, decode=decode, self_decode=self_decode))
