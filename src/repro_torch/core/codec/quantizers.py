"""Quantizer stages: payload-tensor transforms (port of
repro/core/codec/quantizers.py).

A quantizer never touches the vector domain: it rewrites the VALUES tensors
of an already sparsified payload (indices, scales and aux statistics pass
through), declares the resulting wire format by ``transform_schema``, and
inverts itself on the server and inside ``self_decode``, so error feedback
sees exactly what the server reconstructs.

``Int8Quant`` takes a per-chunk max scale and STOCHASTIC rounding, so any
unbiased sparsifier composed with it stays unbiased. Its dither is
``core.random.uniform`` of ``fold_in(qkey, salt)``, one salt per tensor name
(the JAX package's uniforms);
``CorrelatedQuant``'s is one uniform of the ROUND key shared by the cohort,
rotated per client. The rounding itself is ``stochastic_round``, one plain
function, so a test can feed it the JAX package's uniforms and hold the int8
values bit for bit.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import ClassVar

import torch

from .. import random as prand
from .payload import SCALES, VALUES, ArraySpec

# stable fold_in tags of the rounding noise, one a value-tensor name
_SALTS = {"vals": 101, "top_vals": 211, "rand_vals": 307}


def _salt(name: str) -> int:
    return _SALTS.get(name, int(zlib.crc32(name.encode()) & 0x7FFFFFFF))


def stochastic_round(v: torch.Tensor, u: torch.Tensor) -> tuple:
    """Int8 stochastic rounding of ``v`` (..., m) with dither ``u`` (..., m)
    on [0, 1): scale = max|v| / 127 + 1e-12 per row, q = floor(v / scale +
    u) clipped to [-128, 127]. -> (q int8, scale float32 (..., 1)); E[q *
    scale] = v for u uniform."""
    # a divisor tensor on v's device: CUDA divides by a Python scalar as a
    # multiply by its reciprocal, one ulp off the division on some rows
    div = torch.full((), 127.0, dtype=v.dtype, device=v.device)
    scale = v.abs().amax(-1, keepdim=True) / div + 1e-12
    q = torch.floor(v / scale + u)
    return torch.clamp(q, -128, 127).to(torch.int8), scale.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Bf16Quant:
    """bfloat16 cast of the value tensors: half the bytes; deterministic
    rounding (not unbiased), an error small against the sparsification's."""

    role: ClassVar[str] = "quantize"
    name: ClassVar[str] = "bf16"

    def encode(self, qkey, arrays: dict, value_names) -> dict:
        return {n: (v.to(torch.bfloat16) if n in value_names else v) for n, v in arrays.items()}

    def decode(self, arrays: dict, value_names) -> dict:
        return {n: (v.to(torch.float32) if n in value_names else v) for n, v in arrays.items()}

    def transform_schema(self, schema: tuple) -> tuple:
        return tuple(s._replace(dtype="bfloat16") if s.kind == VALUES else s for s in schema)


@dataclasses.dataclass(frozen=True)
class Int8Quant:
    """int8 + per-chunk float32 scale, stochastic rounding: E[q * scale] = v,
    so composition with any unbiased sparsifier stays unbiased."""

    role: ClassVar[str] = "quantize"
    name: ClassVar[str] = "int8"

    def _rounded(self, arrays: dict, value_names, dither) -> dict:
        out = {}
        for n, v in arrays.items():
            if n not in value_names:
                out[n] = v
                continue
            out[n], out[n + "_scale"] = stochastic_round(v, dither(n, v))
        return out

    def encode(self, qkey, arrays: dict, value_names) -> dict:
        return self._rounded(arrays, value_names,
                             lambda n, v: prand.uniform(prand.fold_in(qkey, _salt(n)), v.shape))

    def decode(self, arrays: dict, value_names) -> dict:
        out = {}
        for n, v in arrays.items():
            if n.endswith("_scale"):
                continue
            out[n] = v.to(torch.float32) * arrays[n + "_scale"] if n in value_names else v
        return out

    def transform_schema(self, schema: tuple) -> tuple:
        out = []
        for s in schema:
            if s.kind != VALUES:
                out.append(s)
                continue
            out.append(s._replace(dtype="int8"))
            out.append(ArraySpec(s.name + "_scale", s.shape[:-1] + (1,), "float32", SCALES))
        return tuple(out)


# golden-ratio low-discrepancy rotation of the dither grid (Suresh et al.
# 2022): client i's offset frac((i + 1) phi) spreads over [0, 1) for every
# cohort prefix and depends on (round key, client id) alone
_PHI = 0.6180339887498949
# fold_in tag of the cohort-shared dither stream, far from any client id
_COHORT_SALT = 0x0C011EC7


def cohort_dither(shared: torch.Tensor, client_id) -> torch.Tensor:
    """Client ``client_id``'s dither from the cohort's shared uniforms:
    frac(shared + frac((id + 1) phi)), the offset in float32 as the JAX
    package's weakly typed product gives it. Marginally U[0, 1) per client."""
    offset = torch.remainder(
        (torch.tensor(float(client_id), dtype=torch.float32, device=shared.device) + 1.0) * _PHI,
        1.0)
    return torch.remainder(shared + offset, 1.0)


@dataclasses.dataclass(frozen=True)
class CorrelatedQuant(Int8Quant):
    """Correlated int8 quantization (Suresh et al. 2022): ``Int8Quant``'s wire
    format, but the rounding dither is ONE uniform draw of the round key,
    shared by the cohort and rotated per client by ``cohort_dither``. Where
    clients quantize the same coordinate at the same dither position the
    rounding errors anti-correlate; with per-client supports it matches
    independent rounding. Without the round key and the client id it raises
    (the dither would degenerate to independent rounding)."""

    role: ClassVar[str] = "quantize"
    name: ClassVar[str] = "correlated"
    needs_round_key: ClassVar[bool] = True

    def encode(self, qkey, arrays: dict, value_names, *, round_key=None,
               client_id=None) -> dict:
        if round_key is None or client_id is None:
            raise ValueError(
                "CorrelatedQuant needs the shared round key and the client id "
                "(anti-correlated dither is a cohort-level construction); "
                "encode through Pipeline.encode_payload / encode_all")
        dither_key = prand.fold_in(prand.as_key(round_key, qkey.device), _COHORT_SALT)
        return self._rounded(arrays, value_names, lambda n, v: cohort_dither(
            prand.uniform(prand.fold_in(dither_key, _salt(n)), v.shape), client_id))


QUANTIZERS = {"bfloat16": Bf16Quant, "int8": Int8Quant, "correlated": CorrelatedQuant}
