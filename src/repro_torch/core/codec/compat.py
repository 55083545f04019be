"""Keyword-compatible pipeline construction and the boundary normaliser
(port of repro/core/codec/compat.py).

``build(name, **flat_kwargs)`` maps the historical flat-keyword style onto
the typed per-estimator configs: ``wangni_capacity`` -> ``Wangni.capacity``,
``induced_topk_frac`` -> ``Induced.topk_frac``, ``use_pallas`` ->
``RandProjSpatial.use_kernel``, ``payload_dtype`` -> a quantizer stage,
``ef`` / ``temporal`` / ``entropy_code`` -> their stages. Legacy field names
that do not apply to the chosen sparsifier are dropped; unknown names raise.

``as_pipeline``: Pipeline -> itself, bare sparsifier config -> one-stage
Pipeline, anything else -> TypeError.
"""
from __future__ import annotations

import dataclasses

from .entropy import EntropyCode
from .pipeline import Pipeline
from .quantizers import QUANTIZERS
from .sparsifiers import SPARSIFIERS, Sparsifier
from .stages import ErrorFeedback, Temporal

# old flat-spec field -> per-estimator config field (use_pallas is the JAX
# package's name of the port's use_kernel)
_FIELD_RENAMES = {"wangni_capacity": "capacity", "induced_topk_frac": "topk_frac",
                  "use_pallas": "use_kernel"}

# The fields of the old flat spec: ``build`` DROPS these when the chosen
# sparsifier has no such field; any other name it does not take raises.
_LEGACY_FIELDS = frozenset({
    "name", "k", "d_block", "transform", "r_value", "r_mode",
    "shared_randomness", "decode_method", "projection", "beta_trials",
    "use_pallas", "use_kernel", "wangni_capacity", "induced_topk_frac", "ef",
    "payload_dtype",
})


def build(name: str, **kw) -> Pipeline:
    """Flat-keyword construction of a pipeline.

        build("rand_proj_spatial", k=64, d_block=1024, transform="avg",
              payload_dtype="int8", ef=True)
        == Pipeline([RandProjSpatial(k=64, d_block=1024, transform="avg"),
                     Int8Quant(), ErrorFeedback()])
    """
    if name not in SPARSIFIERS:
        raise KeyError(f"unknown estimator {name!r}; have {sorted(SPARSIFIERS)}")
    payload_dtype = kw.pop("payload_dtype", "float32")
    ef = kw.pop("ef", False)
    temporal = kw.pop("temporal", False)
    entropy_code = kw.pop("entropy_code", False)
    cls = SPARSIFIERS[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    cfg_kw = {}
    for key, value in kw.items():
        new_key = _FIELD_RENAMES.get(key, key)
        if new_key in fields:
            cfg_kw[new_key] = value
        elif key not in _LEGACY_FIELDS:
            raise TypeError(f"{name!r} takes no field {key!r} (valid: {sorted(fields)})")
    stages: list = [cls(**cfg_kw)]
    if payload_dtype != "float32":
        if payload_dtype not in QUANTIZERS:
            raise ValueError(f"unknown payload_dtype {payload_dtype!r}; "
                             f"have float32, {', '.join(sorted(QUANTIZERS))}")
        stages.append(QUANTIZERS[payload_dtype]())
    if ef:
        stages.append(ErrorFeedback())
    if temporal:
        stages.append(Temporal())
    if entropy_code:
        stages.append(EntropyCode())
    return Pipeline(tuple(stages))


def as_pipeline(obj) -> Pipeline:
    """A Pipeline, or a bare sparsifier config wrapped into one."""
    if isinstance(obj, Pipeline):
        return obj
    if isinstance(obj, Sparsifier):
        return Pipeline((obj,))
    raise TypeError(f"expected Pipeline or sparsifier config, got {type(obj).__name__}")
