"""The port's functional estimator API (repro_torch.core: encode, decode,
self_decode, encode_all, mean_estimate, names; as in repro.core): each
wrapper, given a sparsifier config, equals its ``Pipeline`` method, on the
CPU. No JAX."""
from __future__ import annotations

import pytest
import torch

from repro_torch import core
from repro_torch.core import codec, estimators

SPECS = {
    "rand_proj_spatial": dict(k=8, d_block=64, transform="avg"),
    "rand_k": dict(k=8, d_block=64),
}
N, C, D = 3, 5, 64


def _equal(a, b) -> None:
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
        return
    assert a.meta == b.meta and sorted(a.arrays) == sorted(b.arrays)
    for name in a.arrays:
        assert torch.equal(a.arrays[name], b.arrays[name]), name


@pytest.mark.parametrize("name", sorted(SPECS))
def test_wrappers_equal_their_pipeline_methods(name):
    spec = codec.build(name, **SPECS[name]).stages[0]  # a bare sparsifier config
    pipe = codec.as_pipeline(spec)
    xs = torch.randn((N, C, D), generator=torch.Generator().manual_seed(4))
    key = 7
    payloads = core.encode_all(spec, key, xs)
    _equal(payloads, pipe.encode_all(key, xs)[0])
    _equal(core.encode(spec, key, 1, xs[1]), pipe.encode(key, 1, xs[1])[0])
    _equal(core.decode(spec, key, payloads, N), pipe.decode(key, payloads, N))
    one = core.encode(spec, key, 2, xs[2])
    _equal(estimators.self_decode(spec, key, 2, one), pipe.self_decode(key, 2, one))
    _equal(core.mean_estimate(spec, key, xs, device="cpu"),
           pipe.mean_estimate(key, xs, device="cpu"))
    assert name in core.names() and core.names() == estimators.names()
