"""Core math of the port: transforms, draws, beta, chunking, estimators, codec.

``mean_estimate``, ``encode``, ``decode``, ``encode_all`` and ``names`` are
the functional conveniences over a Pipeline or a sparsifier config, as in
``repro.core``."""
from .estimators import (  # noqa: F401
    decode,
    encode,
    encode_all,
    mean_estimate,
    names,
)
