"""Estimator implementations; importing this package registers every codec
in the codec registry (estimators.base)."""
from . import (  # noqa: F401
    identity,
    induced,
    rand_k,
    rand_k_spatial,
    rand_proj_spatial,
    sparse_proj,
    top_k,
    wangni,
)
