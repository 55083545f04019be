"""Estimator implementations; importing this package registers every codec
in the codec registry (estimators.base). The functional wrappers (encode,
decode, self_decode, encode_all, mean_estimate) delegate to core.codec."""
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
from .base import (  # noqa: F401
    Codec,
    decode,
    encode,
    encode_all,
    get,
    mean_estimate,
    names,
    register,
    self_decode,
)
