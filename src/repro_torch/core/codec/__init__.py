"""repro_torch.core.codec: the codec pipeline of the port (sparsifier stage).

    from repro_torch.core import codec
    pipe = codec.Pipeline([codec.RandProjSpatial(k=64, d_block=1024)])
    x_hat = pipe.mean_estimate(seed, xs)
"""
from .payload import (  # noqa: F401
    AUX,
    INDICES,
    VALUES,
    ArraySpec,
    Payload,
    PayloadMeta,
    check_against_schema,
)
from .pipeline import Pipeline, as_pipeline  # noqa: F401
from .sparsifiers import (  # noqa: F401
    Identity,
    Induced,
    RandK,
    RandKSpatial,
    RandProjSpatial,
    Sparsifier,
    TopK,
    Wangni,
)
