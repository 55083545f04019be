from .common import LayerSpec, ModelConfig  # noqa: F401
from .transformer import (  # noqa: F401
    abstract_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_axes,
    param_defs,
    prefill,
)
