from .train_step import init_train_state, make_train_step  # noqa: F401
from .serve_step import make_decode_step, make_prefill_step  # noqa: F401
