from .serve_step import make_decode_step, make_prefill_step  # noqa: F401
