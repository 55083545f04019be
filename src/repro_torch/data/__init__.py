from .synthetic import SyntheticLM, make_batch_iterator  # noqa: F401
