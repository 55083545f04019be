from .adamw import AdamW, SGDM, clip_by_global_norm, global_norm  # noqa: F401
