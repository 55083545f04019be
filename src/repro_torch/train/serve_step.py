"""Serving steps (port of repro/train/serve_step.py): prefill (fills the
cache) and single-token greedy decode. Serving carries no compressed mean."""
from __future__ import annotations

import torch

from ..models import transformer


def make_decode_step(cfg):
    def decode_step(params, cache, tokens, positions):
        logits, cache = transformer.decode_step(params, cfg, cache, tokens, positions)
        next_token = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)
        return next_token, logits, cache

    return decode_step


def make_prefill_step(cfg):
    def prefill(params, cache, tokens):
        return transformer.prefill(params, cfg, cache, tokens)

    return prefill
