"""Deterministic synthetic LM data pipeline (port of repro/data/synthetic.py).

Token streams with learnable structure: a stride walk (each next token the
last plus a stride drawn from 1-16, mod V) with 15 % of the tokens replaced
by uniform noise, which gives a CE that falls measurably below log(V) within
a few hundred steps.

Determinism/restart: ``batch_at(step)`` is a pure function of (seed, step,
client), so a restarted job resumes mid-stream with no data loss or
duplication (checkpointing only stores the step counter). Non-IID mode
folds a share of each client's tokens into its own vocab band, so the
clients' token marginals, and their gradients, drift apart.

The draws are core.random's, in the JAX package's call sequence (``split``
of the client key in three, ``randint`` and ``bernoulli``), so a batch
equals the JAX package's bit for bit.
A batch is drawn on the device it is asked for, with the same bits on every
device.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..core import random as prand


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch: int              # per-client batch when n_clients > 0
    n_clients: int = 0      # 0 => no client axis
    seed: int = 0
    non_iid: float = 0.0    # 0 = IID; 1 = fully client-skewed marginals
    embed_dim: int = 0      # >0 => "embeddings" input mode (VLM/audio stubs)

    def _tokens(self, key: torch.Tensor, shape: tuple) -> torch.Tensor:
        """Markov-ish stream: a stride walk with 15 % uniform noise."""
        v = self.vocab_size
        k1, k2, k3 = prand.split(key, 3)
        base = prand.randint(k1, shape[:-1] + (1,), 0, v)
        steps = prand.randint(k2, shape, 1, 17)  # a deterministic stride walk
        walk = (base + torch.cumsum(steps, dim=-1)) % v
        noise = prand.randint(k3, shape, 0, v)
        pick = prand.bernoulli(prand.fold_in(key, 7), 0.15, shape)
        return torch.where(pick, noise, walk).to(torch.int32)

    def _skew(self, tokens: torch.Tensor, client_id: int) -> torch.Tensor:
        if self.non_iid <= 0:
            return tokens
        # fold each client's tokens into its own vocab band (a plain shift
        # mod V is measure-preserving on near-uniform marginals: no skew)
        width = max(self.vocab_size // max(self.n_clients, 1), 1)
        band = (client_id * width) % self.vocab_size
        skewed = band + tokens % width
        mix_key = prand.fold_in(prand.key(self.seed ^ 0x5EED, tokens.device), client_id)
        mix = prand.bernoulli(mix_key, self.non_iid, tuple(tokens.shape))
        return torch.where(mix, skewed, tokens)

    def batch_at(self, step: int, device=None) -> dict:
        """Pure function of step -> {"inputs", "labels"} on ``device``:
        (n_clients, batch, seq_len) int32 each ((batch, seq_len) without a
        client axis); inputs (..., embed_dim) float32 in embeddings mode."""
        dev = resolve_device(device)
        key = prand.fold_in(prand.key(self.seed, dev), int(step))
        shape = (self.batch, self.seq_len + 1)

        def one_client(cid: int) -> torch.Tensor:
            return self._skew(self._tokens(prand.fold_in(key, cid), shape), cid)

        if self.n_clients > 0:
            toks = torch.stack([one_client(c) for c in range(self.n_clients)])
        else:
            toks = one_client(0)
        inputs, labels = toks[..., :-1], toks[..., 1:]
        if self.embed_dim > 0:
            table = prand.normal(prand.key(self.seed ^ 0xE3BED, dev),
                                 (self.vocab_size, self.embed_dim)) * 0.05
            inputs = table[inputs.long()]
        return {"inputs": inputs, "labels": labels}


def make_batch_iterator(spec: SyntheticLM, start_step: int = 0, device=None):
    """Yields (step, batch) from ``start_step`` on, on ``device``."""
    dev = resolve_device(device)
    step = start_step
    while True:
        yield step, spec.batch_at(step, dev)
        step += 1
