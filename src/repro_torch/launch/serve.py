"""Batched serving CLI (port of repro/launch/serve.py): prefill a batch
of prompts, decode N tokens greedily. Runs on the CUDA device unless
``--device`` names another (``--device cpu`` runs the plain versions).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --preset tiny \\
        --batch 4 --prompt-len 64 --gen 32

``--seed`` gives the JAX package's CLI's weights (``init_params(cfg,
key(seed))``) and prompts (``key(seed + 1)``), through core.random's
threefry draws.

``serve(..., mesh=)`` serves with placed parameters (ROADMAP A.9.2;
``train.serve_step``): every rank of the mesh runs it on its shards, its
rows of the prompts and its shards of the cache, and gets the whole
batch's tokens and logits back.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs, resolve_device
from ..core import chunking
from ..core import random as prand
from ..dist import sharding as shard_lib
from ..models import init_cache, init_params
from ..train import make_decode_step, make_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _placed_cache(cfg, batch: int, seq: int, dev, mesh):
    """This rank's shards of an empty cache (``cache_shardings``)."""
    whole = init_cache(cfg, batch, seq, device=dev)
    shardings = shard_lib.cache_shardings(cfg, mesh, whole)
    pl = shard_lib.Placement(mesh)
    return chunking.tree_unflatten(whole, [pl.local(t, s.spec) for t, s in zip(
        chunking.tree_leaves(whole), chunking.tree_leaves(shardings))])


def serve(cfg, params, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          device=None, mesh=None, param_shardings=None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (drawn as the
    JAX package's CLI draws them: ``randint(key(seed + 1), (batch,
    prompt_len), 0, vocab)``), then ``gen - 1`` greedy decode steps.

    -> {"tokens": (batch, gen) int32, the first from the prefill;
    "prefill_logits": (batch, 1, vocab_padded) float32, and "last_logits"
    the last decode step's (the prefill's when ``gen`` is 1); "prompts";
    "prefill_s", "decode_s": wall seconds, the device synchronised}.

    ``mesh`` with a ``data`` or ``model`` axis larger than 1: ``params``
    are this rank's shards under ``param_shardings`` (module docstring);
    the batch splits over the DP axes and the results are gathered."""
    dev = resolve_device(device)
    sizes = {} if mesh is None else shard_lib.mesh_axis_sizes(mesh)
    placed = sizes.get("data", 1) > 1 or sizes.get("model", 1) > 1
    prefill = make_prefill_step(cfg, mesh, param_shardings)
    decode = make_decode_step(cfg, mesh, param_shardings)
    prompts = prand.randint(prand.key(seed + 1, dev), (batch, prompt_len), 0,
                            cfg.vocab_size).to(torch.int32)
    whole_prompts = prompts
    if placed:
        pl = shard_lib.Placement(mesh)
        k = pl.size(pl.batch_axes)
        if batch % k:
            raise ValueError(f"batch {batch} does not split over the DP axes "
                             f"{pl.batch_axes} ({k} ranks)")
        lo = pl.index(pl.batch_axes) * (batch // k)
        cache = _placed_cache(cfg, batch, prompt_len + gen, dev, mesh)  # this rank's rows
        prompts = prompts[lo:lo + batch // k]
    else:
        cache = init_cache(cfg, batch, prompt_len + gen, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, prompts)
    tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None].int()
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out, last = [tok], logits
    t0 = time.perf_counter()
    for i in range(gen - 1):
        pos = torch.full((prompts.shape[0], 1), prompt_len + i, dtype=torch.int32, device=dev)
        nxt, last, cache = decode(params, cache, tok, pos)
        tok = nxt[:, None].int()
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1)
    if placed:  # every rank's rows, in batch order
        tokens, logits, last = (pl.all_gather(t, pl.batch_axes, 0) for t in (tokens, logits, last))
    return {"tokens": tokens, "prefill_logits": logits, "last_logits": last,
            "prompts": whole_prompts, "prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b", choices=list(configs.ARCHS))
    ap.add_argument("--preset", default="tiny", choices=["tiny", "small", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.preset_config(args.arch, args.preset)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} is an embeddings-input stub; serve tokens archs")
    print(f"[serve] {cfg.name} preset={args.preset}: {cfg.n_params()/1e6:.1f}M params")
    params = init_params(cfg, args.seed, device=dev)
    res = serve(cfg, params, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                seed=args.seed, device=dev)
    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    print(f"[serve] prefill {args.batch}x{args.prompt_len} in {t_prefill:.2f}s "
          f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
    print(f"[serve] decoded {args.gen - 1} steps in {t_decode:.2f}s "
          f"({args.batch*(args.gen-1)/max(t_decode,1e-9):.0f} tok/s)")
    print(f"[serve] sample continuation (request 0): {res['tokens'][0].tolist()}")
    return res["tokens"]


if __name__ == "__main__":
    main()
