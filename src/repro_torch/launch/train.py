"""End-to-end training CLI (port of repro/launch/train.py). Runs on the
CUDA device unless ``--device`` names another (``--device cpu`` runs the
plain versions).

    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \\
        --preset tiny --steps 200 --estimator rand_proj_spatial --clients 4

- --preset tiny|small|full scales the arch config (``configs.preset_config``).
- The DME estimator compresses the cross-client gradient mean exactly as in
  the multi-pod deployment (client axis = leading batch dim), on the local
  route of ``dist.collectives``.
- Fault tolerance: checkpoints every --ckpt-every steps; restart the same
  command line and it resumes; --inject-failures demonstrates recovery.
- Every arch trains; the default is mamba2-130m. The default --ckpt-dir is
  repro_ckpt under the temporary directory (/tmp unless TMPDIR says
  otherwise).
- --pipeline-stages N layer-pipelines the block stack over a ``pipe`` mesh
  axis of N ranks (GPipe, ``dist.pipeline``) in --pipeline-microbatches
  microbatches. One stage runs in this process on a one-rank group (NCCL
  on the card, gloo on the CPU); N stages run under torchrun, one rank a
  stage, each rank checkpointing under its own ``rank<r>`` directory:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --device cpu --preset tiny --pipeline-stages 2 --steps 20
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile

import torch.distributed as dist

from .. import configs, resolve_device
from ..core import codec
from ..data import SyntheticLM
from ..dist import sharding
from ..models import init_params
from ..optim import AdamW
from ..train import init_train_state, make_train_step
from ..train.supervisor import FaultPlan, Supervisor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m", choices=list(configs.ARCHS))
    ap.add_argument("--preset", default="tiny", choices=["tiny", "small", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4, help="per-client batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clients", type=int, default=4, help="DME clients (0 = no compression)")
    ap.add_argument("--estimator", default="rand_proj_spatial")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--d-block", type=int, default=1024)
    ap.add_argument("--transform", default="avg")
    ap.add_argument("--ef", action="store_true", help="error feedback (top_k/wangni)")
    ap.add_argument("--dme-ownership", type=int, default=0,
                    help="owner shards for the sharded server decode "
                         "(docs/DESIGN.md §10); 0 = replicated decode")
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="layer-pipeline the block stack over this many "
                         "ranks (GPipe over a 'pipe' mesh axis; N > 1 under "
                         "torchrun); 0 = off")
    ap.add_argument("--pipeline-microbatches", type=int, default=0,
                    help="microbatch count for --pipeline-stages "
                         "(default: the stage count)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--non-iid", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failures", default="", help="comma steps, e.g. 30,80")
    ap.add_argument("--resize", default="", help="step:new_n, e.g. 100:3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # the pipeline's mesh joins torchrun's process group, or starts one of
    # this process alone (sharding.make_mesh); the group ends with the run
    own_group = bool(args.pipeline_stages) and not dist.is_initialized()
    try:
        return _train(args, dev)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev):
    cfg = configs.preset_config(args.arch, args.preset)
    print(f"[train] {cfg.name} preset={args.preset}: {cfg.n_params()/1e6:.1f}M params, "
          f"{args.clients or 1} clients, estimator="
          f"{args.estimator if args.clients else 'none (uncompressed)'}")
    optimizer = AdamW(lr=args.lr, warmup_steps=20)

    dme = None
    if args.clients:
        dme = codec.build(args.estimator, k=args.k, d_block=args.d_block,
                          transform=args.transform, ef=args.ef)

    mesh, ckpt_dir = None, os.path.join(args.ckpt_dir, f"{cfg.name}_{args.preset}")
    if args.pipeline_stages:
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        if world != args.pipeline_stages:
            raise ValueError(f"--pipeline-stages {args.pipeline_stages} needs "
                             f"{args.pipeline_stages} ranks (torchrun --nproc-per-node "
                             f"{args.pipeline_stages}); this run has {world}")
        mesh = sharding.make_mesh((args.pipeline_stages,), ("pipe",), device=dev)
        if args.pipeline_stages > 1:  # every rank holds the whole state
            ckpt_dir = os.path.join(ckpt_dir, f"rank{dist.get_rank()}")

    def make_step(n_clients):
        return make_train_step(cfg, optimizer, dme_spec=dme if n_clients else None,
                               dme_ownership=args.dme_ownership, mesh=mesh,
                               pipeline_stages=args.pipeline_stages,
                               pipeline_microbatches=args.pipeline_microbatches, device=dev)

    def make_data(n_clients):
        data = SyntheticLM(
            vocab_size=cfg.vocab_size, seq_len=args.seq, batch=args.batch,
            n_clients=n_clients, seed=args.seed, non_iid=args.non_iid,
            embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else 0,
        )
        return functools.partial(data.batch_at, device=dev)

    def init_state():
        params = init_params(cfg, args.seed, device=dev)
        return params, init_train_state(cfg, optimizer, params, dme, args.clients)

    plan = FaultPlan(
        fail_at_steps=tuple(int(s) for s in args.inject_failures.split(",") if s),
        resize_at={int(kv.split(":")[0]): int(kv.split(":")[1])
                   for kv in args.resize.split(",") if kv} or None,
    )
    sup = Supervisor(
        make_step=make_step, make_data=make_data, init_state=init_state,
        ckpt_dir=ckpt_dir,
        n_clients=args.clients, ckpt_every=args.ckpt_every,
    )
    params, state, history = sup.run(args.steps, fault_plan=plan)
    if history:
        first, last = history[0][1], history[-1][1]
        print(f"[train] loss {first:.4f} -> {last:.4f} over {args.steps} steps")
    return history


if __name__ == "__main__":
    main()
