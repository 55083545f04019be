"""CLI entry point for federated round workloads (port of repro/fl/run.py).

    PYTHONPATH=src python -m repro_torch.fl.run --task power_iteration \
        --estimator rand_proj_spatial --smoke

    # paper Fig. 3/4-style comparison (same keys => paired across estimators):
    PYTHONPATH=src python -m repro_torch.fl.run --task dme --rho 0.95 --compare

    # temporal decoding on a slowly-drifting task (broadcast side info):
    PYTHONPATH=src python -m repro_torch.fl.run --task drift --estimator \
        rand_proj_spatial --temporal

    # per-client Rand-k-Temporal (client-held memories in ClientState):
    PYTHONPATH=src python -m repro_torch.fl.run --task drift --estimator rand_k \
        --client-temporal

    # async rounds: stragglers' late payloads admitted at staleness 1
    # instead of dropped:
    PYTHONPATH=src python -m repro_torch.fl.run --task drift --dropout 0.3 --async

    # the same on the CPU, with the kernels' plain versions:
    PYTHONPATH=src python -m repro_torch.fl.run --device cpu --smoke

    # the mesh route of dist/: one "pod" axis over the world, one rank
    # alone or N ranks under torchrun (gloo on the CPU):
    PYTHONPATH=src python -m repro_torch.fl.run --device cpu --task dme \
        --backend shard_map --ownership
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.fl.run \
        --device cpu --task dme --clients 4 --backend shard_map

    # hierarchical aggregation: 2 pods decoded pod-local, then combined;
    # with --hosts 2 two processes (spawned here, or placed by a launcher
    # that sets REPRO_PROCESS_ID / REPRO_NUM_PROCESSES / REPRO_COORDINATOR)
    # each decode their owned pods and exchange the records:
    PYTHONPATH=src python -m repro_torch.fl.run --device cpu --task dme \
        --pods 2 --hosts 2

    # a torch.profiler trace of the run (kernels, device time) into DIR, and
    # the metrics snapshot with the kernel telemetry (kernels/dispatch,
    # kernels/decode_route, kernels/cg_iters):
    PYTHONPATH=src python -m repro_torch.fl.run --task dme --profile-dir DIR \
        --metrics-json metrics.json

Runs on the card unless ``--device cpu`` asks for the CPU. Per-round lines
report the task metric, the MSE against the survivors' true mean, the
cumulative payload-byte ledger, and (async) admitted stale payloads;
--compare prints an MSE-at-equal-bytes table across the baseline estimator
family. ``--backend gspmd|shard_map`` runs the rounds on a mesh of one
``pod`` axis over the process group's ranks (started by ``torchrun``, or
this process alone); every rank prints the same History. ``--pods P``
aggregates hierarchically (``runtime/``); ``--hosts N`` runs it on N
processes that each decode their owned pods and hold the same History;
process 0 reports.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from .. import obs, resolve_device
from ..core import codec
from ..dist import sharding
from ..runtime import launch as launch_lib
from . import rounds as rounds_lib
from .clients import Cohort
from .tasks import get_task

COMPARE = [
    ("rand_k", dict()),
    ("rand_k_spatial", dict(transform="avg")),
    ("rand_proj_spatial", dict(transform="avg")),
    ("sparse_proj", dict(transform="avg")),
]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--task", default="power_iteration",
                    choices=["power_iteration", "kmeans", "linear_regression",
                             "logistic_regression", "dme", "drift"],
                    help="paper §5 workload or correlation-dialed synthetic")
    ap.add_argument("--estimator", default="rand_proj_spatial",
                    help="registered sparsifier name (codec.SPARSIFIERS)")
    ap.add_argument("--transform", default="avg",
                    help="one|max|avg|opt|wavg (wavg = online-R practical variant)")
    ap.add_argument("--rounds", type=int, default=20,
                    help="federated rounds to drive")
    ap.add_argument("--clients", type=int, default=10,
                    help="cohort size n")
    ap.add_argument("--k", type=int, default=0, help="0 => d_block // 10")
    ap.add_argument("--budget", default="manual", choices=["manual", "auto"],
                    help="auto => derive k from the Johnson-Lindenstrauss "
                         "bound via codec.suggest_budget(n_clients, --jl-eps, "
                         "d_block), overriding --k; raises "
                         "BudgetExceedsDimension when the bound does not fit")
    ap.add_argument("--jl-eps", dest="jl_eps", type=float, default=0.5,
                    help="JL distortion target for --budget auto")
    ap.add_argument("--d-block", type=int, default=0, help="0 => task dim (<=1024)")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of the cohort sampled per round")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="P(sampled client misses the round deadline); sync "
                         "rounds drop these stragglers, --async admits them "
                         "late")
    ap.add_argument("--async", dest="async_rounds", action="store_true",
                    help="async rounds: don't wait for stragglers — buffer "
                         "their late payloads and admit them into the next "
                         "round's decode (staleness-1 aggregation)")
    ap.add_argument("--staleness", type=int, default=1, choices=[0, 1],
                    help="max admitted payload age under --async: 1 admits "
                         "late payloads next round, 0 drops them (scheduling-"
                         "only ablation)")
    ap.add_argument("--stale-weight", type=float, default=1.0,
                    help="per-client weight of an admitted stale payload "
                         "relative to a fresh one")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered chunk streaming: encode chunk c+1 "
                         "while chunk c's payload is in flight (bit-identical "
                         "to the sync decode)")
    ap.add_argument("--ownership", action="store_true",
                    help="sharded server decode: each owner shard receives "
                         "and decodes only the chunk slice it owns, then "
                         "decoded means are assembled (bit-identical; cuts "
                         "intra-pod traffic at >= 2 owners)")
    ap.add_argument("--owners", type=int, default=0,
                    help="owner shards for --ownership; 0 means one owner")
    ap.add_argument("--temporal", action="store_true",
                    help="decode deltas against the server's previous estimate")
    ap.add_argument("--client-temporal", action="store_true",
                    help="true per-client temporal memories (codec.Temporal)")
    ap.add_argument("--ef", action="store_true",
                    help="error-feedback stage (residuals in ClientState)")
    ap.add_argument("--no-fused-kernels", dest="no_fused_kernels",
                    action="store_true",
                    help="escape hatch: decode rand_proj_spatial via the "
                         "unfused Gram-eigh path instead of the fused "
                         "matrix-free kernel fast path (docs/KERNELS.md); "
                         "no-op for estimators without a fused decode")
    ap.add_argument("--payload-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8", "correlated"],
                    help="quantizer stage appended to the pipeline "
                         "(correlated = anti-correlated int8 rounding offsets "
                         "from the shared round key; same wire bytes as int8)")
    ap.add_argument("--entropy-code", dest="entropy_code", action="store_true",
                    help="append the EntropyCode stage: the parallel "
                         "History.coded_bytes ledger charges the EXACT "
                         "entropy-coded stream length of each payload")
    ap.add_argument("--adaptive-budgets", dest="adaptive_budgets",
                    action="store_true",
                    help="rand_k only: rewrite each round's per-chunk budget "
                         "vector from the previous estimate's per-chunk norm "
                         "mass (docs/DESIGN.md §3.8)")
    ap.add_argument("--backend", default="local",
                    choices=["local", "gspmd", "shard_map"],
                    help="round execution backend; gspmd and shard_map run "
                         "on a mesh of one pod axis over the ranks (torchrun) "
                         "or this process alone")
    ap.add_argument("--pods", type=int, default=1,
                    help=">= 2 turns on hierarchical aggregation "
                         "(docs/DESIGN.md §11): pod-local correlation-aware "
                         "sub-decode, then a cross-pod mean of decoded "
                         "estimates; 1 is the flat path (bitwise identical)")
    ap.add_argument("--hosts", type=int, default=1,
                    help=">= 2 starts that many processes via "
                         "runtime.spawn_local, each decoding its owned pods "
                         "(or joins an existing runtime when REPRO_PROCESS_ID "
                         "is set by a cluster launcher)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="the runtime's key-value store for --hosts >= 2 "
                         "(process 0 hosts it; default: REPRO_COORDINATOR)")
    ap.add_argument("--rho", type=float, default=0.9, help="dme/drift correlation")
    ap.add_argument("--dim", type=int, default=0,
                    help="dme/drift vector width (0 => 256, or 128 with --smoke)")
    ap.add_argument("--scheme", default="iid", choices=["iid", "band", "dirichlet"],
                    help="non-IID data partition for the §5 tasks")
    ap.add_argument("--alpha", type=float, default=0.3, help="dirichlet alpha")
    ap.add_argument("--seed", type=int, default=0,
                    help="round key + participation draw seed")
    ap.add_argument("--compare", action="store_true",
                    help="run the rand_k/rand_k_spatial/rand_proj_spatial family")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes + 3 rounds; CI entry-point guard")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto round timeline here "
                         "(one track per phase, byte/MSE annotations off the "
                         "exact ledger; open at https://ui.perfetto.dev — "
                         "docs/OBSERVABILITY.md)")
    ap.add_argument("--metrics-json", dest="metrics_json", default=None,
                    metavar="PATH",
                    help="write the metrics-registry snapshot + per-round "
                         "History records as JSON, one entry per compared "
                         "run (schema_version 2)")
    ap.add_argument("--profile-dir", dest="profile_dir", default=None,
                    metavar="DIR",
                    help="wrap the run in a torch.profiler session and write "
                         "its Chrome trace (host and device activities) here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                         "the plain versions)")
    return ap


def make_task(args, device=None):
    kw: dict = {"n_clients": args.clients, "seed": args.seed, "device": device}
    if args.task in ("dme", "drift"):
        kw["rho"] = args.rho
        kw["d"] = args.dim or (128 if args.smoke else 256)
    elif args.task == "power_iteration":
        kw.update(d=256 if args.smoke else 1024,
                  samples=400 if args.smoke else 4000, scheme=args.scheme,
                  alpha=args.alpha)
    elif args.task == "kmeans":
        kw.update(d=64 if args.smoke else 256, samples=400 if args.smoke else 4000,
                  scheme=args.scheme, alpha=args.alpha)
    elif args.task == "linear_regression":
        kw.update(d=128 if args.smoke else 512, samples=400 if args.smoke else 4000,
                  scheme=args.scheme, alpha=args.alpha)
    elif args.task == "logistic_regression":
        kw.update(feat=32 if args.smoke else 64, samples=400 if args.smoke else 4000,
                  scheme=args.scheme, alpha=args.alpha)
    return get_task(args.task, **kw)


def run_one(task, args, name, est_kw, ctx=None):
    d_block = args.d_block or min(1024, max(64, 1 << (task.dim - 1).bit_length()))
    if getattr(args, "budget", "manual") == "auto":
        k = codec.suggest_budget(task.n_clients, getattr(args, "jl_eps", 0.5),
                                 d_block)
    else:
        k = args.k or max(1, d_block // 10)
    if getattr(args, "no_fused_kernels", False) and name == "rand_proj_spatial":
        est_kw = dict(est_kw, decode_method="gram")
    spec = codec.build(
        name, k=k, d_block=d_block,
        payload_dtype=getattr(args, "payload_dtype", "float32"),
        ef=getattr(args, "ef", False),
        temporal=getattr(args, "client_temporal", False),
        entropy_code=getattr(args, "entropy_code", False),
        **est_kw,
    )
    cohort = Cohort(n_clients=task.n_clients, participation=args.participation,
                    dropout=args.dropout)
    mesh = None
    if args.backend in ("gspmd", "shard_map"):
        # every rank of the process group becomes the client axis
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        mesh = sharding.make_mesh((world,), ("pod",), device=task.device)
    cfg = rounds_lib.RoundConfig(
        n_rounds=3 if args.smoke else args.rounds, seed=args.seed,
        temporal=args.temporal, backend=args.backend, mesh=mesh,
        async_rounds=getattr(args, "async_rounds", False),
        staleness=getattr(args, "staleness", 1),
        stale_weight=getattr(args, "stale_weight", 1.0),
        overlap=getattr(args, "overlap", False),
        ownership=getattr(args, "ownership", False),
        n_owners=getattr(args, "owners", 0),
        hierarchy="hier" if getattr(args, "pods", 1) > 1 else "flat",
        pods=getattr(args, "pods", 1),
        runtime=ctx,
        adaptive_budgets=getattr(args, "adaptive_budgets", False),
    )
    state, hist = rounds_lib.run_rounds(task, spec, cohort, cfg, device=task.device)
    return spec, state, hist


def report(task, spec, hist, verbose=True):
    if verbose:
        cum = 0
        for t, (m, mse, b, ns, nst) in enumerate(
            zip(hist.metric, hist.mse, hist.bytes, hist.n_survivors,
                hist.n_stale)
        ):
            cum += b
            stale = f"  stale={nst}" if nst else ""
            print(f"  round {t:3d}  {task.metric_name}={m:.5f}  mse={mse:.6f}  "
                  f"survivors={ns}  bytes={cum}{stale}")
    mean_mse = float(np.nanmean(hist.mse))
    final = ("" if task.metric is None
             else f"final_{task.metric_name}={hist.metric[-1]:.5f}  ")
    coded = ("" if hist.total_coded_bytes == hist.total_bytes
             else f"  coded_bytes={hist.total_coded_bytes}")
    print(f"{task.name:20s} {spec.name}({spec.transform or '-'})  k={spec.k} "
          f"d_block={spec.d_block}  rounds={len(hist.mse)}  "
          f"{final}mean_mse={mean_mse:.6f}  total_bytes={hist.total_bytes}"
          f"{coded}")
    return mean_mse


def _nan_to_none(obj):
    """NaN -> null so the exported JSON stays strict-parser friendly."""
    if isinstance(obj, float) and math.isnan(obj):
        return None
    if isinstance(obj, dict):
        return {k: _nan_to_none(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_nan_to_none(v) for v in obj]
    return obj


def _run_meta(args, runs) -> dict:
    """Run metadata + ledger totals shared by the trace file and the metrics
    export — what tools/trace_report.py validates the trace events against.
    ``runs``: [(estimator label, History, metrics snapshot | None), ...]
    (several under --compare)."""
    dev = resolve_device(args.device)
    return {
        "task": args.task,
        "estimators": [label for label, _, _ in runs],
        "backend": args.backend,
        "pods": getattr(args, "pods", 1),
        "hosts": getattr(args, "hosts", 1),
        "seed": args.seed,
        "n_rounds": sum(len(h.mse) for _, h, _ in runs),
        "ledger_total_bytes": sum(h.total_bytes for _, h, _ in runs),
        "ledger_coded_bytes": sum(h.total_coded_bytes for _, h, _ in runs),
        "ledger_stale_bytes": sum(h.total_stale_bytes for _, h, _ in runs),
        "ledger_intra_pod_bytes": sum(h.total_intra_pod_bytes
                                      for _, h, _ in runs),
        "ledger_dcn_bytes": sum(h.total_dcn_bytes for _, h, _ in runs),
        "torch_version": torch.__version__,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }


def _capture_metrics(args):
    """Per-run metrics snapshot for ``--metrics-json``: read the registry,
    then RESET it so the next compared run starts from zero — each run's
    export is its own counters, not a cumulative last-writer-wins blob.
    (Tracer events are untouched: the registry and the timeline are separate
    stores, and the trace metadata ledger sums all runs by design.)"""
    if not args.metrics_json:
        return None
    snap = obs.snapshot()
    obs.reset()
    return snap


def _write_obs_outputs(args, tracer, runs) -> None:
    if not runs or not (args.trace or args.metrics_json):
        return
    meta = _run_meta(args, runs)
    if tracer is not None:
        for mk, mv in meta.items():
            tracer.set_meta(mk, mv)
        tracer.write(args.trace)
        obs.uninstall_tracer()
        print(f"trace: {args.trace}  (open at https://ui.perfetto.dev)")
    if args.metrics_json:
        out = {
            "schema_version": 2,
            "run": meta,
            # one entry per compared run, each with ITS OWN metrics snapshot
            # and round records (schema v1 kept one cumulative snapshot and a
            # label-keyed dict that collided on repeated labels)
            "runs": [
                {"estimator": label, "metrics": snap or {},
                 "rounds": h.round_records()}
                for label, h, snap in runs
            ],
        }
        with open(args.metrics_json, "w") as f:
            json.dump(_nan_to_none(out), f, indent=1)
        print(f"metrics: {args.metrics_json}")


def _cli_worker(ctx, argv):
    """Spawned-process body of ``--hosts N``: re-enters main() with the env
    naming this process, so the child takes the join-existing-runtime path.
    Module-level because spawn children unpickle workers by qualified name."""
    return main(argv)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.hosts > 1 and os.environ.get(launch_lib.ENV_PROCESS_ID) is None:
        # no launcher placed us: start the processes ourselves
        child_argv = list(argv if argv is not None else sys.argv[1:])
        codes = launch_lib.spawn_local(_cli_worker, args.hosts, args=(child_argv,),
                                       device=args.device)
        return max(codes)
    dev = resolve_device(args.device)
    ctx, joined = None, False
    if args.hosts > 1 or os.environ.get(launch_lib.ENV_NUM_PROCESSES, "1") != "1":
        joined = launch_lib.current() is None
        ctx = launch_lib.initialize(
            launch_lib.Topology.from_env(coordinator=args.coordinator), device=dev)
    # a mesh backend joins torchrun's process group, or starts one of this
    # process alone (sharding.make_mesh); the group ends with the run
    own_group = args.backend != "local" and not dist.is_initialized()
    try:
        return _main(args, dev, ctx)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
        if joined:
            launch_lib.shutdown()


def _main(args, dev, ctx) -> int:
    # every process holds the identical History; process 0 reports
    primary = ctx is None or ctx.process_id == 0
    task = make_task(args, dev)

    tracer = None
    if args.trace or args.metrics_json:
        obs.enable()
    if args.trace:
        tracer = obs.install_tracer(obs.Tracer())

    runs = []
    with obs.profiler_session(args.profile_dir, dev):
        if args.compare:
            # under --trace the runs share one timeline: events accumulate
            # across estimators and the metadata ledger sums all of them
            results = {}
            for name, kw in COMPARE:
                spec, _, hist = run_one(task, args, name, kw, ctx=ctx)
                runs.append((name, hist, _capture_metrics(args)))
                mean_mse = float(np.nanmean(hist.mse))
                if primary:
                    report(task, spec, hist, verbose=False)
                results[f"{name}({kw.get('transform', '-')})"] = (
                    mean_mse, hist.total_bytes
                )
            if primary:
                print("\nMSE at equal bytes (same k, same round keys):")
                for label, (mse, b) in sorted(results.items(),
                                              key=lambda kv: kv[1][0]):
                    print(f"  {label:28s} mean_mse={mse:.6f}  bytes={b}")
        else:
            est_kw = {"transform": args.transform}
            spec, state, hist = run_one(task, args, args.estimator, est_kw, ctx=ctx)
            runs.append((args.estimator, hist, _capture_metrics(args)))
            if primary:
                report(task, spec, hist, verbose=not args.smoke)
                if "accuracy" in task.aux:
                    print(f"  final accuracy: "
                          f"{task.aux['accuracy'](state):.4f}")

    if primary:
        _write_obs_outputs(args, tracer, runs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
