"""Picklable worker entry points for ``spawn_local`` (port of
repro/runtime/workers.py).

``multiprocessing``'s spawn context re-imports a worker by qualified module
name in the child, so anything spawned from tests or tools must live in an
importable module. These workers build an FL round setup from a plain-dict
spec (plain so it pickles across the spawn boundary), run it under the
process's ``RuntimeContext`` on its device, and return plain numpy results.
"""
from __future__ import annotations

import pickle
import time

import numpy as np

from ..core import codec

_STAGES = {
    "identity": codec.Identity,
    "rand_k": codec.RandK,
    "rand_k_spatial": codec.RandKSpatial,
    "rand_proj_spatial": codec.RandProjSpatial,
    "top_k": codec.TopK,
    "int8": codec.Int8Quant,
    "bf16": codec.Bf16Quant,
    "error_feedback": codec.ErrorFeedback,
    "temporal": codec.Temporal,
}


def build_pipeline(stage_specs):
    """[(stage_name, kwargs), ...] -> codec.Pipeline. The picklable
    pipeline description used in worker specs."""
    return codec.Pipeline([_STAGES[name](**dict(kw)) for name, kw in stage_specs])


def history_arrays(hist) -> dict:
    """History -> plain float64 numpy arrays (NaN-safe, pickle-exact): the
    comparable trajectory a parity check asserts bitwise across process
    counts."""
    keys = ("metric", "mse", "mse_pop", "bytes", "n_survivors", "n_sampled",
            "n_stale", "stale_bytes", "intra_pod_bytes", "dcn_bytes", "rho_hat")
    return {k: np.asarray(getattr(hist, k), dtype=np.float64) for k in keys}


def round_worker(ctx, spec: dict) -> dict:
    """Run ``fl.run_rounds`` hierarchically under ``ctx``, on ``ctx.device``.

    ``spec`` (all plain): task / task_kw, stages (for ``build_pipeline``),
    cohort kwargs, and RoundConfig kwargs (``rounds`` dict; ``hierarchy`` /
    ``pods`` ride there). Every process runs the identical global
    simulation and decodes its owned pods; the returned History is identical
    on all processes by the exchange contract.
    """
    from ..fl import Cohort, RoundConfig, get_task, run_rounds

    task = get_task(spec["task"], device=ctx.device, **dict(spec.get("task_kw", {})))
    pipe = build_pipeline(spec["stages"])
    cohort = Cohort(**dict(spec.get("cohort", {})))
    cfg = RoundConfig(runtime=ctx, **dict(spec.get("rounds", {})))
    t0 = time.perf_counter()
    _, hist = run_rounds(task, pipe, cohort, cfg, device=ctx.device)
    out = history_arrays(hist)
    out["wall_s"] = time.perf_counter() - t0
    out["process_id"] = ctx.process_id
    out["total_bytes"] = hist.total_bytes
    out["total_dcn_bytes"] = hist.total_dcn_bytes
    out["total_intra_pod_bytes"] = hist.total_intra_pod_bytes
    return out


def kv_roundtrip_worker(ctx, shape=(3, 5)) -> dict:
    """Transport self-test: every process publishes a deterministic array,
    reads every peer's, and checks bit-exact recovery. Returns the checksum
    map (also exercised single-process, where nothing is exchanged)."""
    rng = np.random.default_rng(1234 + ctx.process_id)
    mine = rng.standard_normal(shape).astype(np.float32)
    if ctx.is_distributed:
        ctx.put_bytes(f"kvtest/{ctx.process_id}", pickle.dumps(mine))
        ctx.barrier("kvtest-ready")
    sums = {}
    for p in range(ctx.n_processes):
        if p == ctx.process_id:
            arr = mine
        else:
            arr = pickle.loads(ctx.get_bytes(f"kvtest/{p}"))
            expect = np.random.default_rng(1234 + p).standard_normal(shape).astype(np.float32)
            if arr.tobytes() != expect.tobytes():
                raise AssertionError(f"peer {p}'s array came back changed")
        sums[p] = float(arr.sum())
    if ctx.is_distributed:
        ctx.barrier("kvtest-done")
    return sums
