#!/usr/bin/env python3
"""Run some of chip_smoke.py's phases alone on the card, after its
environment and build phases (each phase's checks stay fatal):

    python3 tools/chip_phases.py train_mamba train_cli train_card_vs_cpu \\
        serve_mamba serve_moe flash_d128
    python3 tools/chip_phases.py gc_probe
    python3 tools/chip_phases.py dist
    python3 tools/chip_phases.py pipeline hier
    python3 tools/chip_phases.py placed

``gc_probe`` times the mamba2-130m training cell ((d)) three times in one
process: fresh, after ``phase_fl`` (which leaves millions of live Python
objects), and after ``gc.collect(); gc.freeze()``, and prints the three
step medians on a line of their own. ``flash_d128`` needs ``serve_moe``
before it (its launch count). ``dist`` runs ``phase_dist`` on the
estimator phases' gradient tree. ``dist_timing`` times warm estimator
rounds on the local route (sync, overlapped, 4 logical owners) and, where
the checkout has them, on the mesh routes of one NCCL rank, and counts the
kernel launches of one overlapped local round; it runs on an older
checkout too, to compare two trees in one call. ``pipeline`` runs
``phase_pipeline`` (the GPipe schedule on mamba2-130m at full width) and
``hier`` ``phase_hier`` (hierarchical FL rounds at the estimator's full
width, over one and two processes, and the CLI's ``--pods 2 --hosts 2``).
``placed`` runs ``phase_placed`` (parameters placed over the data and
model axes: musicgen-medium's DME step and gemma3-4b's serving on four gloo
ranks on the card).
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def gc_probe(smi: str) -> dict:
    out = {"fresh": cs._train_mamba(smi)["median_ms"]}
    torch.cuda.empty_cache()
    cs.phase_fl(smi, cs.fl_task())
    torch.cuda.empty_cache()
    cs.log(f"live Python objects after phase_fl: {len(gc.get_objects())}")
    out["after_fl"] = cs._train_mamba(smi)["median_ms"]
    torch.cuda.empty_cache()
    gc.collect()
    gc.freeze()
    out["after_fl_gc_frozen"] = cs._train_mamba(smi)["median_ms"]
    cs.log(f"gc_probe [{smi}] " + json.dumps(out))
    return out


def dist_timing(smi: str) -> dict:
    """Wall ms (CUDA events) of 5 warm calls, after 2, of each route on the
    estimator phases' tree and first shared key, and the cudaLaunchKernel
    calls of one overlapped local round (tiles of FL_OVERLAP_TILE)."""
    from repro_torch.dist import collectives

    tree, spec, seed = cs.gradient_tree(), cs._spec(True, "auto"), cs.SHARED_BASELINE_SEED
    overlap = {"overlap": True, "overlap_tile": cs.FL_OVERLAP_TILE}
    fns = {name: (lambda kw=kw: collectives.compressed_mean_tree(spec, seed, tree, device=cs.DEV,
                                                                 **kw))
           for name, kw in (("local", {}), ("local_overlap", overlap),
                            ("local_owners4", {"ownership": 4}))}
    if hasattr(collectives, "compressed_mean_tree_shardmap"):
        from repro_torch.dist import sharding

        mesh = sharding.make_mesh((1,), ("pod",), device=cs.DEV)
        fns["shard_map"] = lambda: collectives.compressed_mean_tree_shardmap(
            spec, seed, tree, mesh, device=cs.DEV)
        fns["shard_map_owners"] = lambda: collectives.compressed_mean_tree_shardmap(
            spec, seed, tree, mesh, device=cs.DEV, ownership=True)
        fns["shard_map_overlap"] = lambda: collectives.compressed_mean_tree_shardmap(
            spec, seed, tree, mesh, device=cs.DEV, **overlap)
        fns["gspmd"] = lambda: collectives.compressed_mean_tree(
            spec, seed, tree, collectives.dme_shardings(mesh), device=cs.DEV)
    out = {}
    for name, fn in fns.items():
        for _ in range(2):
            fn()
        out[name] = [cs._timed_round(fn)[1] for _ in range(5)]
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        fns["local_overlap"]()
        torch.cuda.synchronize()
    out["local_overlap_kernel_launches"] = sum(
        ev.count for ev in prof.key_averages() if ev.key == "cudaLaunchKernel")
    cs.log(f"dist_timing [{smi}] " + json.dumps(out))
    return out


def main(names: list) -> int:
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    smi = cs.phase_environment()
    cs.phase_build()
    state = {}
    phases = {
        "train_mamba": cs._train_mamba,
        "train_cli": cs._train_cli,
        "train_card_vs_cpu": cs._train_card_vs_cpu,
        "serve_mamba": cs.phase_serve_mamba,
        "serve_moe": lambda smi: state.setdefault("moe", cs.phase_serve_moe(smi)),
        "flash_d128": lambda smi: cs.phase_flash_timing_d128(state["moe"]["launches"],
                                                             cs.Errors()),
        "gc_probe": gc_probe,
        "dist": lambda smi: cs.phase_dist(cs.gradient_tree(), smi),
        "dist_timing": dist_timing,
        "pipeline": cs.phase_pipeline,
        "hier": lambda smi: cs.phase_hier(smi, cs.fl_task()),
        "placed": lambda smi: cs.phase_placed(smi, cs.Errors()),
    }
    for name in names:
        t0 = time.perf_counter()
        phases[name](smi)
        torch.cuda.empty_cache()
        cs.log(f"== {name} done in {time.perf_counter() - t0:.1f} s")
    cs.log(f"total {time.perf_counter() - start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
