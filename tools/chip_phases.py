#!/usr/bin/env python3
"""Run some of chip_smoke.py's phases alone on the card, after its
environment and build phases (each phase's checks stay fatal):

    python3 tools/chip_phases.py train_mamba train_cli train_card_vs_cpu \\
        serve_mamba serve_moe flash_d128
    python3 tools/chip_phases.py gc_probe

``gc_probe`` times the mamba2-130m training cell ((d)) three times in one
process: fresh, after ``phase_fl`` (which leaves millions of live Python
objects), and after ``gc.collect(); gc.freeze()``, and prints the three
step medians on a line of their own. ``flash_d128`` needs ``serve_moe``
before it (its launch count).
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
    cs.phase_fl(smi)
    torch.cuda.empty_cache()
    cs.log(f"live Python objects after phase_fl: {len(gc.get_objects())}")
    out["after_fl"] = cs._train_mamba(smi)["median_ms"]
    torch.cuda.empty_cache()
    gc.collect()
    gc.freeze()
    out["after_fl_gc_frozen"] = cs._train_mamba(smi)["median_ms"]
    cs.log(f"gc_probe [{smi}] " + json.dumps(out))
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
