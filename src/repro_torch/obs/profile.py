"""Profiling hooks: a ``torch.profiler`` session and kernel telemetry (port
of repro/obs/profile.py).

Two kinds of hook live here, both no-ops unless asked for:

- ``profiler_session(logdir)``: a context manager around
  ``torch.profiler.profile``, recording the host's activities always and the
  card's (CUPTI: kernels, copies, device time) when a card is in use. On exit
  it writes one Chrome-trace / Perfetto JSON file into ``logdir``
  (``trace_<pid>_<ms>.pt.trace.json``), which ``chrome://tracing``,
  https://ui.perfetto.dev and TensorBoard's profiler load. It is the
  *device*-level view; ``repro_torch.obs.trace``'s round tracer is the
  *system*-level one (phases, bytes). Wired to ``repro_torch.fl.run
  --profile-dir``. A profiler that cannot start warns once and passes
  through: profiling is observability, never a dependency.
- kernel telemetry, recorded only while ``registry.enabled()``:
  ``record_dispatch`` (the route ``kernels.ops`` took for an op: ``kernel``,
  the hand-written CUDA kernel, or ``plain``, its plain PyTorch version;
  the JAX package's ``pallas`` / ``pallas_interpret`` / ``oracle``),
  ``record_decode_route`` (fused / gram / direct per Rand-Proj-Spatial
  decode, resolvent per SparseProj decode) and ``record_cg_iters`` (the
  iterations a resolvent CG solve ran, one sample a solve). Each is counted
  per call: the port runs eagerly, where the JAX package records a jitted
  program's decisions once per compilation.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings

import torch

from . import registry


def _activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profiler_session(logdir: str | None, device=None):
    """Profile the block with ``torch.profiler``, writing a Chrome trace
    into ``logdir``; the card's activities are recorded when ``device`` is
    a CUDA device (or, with no device, when CUDA is available). A None
    logdir, or a profiler that cannot start, is a pass-through."""
    if logdir is None:
        yield
        return
    prof = torch.profiler.profile(activities=_activities(device))
    try:
        prof.__enter__()
    except Exception as e:  # profiler backends vary by install
        warnings.warn(f"torch.profiler unavailable ({e}); continuing unprofiled")
        yield
        return
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.pt.trace.json"))


def record_dispatch(op: str, use_kernel: bool) -> None:
    """Count one route decision of ``kernels.ops`` for ``op``."""
    if not registry.enabled():
        return
    registry.count("kernels", "dispatch", op=op, route="kernel" if use_kernel else "plain")


def record_decode_route(estimator: str, method: str) -> None:
    """Count the decode path a spatial estimator resolved to."""
    if not registry.enabled():
        return
    registry.count("kernels", "decode_route", estimator=estimator, method=method)


def record_cg_iters(iters) -> None:
    """Histogram sample of a resolvent CG solve's iteration count, a host
    integer (a tensor is dropped, as every tensor the registry is given)."""
    if not registry.enabled():
        return
    registry.observe("kernels", "cg_iters", iters)


def record_compile(component: str, name: str, compile_s: float, steady_s: float) -> None:
    """Gauge pair of a timed callable: first-call vs steady-state seconds."""
    if not registry.enabled():
        return
    registry.gauge(component, f"{name}.compile_us", compile_s * 1e6)
    registry.gauge(component, f"{name}.steady_us", steady_s * 1e6)
