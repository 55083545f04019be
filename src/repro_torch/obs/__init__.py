"""repro_torch.obs: metrics registry and round-timeline tracing (port of
repro/obs).

Everything is OFF by default and the disabled paths are one-flag-check
no-ops, so a run with recording off is bitwise equal to one with it on
(tests/test_torch_obs.py).

    from repro_torch import obs

    obs.enable()                                  # metrics on
    tracer = obs.install_tracer(obs.Tracer())     # + round timeline
    ...run rounds...
    tracer.write("trace.json")                    # Perfetto-loadable
    print(obs.snapshot()["counters"])             # flat metrics export

- ``registry``: counters/gauges/histograms keyed ``component/name``,
  recording ``span``s and zero-duration ``marker``s; no recording reads a
  tensor, so none synchronises the stream. Spans are host time.
- ``trace``: Chrome-trace/Perfetto event collection, one track per round
  phase; ``install_tracer`` makes it the process emission target.

The JAX package's ``profile`` module (the profiler session, and the
dispatch, decode-route and CG-iteration hooks inside the ops and the
decode) is ROADMAP A.8: ``profiler_session`` passes through with no
directory and raises otherwise.
"""
from __future__ import annotations

import contextlib

from .registry import (  # noqa: F401
    count,
    disable,
    enable,
    enabled,
    gauge,
    marker,
    observe,
    reset,
    snapshot,
    span,
    tracer_drops,
)
from .trace import (  # noqa: F401
    PHASES,
    Tracer,
    current_tracer,
    install_tracer,
    now_us,
    uninstall_tracer,
)


@contextlib.contextmanager
def profiler_session(logdir: str | None):
    """A pass-through when ``logdir`` is None; a device profile written to
    ``logdir`` is not ported yet (ROADMAP A.8 obs/profile.py)."""
    if logdir is not None:
        raise NotImplementedError(
            "a profiler session (--profile-dir) is not ported yet (ROADMAP A.8 obs/profile.py)")
    yield
