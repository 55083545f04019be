"""repro_torch.obs: metrics registry, round-timeline tracing and profiling
hooks (port of repro/obs).

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
- ``profile``: ``profiler_session(logdir)``, a ``torch.profiler`` session
  (device time, kernel names) written as a Chrome trace; and the kernel
  telemetry that ``kernels.ops`` and the resolvent decodes record
  (``kernels/dispatch``, ``kernels/decode_route``, ``kernels/cg_iters``).
"""
from __future__ import annotations

from .profile import (  # noqa: F401
    profiler_session,
    record_cg_iters,
    record_compile,
    record_decode_route,
    record_dispatch,
)
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
