"""The metrics registry: counters / gauges / histograms + recording spans
(port of repro/obs/registry.py).

One process-level registry, DISABLED by default. The overhead contract:

- **disabled (the default)**: every recording call is a single attribute
  check and an immediate return; ``span(...)`` hands back one shared no-op
  context manager. No allocation, no trace events: the instrumented code
  runs the same math, so a run with recording off is bitwise equal to one
  with it on (tests/test_torch_obs.py).
- **enabled**: recording costs a dict update; spans additionally cost two
  ``perf_counter`` reads and (when a tracer is installed,
  ``repro_torch.obs.trace``) one appended trace event.

Keys are ``component/name`` strings (e.g. ``fl/client_encode.duration_us``),
optionally suffixed with sorted ``{k=v,...}`` labels: the flat namespace
every exporter (``--metrics-json``) shares.

**No recording synchronises the stream.** A value that lives on a device
is a ``torch.Tensor``, and reading it on the host would wait for the card.
The registry never reads one: ``_scalar_or_none`` drops every tensor (on
any device, so a run records the same on the CPU as on the card), the
recording call records nothing, and the ``obs/tracer_drops`` counter
(``tracer_drops()``) says how many samples were dropped. Python numbers
(ints from the byte ledger, shapes, host floats) record as they are.

**Spans are host time.** A span reads ``time.perf_counter`` around the
enclosed Python: on the card that is the time to dispatch the enclosed
work, not the time the device spends on it, since CUDA launches return
before the device finishes. Device time is the profiler session's
(``obs.profile.profiler_session``).

Counters are deterministic: same seed + same config => same counter
snapshot; durations live in histograms, which are outside that contract.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any

import torch


class _State:
    """The process-level registry state (mutable, host-side only)."""

    __slots__ = ("enabled", "counters", "gauges", "histograms", "tracer_drops")

    def __init__(self):
        self.enabled = False
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, list[float]] = {}
        self.tracer_drops = 0


_STATE = _State()


def enable() -> None:
    """Turn recording on (process-wide)."""
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


def reset() -> None:
    """Drop all recorded metrics (keeps the enabled flag)."""
    _STATE.counters = {}
    _STATE.gauges = {}
    _STATE.histograms = {}
    _STATE.tracer_drops = 0


def _scalar_or_none(v: Any) -> float | None:
    """Host float of ``v``, or None when reading it would wait for a device
    (any tensor: the no-sync contract of the module docstring) or it is not
    a number."""
    if isinstance(v, torch.Tensor):
        _STATE.tracer_drops += 1
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _key(component: str, name: str, labels: dict) -> str:
    base = f"{component}/{name}"
    if not labels:
        return base
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{base}{{{inner}}}"


def count(component: str, name: str, value: float = 1, **labels) -> None:
    """Add ``value`` to a counter (keyed by component/name + sorted labels)."""
    if not _STATE.enabled:
        return
    v = _scalar_or_none(value)
    if v is None:
        return
    k = _key(component, name, labels)
    _STATE.counters[k] = _STATE.counters.get(k, 0) + v


def gauge(component: str, name: str, value: float, **labels) -> None:
    """Set a gauge to the latest observed value."""
    if not _STATE.enabled:
        return
    v = _scalar_or_none(value)
    if v is None:
        return
    _STATE.gauges[_key(component, name, labels)] = v


def observe(component: str, name: str, value: float, **labels) -> None:
    """Append a sample to a histogram."""
    if not _STATE.enabled:
        return
    v = _scalar_or_none(value)
    if v is None:
        return
    _STATE.histograms.setdefault(_key(component, name, labels), []).append(v)


class _NullSpan:
    """The shared disabled-mode span: a no-op context manager that still
    yields a dict so call sites may annotate unconditionally."""

    __slots__ = ()

    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _clean_args(args: dict) -> dict:
    """Trace-event args: strings/bools pass through, numbers become host
    floats, tensors (and anything unreadable) are dropped."""
    out = {}
    for k, v in args.items():
        if isinstance(v, (str, bool)):
            out[k] = v
            continue
        s = _scalar_or_none(v)
        if s is not None:
            out[k] = s
    return out


@contextlib.contextmanager
def _live_span(component: str, name: str, track: str | None, args: dict):
    from . import trace as trace_lib

    clean = _clean_args(args)
    t0 = time.perf_counter()
    ts = trace_lib.now_us()
    try:
        yield clean
    finally:
        dur_us = (time.perf_counter() - t0) * 1e6
        count(component, f"{name}.calls")
        observe(component, f"{name}.duration_us", dur_us)
        tracer = trace_lib.current_tracer()
        if tracer is not None:
            tracer.emit(track or name, f"{component}/{name}", ts, dur_us,
                        _clean_args(clean))


def span(component: str, name: str, *, track: str | None = None, **args):
    """Recording span: times the enclosed block on the host clock (dispatch
    time on the card, see the module docstring), bumps ``<name>.calls``,
    records a ``<name>.duration_us`` histogram sample, and emits one trace
    event on ``track`` when a tracer is installed. Yields a mutable dict:
    entries added inside the block become trace-event args (late
    annotations)."""
    if not _STATE.enabled:
        return _NULL_SPAN
    return _live_span(component, name, track, args)


def marker(component: str, name: str, *, track: str | None = None, **args) -> None:
    """Zero-duration span: an attribution point on a trace track (e.g. the
    quantize stage, whose time is part of the client encode) plus the same
    counter bump a span makes."""
    if not _STATE.enabled:
        return
    from . import trace as trace_lib

    count(component, f"{name}.calls")
    tracer = trace_lib.current_tracer()
    if tracer is not None:
        tracer.emit(track or name, f"{component}/{name}", trace_lib.now_us(),
                    0.0, _clean_args(args))


def _summary(samples: list[float]) -> dict:
    n = len(samples)
    s = sorted(samples)
    return {
        "count": n,
        "sum": sum(s),
        "min": s[0],
        "max": s[-1],
        "mean": sum(s) / n,
        "p50": s[n // 2],
    }


def snapshot() -> dict:
    """Serializable view of everything recorded so far. ``counters`` and
    ``gauges`` are flat name->value maps; ``histograms`` are per-key summary
    stats; ``tracer_drops`` counts samples dropped for being tensors."""
    return {
        "enabled": _STATE.enabled,
        "counters": dict(sorted(_STATE.counters.items())),
        "gauges": dict(sorted(_STATE.gauges.items())),
        "histograms": {
            k: _summary(v) for k, v in sorted(_STATE.histograms.items())
        },
        "tracer_drops": _STATE.tracer_drops,
    }


def tracer_drops() -> int:
    return _STATE.tracer_drops
