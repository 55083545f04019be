"""Round-timeline tracer: Chrome-trace / Perfetto JSON emission (port of
repro/obs/trace.py; the file format is the JAX package's, so
``tools/trace_report.py`` reads the port's traces).

A ``Tracer`` collects *complete* duration events (``ph: "X"``) on named
tracks, one track per round phase, and serializes them in the Chrome Trace
Event Format, which Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` load directly. ``repro_torch.fl.run --trace out.json``
is the CLI entry; ``tools/trace_report.py`` is the validator.

Track layout:

    round            one span per federated round (args: round, mse,
                     wire_bytes, survivors; ``wire_bytes`` is a summary,
                     deliberately NOT the ledgered ``bytes`` key)
    client_encode    survivor encode per budget group (args carry the exact
                     per-group wire bytes off the payload ledger)
    quantize         attribution marker: the quantizer stage runs inside the
                     client encode, so it gets a zero-duration marker naming
                     the stage, not a separate duration
    payload_route    payload traffic; args carry the modelled intra-pod
                     bytes under a ``bytes_intra_pod`` key, so they never
                     enter the wire ledger sum
    owner_decode     server decode per budget group (whole or owner-sliced)
    stale_admission  async staleness-1 admission (args: late-arrival bytes)
    temporal_update  server temporal-state commit + correlation tracker

The byte-ledger invariant: summing the ``bytes`` arg over ALL events equals
``History.total_bytes`` exactly. ``bytes`` rides only on client_encode and
stale_admission events, the two places payloads cross the wire.

Events are emitted through ``repro_torch.obs.span`` / ``marker`` against the
*installed* tracer (``install_tracer``), so instrumented code never threads a
tracer argument. Every duration is host time (``obs.registry``'s docstring).

A tracer also carries a ``round`` cursor (``set_round``): every event
emitted while round t is current is tagged ``args["round"] = t``.
"""
from __future__ import annotations

import json
import time

# canonical per-round phase tracks, in display order
PHASES = (
    "round",
    "client_encode",
    "quantize",
    "payload_route",
    "owner_decode",
    "stale_admission",
    "temporal_update",
)

_ORIGIN = time.perf_counter()


def now_us() -> float:
    """Microseconds since process trace origin (monotonic, host clock)."""
    return (time.perf_counter() - _ORIGIN) * 1e6


class Tracer:
    """Collects Chrome-trace events; one instance per traced run."""

    def __init__(self):
        self.events: list[dict] = []
        self.meta: dict = {}
        self._tids: dict[str, int] = {}
        self._round: int | None = None

    # -------------------------------------------------------------- tracks

    def _tid(self, track: str) -> int:
        if track not in self._tids:
            tid = (PHASES.index(track) if track in PHASES
                   else len(PHASES) + len(self._tids))
            self._tids[track] = tid
            self.events.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": track},
            })
            self.events.append({
                "ph": "M", "name": "thread_sort_index", "pid": 1, "tid": tid,
                "args": {"sort_index": tid},
            })
        return self._tids[track]

    # ------------------------------------------------------------ emission

    def set_round(self, t: int | None) -> None:
        """Tag subsequent events with ``args["round"] = t``."""
        self._round = t

    def emit(self, track: str, name: str, ts_us: float, dur_us: float,
             args: dict | None = None) -> None:
        """One complete event (``ph: "X"``) on ``track``."""
        a = dict(args or {})
        if self._round is not None and "round" not in a:
            a["round"] = self._round
        self.events.append({
            "ph": "X", "name": name, "pid": 1, "tid": self._tid(track),
            "ts": ts_us, "dur": dur_us, "args": a,
        })

    def counter(self, name: str, ts_us: float, values: dict) -> None:
        """A Chrome counter event (``ph: "C"``), rendered as a track graph
        (e.g. per-round MSE) by Perfetto."""
        self.events.append({
            "ph": "C", "name": name, "pid": 1, "tid": 0, "ts": ts_us,
            "args": dict(values),
        })

    def set_meta(self, key: str, value) -> None:
        """Run-level metadata (config, ledger totals) carried in the trace
        file's ``metadata`` object: what tools/trace_report.py validates
        the events against."""
        self.meta[key] = value

    # --------------------------------------------------------------- output

    def to_dict(self) -> dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "metadata": dict(self.meta),
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)


_CURRENT: Tracer | None = None


def install_tracer(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-wide emission target (spans/markers from
    any instrumented layer land in it). Returns the tracer."""
    global _CURRENT
    _CURRENT = tracer
    return tracer


def uninstall_tracer() -> None:
    global _CURRENT
    _CURRENT = None


def current_tracer() -> Tracer | None:
    return _CURRENT
