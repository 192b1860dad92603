"""Unified telemetry: metrics registry, phase spans, JSONL event log
(copied from wtf_tpu/telemetry; the span fence is the port's own).

One namespace for everything the snapshot→execute→restore loop needs to
explain itself (the stats role the reference spreads over ServerStats_t
/ client stats / PrintRunStats, plus the phase/time accounting it never
had):

  metrics.Registry   named counters/gauges/histograms, labeled children
  spans.Spans        phase timers with explicit device fencing
  events.EventLog    append-only JSONL stream (+ NullEventLog/NULL sink)

The fourth leg — device-side per-lane counters (instructions retired,
memory faults, decode-cache misses) — lives in the machine state itself
(interp/machine.py `Machine.ctr`, accumulated in interp/step.py, folded
into a Registry by the backend once per burst).
"""

from wtf_tpu_torch.telemetry.events import (  # noqa: F401
    NULL, EventLog, NullEventLog, TapEventLog, open_event_log, read_events,
)
from wtf_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, LabeledView, Registry, StatsDict,
    get_registry, merge_snapshots,
)
from wtf_tpu_torch.telemetry.spans import Spans, TraceCollector  # noqa: F401


def resolve(backend=None, registry=None, events=None):
    """Resolve the (registry, events) pair a caller should aggregate into:
    explicit argument, else the backend's own, else a fresh Registry / the
    NULL sink.  The one sharing policy — every layer (backends, fuzz loop,
    dist nodes) defaults through here so they can't silently fragment onto
    different registries."""
    if registry is None:
        registry = getattr(backend, "registry", None) or Registry()
    if events is None:
        events = getattr(backend, "events", None) or NULL
    return registry, events
